"""The port's continuous-batching engine (``repro_torch.runtime.engine``)
against the scenarios of tests/test_engine.py, on the reference's smoke
llama3_2_1b with its seeded JAX weights carried over by
``convert.params_from_jax``.

The engine's logits are held bitwise to the port's own batch-1 one-shot
path (prefill, then ``decode_fn``) in every weight mode and under a
staggered join, and its greedy tokens to the JAX package's one-shot path;
admission, deadlines, step faults, drain and the governor are held to the
reference's outcomes.  The static-buffer step (``lm.decode_step``) is held
bitwise to ``decode_fn``, and the capture / replay launch accounting of
``runtime/captured.py`` is checked with a stub graph (the CUDA graph
itself is exercised by ``chip_smoke.py``'s engine phase on the card).
"""
import contextlib
import copy
import gc
import importlib
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.runtime.streaming import assign_weight_modes as jax_assign
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import build, enec_decode
from repro_torch.models import build_model
from repro_torch.runtime import captured
from repro_torch.runtime import faults as rt_faults
from repro_torch.runtime.admission import OverloadGovernor
from repro_torch.runtime.engine import (Engine, EngineConfig, EngineError,
                                        ServerHealth, _next_bucket)
from repro_torch.runtime.faults import FaultSpec
from repro_torch.runtime.retry import RetryPolicy
from repro_torch.runtime.streaming import assign_weight_modes

PROMPT_LEN = 6
N_NEW = 4
# the wrapper modules (``repro_torch.kernels`` re-exports functions of the
# same names)
MATMUL = importlib.import_module("repro_torch.kernels.decompress_matmul")
SCAN = importlib.import_module("repro_torch.kernels.idd_scan")


class FakeClock:
    """Deterministic time source for deadline tests (no real sleeping)."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config("llama3_2_1b")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_smoke_config("llama3_2_1b")
    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, PROMPT_LEN)).astype(np.int32)
    return (jmodel, jparams), build_model(cfg), params, prompts


def _one_shot(model, params, prompt, n_new, max_len):
    """The port's one-shot loop: batch-1 prefill, then argmax decode."""
    logits, cache = model.prefill_fn(
        params, {"tokens": torch.from_numpy(prompt[None, :]).long()},
        max_len)
    tok = torch.argmax(logits, -1)
    toks, outs = [int(tok[0])], [logits[0]]
    for _ in range(n_new - 1):
        logits, cache = model.decode_fn(params, cache, tok)
        tok = torch.argmax(logits, -1)
        toks.append(int(tok[0]))
        outs.append(logits[0])
    return toks, outs


def _ecfg(**kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_prompt_len", PROMPT_LEN)
    kw.setdefault("max_new_tokens", N_NEW)
    kw.setdefault("collect_logits", True)
    return EngineConfig(**kw)


def _engine(model, params, config, **kw):
    return Engine(model, params, config, device="cpu", **kw)


def _assert_bit_identical(got_logits, ref_logits, msg=""):
    assert len(got_logits) == len(ref_logits), msg
    for i, (g, r) in enumerate(zip(got_logits, ref_logits)):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32)), \
            f"{msg} token {i}"


# ---------------------------------------------------------------------------
# bit parity with the one-shot path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "stream", "fused"])
def test_engine_logits_bit_identical_to_one_shot(setup, mode):
    _, model, params, prompts = setup
    tree = assign_weight_modes(params, mode=mode, min_bytes=1024, shards=2)
    engine = _engine(model, tree, _ecfg())
    reqs = [engine.submit(prompts[i], N_NEW, name=f"r{i}") for i in range(2)]
    engine.run_until_idle()
    for i, req in enumerate(reqs):
        assert req.state == "done", (req.state, req.detail)
        ref_toks, ref_logits = _one_shot(model, tree, prompts[i], N_NEW,
                                         engine.config.max_len)
        assert req.tokens == ref_toks, mode
        _assert_bit_identical(req.logits, ref_logits, f"{mode} req{i}")


def test_staggered_join_keeps_bit_parity(setup):
    """A request that joins while another decodes (buckets 1, then 2, then
    4) produces the one-shot logits, and so does every request it
    joined."""
    _, model, params, prompts = setup
    engine = _engine(model, params, _ecfg(max_slots=4))
    first = engine.submit(prompts[0], N_NEW, name="first")
    engine.step()            # first is admitted and emits token 1
    engine.step()            # first decodes alone (bucket 1)
    late = engine.submit(prompts[1], N_NEW, name="late")
    engine.step()            # bucket 2
    later = [engine.submit(prompts[i], N_NEW, name=f"later{i}")
             for i in (2, 3)]
    engine.run_until_idle()
    for req, prompt in zip([first, late] + later, prompts):
        assert req.state == "done"
        ref_toks, ref_logits = _one_shot(model, params, prompt, N_NEW,
                                         engine.config.max_len)
        assert req.tokens == ref_toks
        _assert_bit_identical(req.logits, ref_logits, req.name)
    st = engine.stats()["engine"]
    assert st["prefills"] == 4 and st["done"] == 4
    assert st["compiled_buckets"] == [1, 2, 4]
    assert engine.step_buckets[:3] == [1, 1, 2]


def test_greedy_tokens_equal_reference_one_shot(setup):
    """The engine's greedy tokens equal the JAX package's one-shot
    ``prefill_fn`` / ``decode_fn`` on the same weights (logits across the
    packages agree only within the serve tests' tolerance)."""
    (jmodel, jparams), model, params, prompts = setup
    jtree = jax_assign(jparams, mode="dense", min_bytes=1024, shards=2)
    engine = _engine(model, params, _ecfg(max_slots=4, queue_depth=8))
    reqs = [engine.submit(prompts[i], N_NEW, name=f"g{i}") for i in range(4)]
    engine.run_until_idle()
    for i, req in enumerate(reqs):
        logits, cache = jmodel.prefill_fn(
            jtree, {"tokens": jnp.asarray(prompts[i][None, :])},
            engine.config.max_len)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want = [int(np.asarray(tok)[0])]
        for _ in range(N_NEW - 1):
            logits, cache = jmodel.decode_fn(jtree, cache, tok)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            want.append(int(np.asarray(tok)[0]))
        assert req.state == "done"
        assert req.tokens == want, i


def test_static_buffer_step_bitwise_equals_decode_fn(setup):
    """``lm.decode_step`` on a 4-slot ring (a view of its first 2 slots,
    then all 4) gives ``decode_fn``'s logits, tokens and K/V bitwise, and
    advances tokens and lengths in place."""
    _, model, params, prompts = setup
    tree = assign_weight_modes(params, mode="fused", min_bytes=1024,
                               shards=2)
    max_len = PROMPT_LEN + N_NEW + 1
    for bucket in (2, 4):
        batch = torch.from_numpy(prompts[:bucket]).long()
        logits, cache = model.prefill_fn(tree, {"tokens": batch}, max_len)
        state = model.init_step_state(4, max_len, device="cpu")
        for ring, part in zip(state["entries"], cache["entries"]):
            for k in ("k", "v"):
                ring[k][:, :bucket].copy_(part[k])
        tok = torch.argmax(logits, -1)
        state["tokens"][:bucket] = tok
        state["lengths"][:bucket] = cache["lengths"]
        for _ in range(N_NEW):
            logits, cache = model.decode_fn(tree, cache, tok)
            tok = torch.argmax(logits, -1)
            model.decode_step(tree, state, bucket)
            assert torch.equal(state["logits"][:bucket].view(torch.int32),
                               logits.view(torch.int32))
            assert torch.equal(state["tokens"][:bucket], tok)
            assert torch.equal(state["lengths"][:bucket], cache["lengths"])
        for ring, part in zip(state["entries"], cache["entries"]):
            for k in ("k", "v"):
                assert torch.equal(ring[k][:, :bucket].view(torch.int16),
                                   part[k].view(torch.int16))


def test_bucket_compiles_are_bounded(setup):
    """4 concurrent requests over a 4-slot ring use at most log2(4)+1 = 3
    step variants, and only the ones occupied."""
    _, model, params, prompts = setup
    engine = _engine(model, params, _ecfg(max_slots=4, queue_depth=8))
    for i in range(4):
        engine.submit(prompts[i], N_NEW, name=f"b{i}")
    engine.run_until_idle()
    buckets = engine.stats()["engine"]["compiled_buckets"]
    assert set(buckets) <= {1, 2, 4} and len(buckets) <= 3
    assert [_next_bucket(n, 4) for n in range(1, 5)] == [1, 2, 4, 4]
    assert _next_bucket(3, 3) == 3


# ---------------------------------------------------------------------------
# admission: bounded queue, deterministic reject-with-reason
# ---------------------------------------------------------------------------

def test_queue_full_rejection_is_deterministic(setup):
    _, model, params, prompts = setup
    for _ in range(2):   # the same outcome on a repeat run
        engine = _engine(model, params, _ecfg(max_slots=1, queue_depth=2))
        reqs = [engine.submit(prompts[i % 4], 1, name=f"q{i}")
                for i in range(4)]
        assert [r.state for r in reqs] == ["queued", "queued",
                                           "rejected", "rejected"]
        assert [r.detail for r in reqs[2:]] == ["queue_full", "queue_full"]
        st = engine.stats()["queue"]
        assert st["rejected_queue_full"] == 2
        assert st["max_depth_seen"] == 2 <= engine.queue.depth
        engine.run_until_idle()
        assert [r.state for r in reqs[:2]] == ["done", "done"]


def test_invalid_request_raises_not_rejects(setup):
    _, model, params, prompts = setup
    engine = _engine(model, params, _ecfg())
    with pytest.raises(EngineError, match="prompt length"):
        engine.submit(np.zeros((PROMPT_LEN + 5,), np.int32))
    with pytest.raises(EngineError, match="max_new_tokens"):
        engine.submit(prompts[0], N_NEW + 1)


# ---------------------------------------------------------------------------
# deadlines: shed before prefill, evict at step granularity, honest counts
# ---------------------------------------------------------------------------

def test_expired_queued_request_shed_before_prefill(setup):
    _, model, params, prompts = setup
    clock = FakeClock()
    engine = _engine(model, params, _ecfg(), clock=clock,
                     sleep=lambda s: None)
    req = engine.submit(prompts[0], N_NEW, ttft_deadline_s=1.0, name="late")
    clock.advance(2.0)       # the TTFT deadline passes while queued
    engine.step()
    assert req.state == "shed" and req.detail == "deadline"
    st = engine.stats()["engine"]
    assert st["prefills"] == 0 and st["shed"] == 1


def test_in_flight_deadline_evicts_and_reclaims_slot(setup):
    _, model, params, prompts = setup
    clock = FakeClock()
    engine = _engine(model, params, _ecfg(max_slots=2, queue_depth=8),
                     clock=clock, sleep=lambda s: None)
    keeper = engine.submit(prompts[0], N_NEW, deadline_s=1000.0,
                           name="keeper")
    victim = engine.submit(prompts[1], N_NEW, deadline_s=5.0, name="victim")
    engine.step()            # both admitted, first decode
    victim_slot = victim.slot
    assert victim_slot is not None
    clock.advance(10.0)      # the victim's total deadline passes mid-flight
    engine.step()
    assert victim.state == "evicted" and victim.detail == "deadline"
    assert victim.slot is None
    assert keeper.state in ("running", "done")
    # the reclaimed slot is reused by the next admission
    succ = engine.submit(prompts[2], N_NEW, deadline_s=1000.0, name="succ")
    engine.step()
    assert succ.slot == victim_slot
    engine.run_until_idle()
    assert keeper.state == "done" and succ.state == "done"
    assert engine.stats()["engine"]["evicted_deadline"] == 1
    # neither the keeper nor the slot's next owner was perturbed
    for req, prompt in ((keeper, prompts[0]), (succ, prompts[2])):
        ref_toks, ref_logits = _one_shot(model, params, prompt, N_NEW,
                                         engine.config.max_len)
        assert req.tokens == ref_toks
        _assert_bit_identical(req.logits, ref_logits, req.name)


def test_late_completion_is_timed_out_not_done(setup):
    """A request that finishes past its total deadline is counted
    timed_out, never done."""
    _, model, params, prompts = setup
    clock = FakeClock()
    engine = _engine(model, params, _ecfg(), clock=clock,
                     sleep=lambda s: None)
    req = engine.submit(prompts[0], 1, deadline_s=5.0, name="tardy")
    orig = engine._run_prefill

    def slow_prefill(r, slot):   # the deadline passes inside the prefill
        clock.advance(10.0)
        orig(r, slot)

    engine._run_prefill = slow_prefill
    engine.run_until_idle()
    assert req.state == "timed_out"
    st = engine.stats()["engine"]
    assert st["timed_out"] == 1 and st["done"] == 0


# ---------------------------------------------------------------------------
# step faults: transient absorbed, permanent evicts only the poisoned
# ---------------------------------------------------------------------------

def _fault_retry():
    return RetryPolicy(base_delay_s=0.0001, max_delay_s=0.001,
                       sleep=lambda s: None)


def test_transient_step_fault_absorbed_by_retry(setup):
    _, model, params, prompts = setup
    engine = _engine(model, params, _ecfg(), retry=_fault_retry())
    with rt_faults.inject(FaultSpec(kind="step", match="flaky", times=2)):
        req = engine.submit(prompts[0], N_NEW, name="flaky")
        engine.run_until_idle()
    assert req.state == "done"
    assert req.retries == 2
    assert engine.stats()["engine"]["fault_retries"] == 2
    assert engine.health.state == "ready"       # absorbed, not degraded
    ref_toks, _ = _one_shot(model, params, prompts[0], N_NEW,
                            engine.config.max_len)
    assert req.tokens == ref_toks


def test_permanent_step_fault_evicts_only_poisoned(setup):
    """A permanent step fault on one request evicts exactly it; the
    survivors' tokens and logits are bitwise those of a fault-free run;
    health degrades, never fails."""
    _, model, params, prompts = setup
    ref_engine = _engine(model, params, _ecfg(max_slots=4, queue_depth=8))
    ref = [ref_engine.submit(prompts[i], N_NEW, name=f"p{i}")
           for i in range(3)]
    ref_engine.run_until_idle()
    assert all(r.state == "done" for r in ref)

    engine = _engine(model, params, _ecfg(max_slots=4, queue_depth=8),
                     retry=_fault_retry())
    with rt_faults.inject(FaultSpec(kind="step", match="p1", times=-1)):
        reqs = [engine.submit(prompts[i], N_NEW, name=f"p{i}")
                for i in range(3)]
        engine.run_until_idle()
    assert reqs[1].state == "evicted" and reqs[1].detail == "fault"
    for i in (0, 2):
        assert reqs[i].state == "done", (i, reqs[i].state, reqs[i].detail)
        assert reqs[i].tokens == ref[i].tokens
        _assert_bit_identical(reqs[i].logits, ref[i].logits, f"survivor {i}")
    assert engine.health.state == "degraded"
    assert "p1" in engine.health.detail
    assert engine.stats()["engine"]["evicted_fault"] == 1


def test_mid_flight_step_fault_evicts_after_admission(setup):
    """A fault that starts firing after the request is decoding evicts it
    mid-flight (some tokens out) while the rest of the batch finishes
    untouched."""
    _, model, params, prompts = setup
    engine = _engine(model, params, _ecfg(max_slots=4, queue_depth=8),
                     retry=_fault_retry())
    survivor = engine.submit(prompts[0], N_NEW, name="ok")
    victim = engine.submit(prompts[1], N_NEW, name="victim")
    engine.step()            # both admitted cleanly, first tokens out
    assert victim.tokens, "the victim should have emitted before the fault"
    with rt_faults.inject(FaultSpec(kind="step", match="victim", times=-1)):
        engine.run_until_idle()
    assert victim.state == "evicted" and victim.detail == "fault"
    assert 1 <= len(victim.tokens) < N_NEW
    assert survivor.state == "done"
    ref_toks, ref_logits = _one_shot(model, params, prompts[0], N_NEW,
                                     engine.config.max_len)
    assert survivor.tokens == ref_toks
    _assert_bit_identical(survivor.logits, ref_logits, "survivor")
    assert engine.health.state == "degraded"


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------

def test_shutdown_drains_in_flight_and_refuses_new(setup):
    _, model, params, prompts = setup
    engine = _engine(model, params, _ecfg(max_slots=1, queue_depth=8))
    running = engine.submit(prompts[0], N_NEW, name="running")
    queued = engine.submit(prompts[1], N_NEW, name="queued")
    engine.step()            # running admitted; queued waits (1 slot)
    assert running.state == "running" and queued.state == "queued"
    engine.shutdown()
    assert running.state == "done"                 # in-flight finished
    assert len(running.tokens) == N_NEW
    assert queued.state == "shed" and queued.detail == "drain"
    late = engine.submit(prompts[2], N_NEW, name="too-late")
    assert late.state == "rejected" and late.detail == "draining"
    assert engine.health.state == "stopped"
    assert not engine.health.ready()


def test_shutdown_deadline_aborts_stragglers(setup):
    _, model, params, prompts = setup
    clock = FakeClock()
    engine = _engine(model, params, _ecfg(max_slots=1), clock=clock,
                     sleep=lambda s: None)
    req = engine.submit(prompts[0], N_NEW, name="straggler")
    engine.step()
    assert req.state == "running"
    orig_step = engine.step

    def step_advancing():    # the drain budget runs out at the first check
        clock.advance(100.0)
        return orig_step()

    engine.step = step_advancing
    engine.shutdown(deadline_s=50.0)
    assert req.state == "evicted" and req.detail == "abort"
    assert engine.health.state == "stopped"


# ---------------------------------------------------------------------------
# overload governor: watchdog trips shed queued work, admission degrades
# ---------------------------------------------------------------------------

def test_governor_learns_baseline_and_trips_on_slow():
    gov = OverloadGovernor(watchdog_s=5.0, overload_factor=4.0,
                           warmup_steps=3, recovery_steps=2)
    for _ in range(3):
        assert not gov.observe_step(0.1)
    assert gov.state == "nominal" and abs(gov.baseline_s - 0.1) < 1e-9
    assert gov.observe_step(1.0)            # 1.0 > 4 x 0.1: slow
    assert gov.overloaded
    baseline = gov.baseline_s
    assert gov.observe_step(10.0)           # stuck (absolute watchdog)
    assert gov.baseline_s == baseline       # violations never move the EMA
    assert not gov.observe_step(0.1)        # healthy 1/2
    assert gov.overloaded
    assert not gov.observe_step(0.1)        # healthy 2/2: recovered
    assert gov.state == "nominal"
    st = gov.stats()
    assert st["slow_steps"] == 1 and st["stuck_steps"] == 1
    assert st["trips"] == 2 and st["recoveries"] == 1


def test_engine_overload_sheds_queued_and_degrades_admission(setup):
    """watchdog_s=0 makes every decode step a violation: each sheds the
    lowest-priority queued request, and while overloaded the front door
    rejects priority<=0 work but admits priority>0."""
    _, model, params, prompts = setup
    engine = _engine(model, params,
                     _ecfg(max_slots=1, queue_depth=8, watchdog_s=0.0))
    running = engine.submit(prompts[0], N_NEW, name="running")
    low = engine.submit(prompts[1], N_NEW, priority=0, name="low")
    high = engine.submit(prompts[2], N_NEW, priority=1, name="high")
    engine.step()            # the decode step trips the watchdog
    assert engine.governor.overloaded
    assert low.state == "shed" and low.detail == "overload"
    assert high.state == "queued"
    r0 = engine.submit(prompts[3], N_NEW, priority=0, name="walk-in")
    r1 = engine.submit(prompts[3], N_NEW, priority=1, name="vip")
    assert r0.state == "rejected" and r0.detail == "overloaded"
    assert r1.state == "queued"
    engine.run_until_idle()
    assert running.state == "done" and len(running.tokens) == N_NEW
    assert {high.state, r1.state} == {"shed"}
    assert engine.stats()["queue"]["rejected_overloaded"] == 1
    assert engine.stats()["engine"]["shed"] >= 3


def test_server_health_transitions_and_reset():
    h = ServerHealth()
    assert h.state == "initializing" and not h.ready()
    h.transition("ready")
    assert h.ready()
    h.transition("degraded", "one request evicted")
    assert h.ready() and h.detail == "one request evicted"
    h.transition("draining")
    assert not h.ready()
    with pytest.raises(ValueError, match="unknown health state"):
        h.transition("on-fire")
    h.reset()
    assert h.state == "initializing" and h.detail == ""


def test_engine_defaults_to_cuda(setup, monkeypatch):
    _, model, params, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(model, params, _ecfg())


# ---------------------------------------------------------------------------
# capture: launch accounting over a stub graph; host state refused inside
# ---------------------------------------------------------------------------

class StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def launch_counts():
    """The process's launch counters, set back after the test: other test
    files check them."""
    before = build.counts()
    yield before
    build.restore(before)


def test_capture_replay_launch_accounting(launch_counts):
    """What a capture counts is taken back out (a capture launches
    nothing) and added on every replay; a failed capture raises with the
    counters set back."""
    counters = {"enec_decode": enec_decode.LAUNCHES,
                "decompress_matmul": MATMUL.FUSED_LAUNCHES,
                "dense_tile_matmul": MATMUL.DENSE_LAUNCHES}

    def step():             # what a fused llama step's wrappers count
        counters["enec_decode"].n += 1
        counters["decompress_matmul"].n += 7
        counters["dense_tile_matmul"].n += 1

    before = launch_counts
    graph = StubGraph()
    replay = captured.record(graph, contextlib.nullcontext(), step)
    assert build.counts() == before
    assert {k: n for k, n in replay.launches.items() if n} == {
        "enec_decode": 1, "decompress_matmul": 7, "dense_tile_matmul": 1}
    for i in range(1, 4):
        replay.replay()
        assert graph.replays == i
        got = build.counts()
        assert got["decompress_matmul"] == before["decompress_matmul"] + 7 * i
        assert got["enec_decode"] == before["enec_decode"] + i
        assert got["idd_scan"] == before["idd_scan"]

    def broken():
        step()
        raise RuntimeError("capture failed")

    now = build.counts()
    with pytest.raises(RuntimeError, match="capture failed"):
        captured.record(StubGraph(), contextlib.nullcontext(), broken)
    assert build.counts() == now


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def test_dropped_engine_frees_its_tree_without_the_cycle_collector(setup):
    """An engine and its captured step form no reference cycle: once the
    last reference to an engine goes, the engine, its step buffers and the
    weights tree only it holds are freed at once, with the cycle collector
    off (on the card a cycle kept a dropped engine's tree and graph pool
    until the collector ran)."""
    _, model, params, prompts = setup
    own = copy.deepcopy(params)
    leaves = [weakref.ref(t) for t in _tensors(own)]
    assert leaves
    engine = _engine(model, own, _ecfg())
    del own
    engine.submit(prompts[0], N_NEW)
    engine.run_until_idle()
    refs = [weakref.ref(engine), weakref.ref(engine.captured),
            weakref.ref(engine._state["tokens"])]
    gc.collect()
    gc.disable()
    try:
        del engine
        assert all(r() is None for r in refs)
        assert all(r() is None for r in leaves)
    finally:
        gc.enable()


def test_captured_step_runs_eagerly_on_cpu():
    """On the CPU the step runs eagerly after its inputs are loaded, and
    the buckets it ran are listed; no graph, no events."""
    calls = []
    step = captured.CapturedStep(lambda b: calls.append(("step", b)), "cpu",
                                 max_slots=4)
    assert step.max_graphs == 3
    for b in (1, 4, 1):
        assert step.run(b, lambda: calls.append(("load",))) is None
    assert calls == [("load",), ("step", 1), ("load",), ("step", 4),
                     ("load",), ("step", 1)]
    assert step.buckets == [1, 4]
    assert captured.CapturedStep(None, "cpu", 5).max_graphs == 4


def test_kernels_refuse_host_state_inside_a_capture(monkeypatch):
    """Kernel 3 refuses a capture (its look-back epoch is a host argument)
    and kernel 2's arrival counters are not made inside one; outside a
    capture both go on as before."""
    monkeypatch.setattr(build, "capturing", lambda: True)
    with pytest.raises(RuntimeError, match="kernel 3.*capture"):
        SCAN.idd_scan_cuda(torch.zeros((1, 128), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="arrival counters.*capture"):
        MATMUL._outputs(4, 256, 256, torch.device("cpu"), 12345)
    assert (torch.device("cpu"), 12345) not in MATMUL._COUNTERS
    monkeypatch.setattr(build, "capturing", lambda: False)
    with pytest.raises(ValueError, match="CUDA"):
        SCAN.idd_scan_cuda(torch.zeros((1, 128), dtype=torch.int32))
    out, ws, ctr = MATMUL._outputs(4, 256, 256,
                                              torch.device("cpu"), 12345)
    assert ctr and tuple(out.shape) == (4, 256)
    MATMUL._COUNTERS.pop((torch.device("cpu"), 12345))


# ---------------------------------------------------------------------------
# the MoE family through the engine, with and without an expert store
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_setup():
    jcfg = jax_smoke_config("phi3_5_moe_42b_a6_6b")
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    cfg = get_smoke_config("phi3_5_moe_42b_a6_6b")
    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, PROMPT_LEN)).astype(np.int32)
    return build_model(cfg), params, prompts


@pytest.mark.parametrize("mode,budget", [
    ("dense", None), ("stream", None), ("fused", None),
    ("fused", 0), ("stream", 40_000), ("dense", "unbounded")])
def test_moe_engine_bitwise_alone_and_in_a_bucket(moe_setup, mode, budget):
    """The smoke phi3_5_moe through the engine: each request's logits
    bitwise equal to it served alone by the one-shot loop on the dense
    stacks, under a staggered join (buckets 1, 2, 4), in every mode and
    with an expert store at budgets 0, eviction-forcing and unbounded; a
    store's steps run eagerly and its counters reach ``stats()``."""
    from repro_torch.runtime.experts import install_expert_store
    model, params, prompts = moe_setup
    dense = assign_weight_modes(params, mode=mode, min_bytes=1024, shards=2)
    store = None
    tree = params
    if budget is not None:
        tree, store = install_expert_store(
            params, budget_bytes=None if budget == "unbounded" else budget,
            device="cpu", min_bytes=1024)
    tree = assign_weight_modes(tree, mode=mode, min_bytes=1024, shards=2)
    # the bits are under test, not the governor: an eager store step's
    # time varies with its misses, so the overload thresholds are set out
    # of reach
    engine = _engine(model, tree, _ecfg(max_slots=4, watchdog_s=1e9,
                                        overload_factor=1e9),
                     expert_store=store)
    first = engine.submit(prompts[0], N_NEW, name="first")
    engine.step()
    engine.step()
    late = engine.submit(prompts[1], N_NEW, name="late")
    engine.step()
    later = [engine.submit(prompts[i], N_NEW, name=f"later{i}")
             for i in (2, 3)]
    engine.run_until_idle()
    for req, prompt in zip([first, late] + later, prompts):
        assert req.state == "done"
        ref_toks, ref_logits = _one_shot(model, dense, prompt, N_NEW,
                                         engine.config.max_len)
        assert req.tokens == ref_toks
        _assert_bit_identical(req.logits, ref_logits, f"{mode} {req.name}")
    st = engine.stats()
    assert st["engine"]["compiled_buckets"] == [1, 2, 4]
    assert len(engine.step_decode_s) == st["engine"]["steps"]
    if store is None:
        assert "experts" not in st and not engine.captured.eager
        return
    assert engine.captured.eager and not any(engine.step_captured)
    assert st["experts"]["misses"] > 0
    assert (st["experts"]["evictions"] > 0) == (budget != "unbounded")
    assert all(s >= 0.0 for s in engine.step_decode_s)


def test_store_fetch_refuses_a_capture(moe_setup, monkeypatch):
    """A store fetch brings routed ids to the host mid-step: inside a CUDA
    graph capture it raises, before touching the store."""
    from repro_torch.runtime.experts import install_expert_store
    from repro_torch.models import moe
    model, params, _ = moe_setup
    tree, store = install_expert_store(params, device="cpu")
    p = {k: v.layer(0) if hasattr(v, "layer") else v[0]
         for k, v in tree["period"][0]["moe"].items()}
    x = torch.zeros((1, 1, model.cfg.d_model), dtype=torch.bfloat16)
    monkeypatch.setattr(build, "capturing", lambda: True)
    with pytest.raises(RuntimeError, match="expert store's fetch.*capture"):
        moe.moe_block(p, x, model.cfg.experts_per_token)
    with pytest.raises(RuntimeError, match="expert store's fetch.*capture"):
        store.fetch_step(store.names(), 0, [0])
    assert store.stats()["misses"] == 0
    monkeypatch.setattr(build, "capturing", lambda: False)
    out, _ = moe.moe_block(p, x, model.cfg.experts_per_token)
    assert store.stats()["misses"] == 3 * model.cfg.experts_per_token
    assert tuple(out.shape) == (1, 1, model.cfg.d_model)
