"""The port's pure-Python serving pieces against the JAX package's: the same
scripted sequences drive ``AdmissionQueue``, ``OverloadGovernor``,
``RetryPolicy`` and ``FaultInjector`` of both packages, and every decision
(accepted or rejected and why, shed and taken requests, trips, retries,
sleeps, firings, corrupted bytes) and every ``stats()`` must be equal.
"""
import shutil

import numpy as np
import pytest
import torch

from repro.runtime import admission as ref_admission
from repro.runtime import faults as ref_faults
from repro.runtime import retry as ref_retry
from repro_torch.checkpoint.ckpt import CheckpointError, CheckpointManager
from repro_torch.runtime import admission, faults, retry

def _request(mod, i, priority, ttft=None):
    return mod.Request(prompt=np.zeros(1, np.int32), max_new_tokens=1,
                       priority=priority, ttft_deadline_s=ttft,
                       name=f"a{i}")


def _queue_script(mod):
    """A bounded queue through offers under and out of overload, TTFT
    sheds, priority sheds, takes, a close and a drain; the log of every
    decision and the queue's state after each."""
    rng = np.random.default_rng(5)
    q = mod.AdmissionQueue(depth=5)
    log = []
    reqs = []
    for i in range(40):
        op = rng.integers(0, 6)
        if op <= 2:
            req = _request(mod, i, int(rng.integers(-1, 3)),
                           ttft=float(rng.integers(0, 40)))
            reqs.append(req)
            overloaded = bool(rng.integers(0, 4) == 0)
            log.append(("offer", req.name,
                        q.offer(req, overloaded=overloaded)))
        elif op == 3:
            log.append(("expired", [r.name for r in
                                    q.shed_expired(float(i))]))
        elif op == 4:
            log.append(("lowest", [r.name for r in q.shed_lowest_priority(
                int(rng.integers(1, 3)), reason="overload")]))
        else:
            r = q.take()
            log.append(("take", None if r is None else r.name))
        log.append((len(q), q.peek_viable(), q.max_depth_seen))
    q.close()
    log.append(("closed", q.offer(_request(mod, 99, 5))))
    q2 = mod.AdmissionQueue(depth=8)
    for i in range(3):
        q2.offer(_request(mod, 100 + i, i))
    log.append(("drain", [r.name for r in q2.drain_all("drain")]))
    log.append([(r.name, r.state, r.detail) for r in reqs])
    return log, q.counters, q2.counters


def test_admission_queue_decisions_equal_reference():
    port = _queue_script(admission)
    assert port == _queue_script(ref_admission)
    assert port[1]["rejected_queue_full"] > 0
    assert port[1]["shed_deadline"] > 0 and port[1]["shed_overload"] > 0


def test_admission_queue_sheds_lowest_priority_newest_first():
    q = admission.AdmissionQueue(depth=8)
    reqs = [_request(admission, i, p) for i, p in enumerate([1, 0, 0, 2])]
    for r in reqs:
        assert q.offer(r)[0]
    shed = q.shed_lowest_priority(2, reason="overload")
    # ties on priority 0 break newest first: a2 before a1
    assert [r.name for r in shed] == ["a2", "a1"]
    assert len(q) == 2 and q.counters["shed_overload"] == 2


def test_admission_queue_reject_reasons_have_precedence():
    q = admission.AdmissionQueue(depth=1)
    assert q.offer(_request(admission, 0, 0))[0]
    assert q.offer(_request(admission, 1, 0)) == (False, "queue_full")
    assert q.offer(_request(admission, 2, 0), overloaded=True) == \
        (False, "overloaded")
    q.close()
    assert q.offer(_request(admission, 3, 0), overloaded=True) == \
        (False, "draining")


def test_request_lifecycle_times_equal_reference():
    for mod in (admission, ref_admission):
        r = _request(mod, 0, 0)
        assert r.ttft_s() is None and r.tpot_s() is None
        r.submit_s, r.first_token_s, r.finish_s = 1.0, 1.5, 3.5
        r.tokens = [1, 2, 3, 4, 5]
        assert (r.ttft_s(), r.tpot_s(), r.key) == (0.5, 0.5, "a0")
        r.state = "evicted"
        assert r.finished
    assert admission.TERMINAL_STATES == ref_admission.TERMINAL_STATES


def _governor_script(mod):
    rng = np.random.default_rng(9)
    gov = mod.OverloadGovernor(watchdog_s=0.5, overload_factor=3.0,
                               warmup_steps=4, recovery_steps=3)
    log = []
    for i in range(120):
        dt = float(rng.uniform(0.01, 0.03))
        if i in (2, 40, 41, 77):
            dt = 0.9                     # stuck (one during warm-up)
        elif i % 17 == 0:
            dt *= 5.0                    # slow
        log.append((gov.observe_step(dt), gov.state, gov.overloaded,
                    gov.stats()))
    return log


def test_governor_decisions_equal_reference():
    port = _governor_script(admission)
    assert port == _governor_script(ref_admission)
    st = port[-1][-1]
    assert st["stuck_steps"] == 4 and st["slow_steps"] > 0
    assert st["recoveries"] > 0


def test_governor_watchdog_catches_stuck_step_during_warmup():
    gov = admission.OverloadGovernor(watchdog_s=5.0, warmup_steps=3)
    assert gov.observe_step(6.0)
    assert gov.overloaded and gov.baseline_s is None


class _Clock:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _retry_script(mod):
    clock = _Clock()
    policy = mod.RetryPolicy(seed=3, base_delay_s=0.01, max_delay_s=0.05,
                             sleep=clock.sleep, clock=clock)
    log = []
    for fails, budget in ((0, None), (2, None), (3, None), (9, None),
                          (2, 0.015), (5, 0.2), (1, 0.0)):
        left = [fails]

        def fn():
            clock.t += 0.001
            if left[0]:
                left[0] -= 1
                raise OSError("transient")
            return "ok"

        try:
            out = policy.call(fn, describe=f"step:{fails}",
                              max_elapsed_s=budget)
        except OSError as e:
            out = f"raised {e}"
        log.append((out, policy.stats()))
    with pytest.raises(ValueError):
        policy.call(lambda: (_ for _ in ()).throw(ValueError("bad")))
    log.append(("value", policy.stats(), list(clock.sleeps)))
    policy.reset_stats()
    log.append(policy.stats())
    bounded = mod.RetryPolicy(max_elapsed_s=0.004, base_delay_s=0.002,
                              seed=1, sleep=clock.sleep, clock=clock)

    def always():
        raise OSError("down")

    with pytest.raises(OSError):
        bounded.call(always)
    log.append(bounded.stats())
    return log


def test_retry_policy_decisions_equal_reference():
    port = _retry_script(retry)
    assert port == _retry_script(ref_retry)
    assert any(s["gave_up"] for _, s in port[:7])


def _fault_script(mod, root):
    inj = mod.FaultInjector([
        {"kind": "read", "match": "pack_1", "times": 2},
        {"kind": "write", "match": "", "times": 1},
        {"kind": "decode", "match": "wq", "times": -1},
        {"kind": "step", "match": "victim", "times": 3},
        {"kind": "corrupt", "match": "pack_0", "times": 2},
        {"kind": "corrupt", "match": "pack_2", "mode": "truncate",
         "times": 1}], seed=11)
    log = []
    targets = [("read", f"{root}/pack_1.bin"), ("read", "x/pack_0.bin"),
               ("write", "w.bin"), ("decode", "period/0/attn/wq"),
               ("decode", "period/0/mlp/w_up"), ("step", "victim"),
               ("step", "ok")]
    for kind, target in targets * 4:
        try:
            getattr(inj, f"check_{kind}")(target)
            log.append((kind, target, "ok"))
        except mod.InjectedFault as e:
            log.append((kind, target, str(e)))
    data = bytes(range(64))
    for path in ("a/pack_0.bin", "a/pack_0.bin", "a/pack_0.bin",
                 "b/pack_2.bin", "b/pack_2.bin"):
        log.append(inj.corrupt(path, data))
    log.append(inj.stats())
    with mod.inject(mod.FaultSpec(kind="step", match="p1", times=1)) as act:
        assert mod.active() is act
        with pytest.raises(mod.InjectedFault):
            mod.check_step("p1")
        mod.check_step("p1")
        mod.check_decode("anything")
        log.append(act.stats())
    assert mod.active() is None
    with pytest.raises(ValueError, match="unknown fault kind"):
        mod.FaultSpec(kind="meteor")
    return log


def test_fault_injector_decisions_equal_reference(tmp_path):
    port = _fault_script(faults, tmp_path)
    assert port == _fault_script(ref_faults, tmp_path)
    fired = [s["fired"] for s in port[-2]]
    assert fired == [2, 1, 4, 3, 2, 1]


def test_fault_env_schedule_equal_reference(monkeypatch):
    monkeypatch.setenv("ENEC_FAULTS", '{"seed": 2, "specs": '
                       '[{"kind": "step", "match": "r", "times": 1}]}')
    for mod in (faults, ref_faults):
        inj = mod.active()
        assert inj.seed == 2 and inj.specs[0].kind == "step"
        with pytest.raises(mod.InjectedFault):
            mod.check_step("r")
        mod.check_step("r")
    for bad in ("{not json", '"a string"', '[{"kind": "meteor"}]'):
        monkeypatch.setenv("ENEC_FAULTS", bad)
        for mod in (faults, ref_faults):
            with pytest.raises(mod.FaultConfigError, match="ENEC_FAULTS"):
                mod.active()


def test_read_helpers_and_flip_pack_byte_equal_reference(tmp_path):
    """The read funnel applies read and corrupt faults as the reference's
    does, and ``flip_pack_byte`` damages the same byte of a checkpoint
    the port wrote, which the strict restore then rejects."""
    f = tmp_path / "pack_0.bin"
    f.write_bytes(bytes(range(200)))
    for mod in (faults, ref_faults):
        with mod.inject(mod.FaultSpec(kind="corrupt", match="pack_0",
                                      offset=7), seed=0):
            got = (mod.read_range(f, 5, 10), mod.read_file(f)[:10])
        assert got == (bytes([5, 6, 7, 8, 9, 10, 11, 12 ^ 8, 13, 14]),
                       bytes([0, 1, 2, 3, 4, 5, 6, 7 ^ 8, 8, 9]))
        with mod.inject(mod.FaultSpec(kind="read", match="pack_0",
                                      times=1)):
            with pytest.raises(mod.InjectedFault):
                mod.read_file(f)
            assert mod.read_range(f, 0, 3) == bytes([0, 1, 2])
    tree = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 256)).astype(np.float32)).bfloat16()}
    roots = [tmp_path / "port", tmp_path / "ref"]
    CheckpointManager(roots[0], device="cpu").save(1, tree, blocking=True)
    shutil.copytree(roots[0], roots[1])
    flips = [mod.flip_pack_byte(root, "w", byte=3)
             for mod, root in zip((faults, ref_faults), roots)]
    assert flips[0][0] == flips[1][0] == "w"
    assert flips[0][2] == flips[1][2]
    assert open(flips[0][1], "rb").read() == open(flips[1][1], "rb").read()
    like = {"w": torch.empty((64, 256), dtype=torch.bfloat16,
                             device="meta")}
    with pytest.raises(CheckpointError, match="w"):
        CheckpointManager(roots[0], device="cpu").load(like)
