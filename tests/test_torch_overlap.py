"""The port's decode-prefetch pipeline (``repro_torch.runtime.overlap``)
against tests/test_overlap.py, on the smoke configs with the reference's
JAX weights carried over by ``convert.params_from_jax``.

The pipeline only moves the schedule: logits with overlap on and off are
bitwise equal in every weight mode (on the port's own seeded weights), a
layer's prefetch is one batched
decode of ``buckets_per_layer`` launches (the reference schedule's count
on the same tree) whose bits equal ``StreamedWeight.materialize``, and
against the JAX package with overlap on the logits stay within the port's
stated tolerance (Port convention 4) with equal greedy tokens.  On the CPU
the schedule runs in order on one stream; the side stream and its events
are exercised by ``chip_smoke.py``'s phase overlap on the card.

``test_overlap_scan_unrolled_parity`` has no counterpart: the reference's
two drivers differ only in how XLA compiles them, and the port, whose
layer loop is a Python loop, has one driver (``pipeline_scan`` is an alias
of ``pipeline_unrolled``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.runtime.overlap import build_schedule as jax_build_schedule
from repro.runtime.streaming import assign_weight_modes as jax_assign
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.codec import flatten_blocks
from repro_torch.core.codec_api import Codec, adjacent, use_codec
from repro_torch.core.wire import to_wire
from repro_torch.models import build_model
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.overlap import (build_schedule, decode_layer,
                                         overlap_enabled, pipeline_scan,
                                         pipeline_unrolled)
from repro_torch.runtime.streaming import assign_weight_modes, stream_stats
from repro_torch.runtime.weights import StreamedWeight, resolve, tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's torch work on one thread, as the suite runs it
    beside other workers on every core: the smoke models' small ops spend
    more time synchronising a pool of threads than computing.  The bits
    compared here come from runs under the same setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DENSE_ARCHS = ("llama3_2_1b", "qwen3_32b", "stablelm_3b", "minitron_4b")
MOE_ARCH = "phi3_5_moe_42b_a6_6b"
MODES = ("dense", "stream", "fused")
MIN_BYTES, SHARDS = 1024, 2
STEPS = 2
# Port convention 4, as tests/test_torch_serve.py states it: one bf16 ulp
# (2**-8 relative) of the larger of 1 and the reference logits' magnitude,
# two for the MoE configs (their residual reaches |x| in [2, 4))
LOGIT_ATOL = 2.0 ** -8


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The port's own seeded weights: on against off is the port's alone
    (the reference's weights serve in the tests that compare packages)."""
    cfg = get_smoke_config(arch)
    params = build_model(cfg).init(seed=0, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    return arch, cfg, params, prompts


@pytest.fixture(scope="module", params=DENSE_ARCHS + (MOE_ARCH,))
def arch_setup(request):
    return _setup(request.param)


def _serve(model, tree, prompts, max_len=16):
    logits, cache = model.prefill_fn(
        tree, {"tokens": torch.from_numpy(prompts)}, max_len)
    outs, toks = [logits], [torch.argmax(logits, -1)]
    for _ in range(STEPS):
        logits, cache = model.decode_fn(tree, cache, toks[-1])
        outs.append(logits)
        toks.append(torch.argmax(logits, -1))
    return torch.stack(outs), torch.stack(toks)


def _serve_jax(model, tree, prompts, max_len=16):
    logits, cache = model.prefill_fn(
        tree, {"tokens": jnp.asarray(prompts, jnp.int32)}, max_len)
    outs = [np.asarray(logits)]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    for _ in range(STEPS):
        logits, cache = model.decode_fn(tree, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        outs.append(np.asarray(logits))
        toks.append(np.asarray(tok))
    return np.stack(outs), np.stack(toks)


@pytest.mark.parametrize("mode", MODES)
def test_overlap_logits_bitwise_on_off_and_stats(arch_setup, mode):
    """Every smoke config in every mode: logits with overlap on and off
    bitwise equal, and the pipeline runs exactly where ``stream_stats``
    counts streamed leaves in the layer loop (its equality with the
    reference's, ``overlap_eligible_tensors`` too, is held on the same
    trees in tests/test_torch_serve.py)."""
    arch, cfg, params, prompts = arch_setup
    tree = assign_weight_modes(params, mode=mode, min_bytes=MIN_BYTES,
                               shards=SHARDS)
    runs = {ov: _serve(build_model(dataclasses.replace(cfg, overlap=ov)),
                       tree, prompts) for ov in ("off", "on")}
    assert torch.equal(runs["off"][0].view(torch.int32),
                       runs["on"][0].view(torch.int32)), (arch, mode)
    assert torch.equal(runs["off"][1], runs["on"][1])
    got = stream_stats(tree)
    n_periods = cfg.n_layers // len(tree["period"])
    assert overlap_enabled("on", tree["period"], n_periods) == \
        (got["overlap_eligible_tensors"] > 0)
    assert got["streamed_tensors"] == (got["flat_stream_tensors"]
                                       + got["overlap_eligible_tensors"])
    assert mode != "dense" or not got["overlap_eligible_tensors"]


@pytest.mark.parametrize("arch", ("llama3_2_1b",))
def test_overlap_on_matches_reference(arch):
    """Stream mode with overlap on in both packages: logits within the
    port's tolerance of the reference's and greedy tokens equal."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), overlap="on")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = dataclasses.replace(get_smoke_config(arch), overlap="on")
    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    jtree = jax_assign(jparams, mode="stream", min_bytes=MIN_BYTES,
                       shards=SHARDS)
    tree = assign_weight_modes(params, mode="stream", min_bytes=MIN_BYTES,
                               shards=SHARDS)
    want, want_toks = _serve_jax(jmodel, jtree, prompts)
    got, toks = _serve(build_model(cfg), tree, prompts)
    ulps = 2.0 if arch == MOE_ARCH else 1.0
    atol = ulps * LOGIT_ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    np.testing.assert_array_equal(toks.numpy(), want_toks)


@pytest.mark.parametrize("arch", ("llama3_2_1b", MOE_ARCH))
def test_decode_layer_bitwise_and_launches_per_layer(arch):
    """The prefetch of one layer equals ``materialize`` of each slot's
    slice bitwise and costs ``buckets_per_layer`` decode launches, the
    reference schedule's count (and slots) on the same JAX weights."""
    jcfg = jax_smoke_config(arch)
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    cfg = get_smoke_config(arch)
    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    codec = Codec()
    with use_codec(codec):
        tree = assign_weight_modes(params, mode="stream",
                                   min_bytes=MIN_BYTES, shards=SHARDS,
                                   codec=codec)
        handles = [leaf for _, leaf in tree_leaves(tree["period"])
                   if isinstance(leaf, StreamedWeight)]
        records = [to_wire(h.ct, stacked=True) for h in handles]
        sched = build_schedule(tree["period"], cfg.n_layers, codec=codec)
        # the bucket layout moved the streams, not their bytes, and a
        # layer's bucket streams are now one view (no copy a prefetch)
        assert [to_wire(h.ct, stacked=True) for h in handles] == records
        buckets: dict = {}
        for h in handles:
            buckets.setdefault((h.ct.fmt_name, h.ct.params.astuple()[1:4],
                                h.ct.block_elems), []).append(h)
        for members in buckets.values():
            for layer in (0, cfg.n_layers - 1):
                flats = [flatten_blocks(h.layer(layer).ct.streams)
                         for h in members]
                assert len(members) == 1 or adjacent(
                    [f.low for f in flats]) and adjacent(
                    [f.mask for f in flats])
        want = jax_build_schedule(
            jax_assign(jparams, mode="stream", min_bytes=MIN_BYTES,
                       shards=SHARDS)["period"], jcfg.n_layers)
        assert sched.slots == want.slots and sched.slots
        assert sched.buckets_per_layer == want.buckets_per_layer
        assert 1 <= sched.buckets_per_layer <= len(sched.slots)
        for layer in range(cfg.n_layers):
            codec.reset_decode_cache_stats()
            decs = decode_layer(sched, layer, codec)
            assert codec.decode_cache_stats()["dispatches"] == \
                sched.buckets_per_layer
            for slot, got in zip(sched.slots, decs):
                ref = sched.leaves[slot].layer(layer).materialize(codec)
                assert got.dtype == ref.dtype and got.shape == ref.shape
                assert torch.equal(got.reshape(-1).view(torch.uint8),
                                   ref.reshape(-1).view(torch.uint8))


def test_overlap_enabled_policy():
    cfg = get_smoke_config("llama3_2_1b")
    params = build_model(cfg).init(seed=0, device="cpu")
    streamed = assign_weight_modes(params, mode="stream",
                                   min_bytes=MIN_BYTES,
                                   shards=SHARDS)["period"]
    dense = assign_weight_modes(params, mode="dense",
                                min_bytes=MIN_BYTES)["period"]
    n_periods = cfg.n_layers // len(streamed)
    assert n_periods >= 2
    assert overlap_enabled("on", streamed, n_periods)
    assert overlap_enabled("auto", streamed, n_periods)
    assert not overlap_enabled("off", streamed, n_periods)
    # nothing to prefetch: auto and on run the serial loop
    assert not overlap_enabled("auto", dense, n_periods)
    assert not overlap_enabled("on", dense, n_periods)
    # a stack of one period: no period ahead to prefetch
    assert not overlap_enabled("on", streamed, 1)
    with pytest.raises(ValueError, match="overlap mode"):
        overlap_enabled("sideways", streamed, n_periods)
    with pytest.raises(TypeError, match="not a StreamedWeight"):
        resolve(dense, prefetched={0: torch.zeros(1)})


def test_pipeline_xs_extra_and_ys():
    """The driver's contract (the reference's pipeline_scan test): the
    carry threads through every layer in order, ``xs_extra`` is sliced per
    layer, ``ys`` holds one entry a layer; ``pipeline_scan`` is the same
    driver."""
    cfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), n_layers=3)
    params = build_model(cfg).init(seed=0, device="cpu")
    tree = assign_weight_modes(params, mode="stream", min_bytes=MIN_BYTES,
                               shards=SHARDS)
    sched = build_schedule(tree["period"], cfg.n_layers)
    xs = torch.arange(cfg.n_layers, dtype=torch.float32)
    seen = []

    def apply_fn(carry, sliced, extra, i):
        seen.append(sorted(sliced[0]))
        return carry + extra, carry

    carry, ys = pipeline_unrolled(sched, apply_fn, torch.tensor(0.0),
                                  xs_extra=xs)
    assert float(carry) == float(xs.sum())
    assert [float(y) for y in ys] == [0.0, 0.0, 1.0]
    assert len(seen) == cfg.n_layers
    assert pipeline_scan is pipeline_unrolled


@pytest.mark.parametrize("arch,mode", [("llama3_2_1b", "stream"),
                                       (MOE_ARCH, "stream"),
                                       (MOE_ARCH, "fused")])
def test_engine_step_with_overlap_equals_without(arch, mode):
    """The engine's decode step (``lm.decode_step`` on the slot ring) with
    overlap on gives each request the bits it gets with overlap off, under
    a staggered join that runs buckets 1, 2 and 4."""
    _, cfg, params, _ = _setup(arch)
    tree = assign_weight_modes(params, mode=mode, min_bytes=MIN_BYTES,
                               shards=SHARDS)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 6))
    ecfg = EngineConfig(max_slots=4, queue_depth=8, max_prompt_len=6,
                        max_new_tokens=4, collect_logits=True)
    logits = {}
    for ov in ("off", "on"):
        model = build_model(dataclasses.replace(cfg, overlap=ov))
        # a clock that never advances: the overload governor sees no slow
        # step on a loaded host and admits every request
        engine = Engine(model, tree, ecfg, device="cpu", clock=lambda: 0.0)
        reqs = [engine.submit(prompts[0], 4)]
        engine.step()
        reqs.append(engine.submit(prompts[1], 4))
        engine.step()
        reqs += [engine.submit(p, 4) for p in prompts[2:]]
        engine.run_until_idle()
        assert engine.stats()["engine"]["compiled_buckets"] == [1, 2, 4]
        logits[ov] = [torch.stack(r.logits) for r in reqs]
    for a, b in zip(logits["off"], logits["on"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_encode_launch_lays_buckets_out_by_layer():
    """``Codec.execute`` lays an encode launch out layer by layer, so the
    stacks a prefetch decodes together are adjacent rows of each layer as
    ``assign_weight_modes`` leaves them: the schedule copies nothing."""
    _, cfg, params, _ = _setup(MOE_ARCH)
    for mode in ("stream", "fused"):
        tree = assign_weight_modes(params, mode=mode, min_bytes=MIN_BYTES,
                                   shards=SHARDS)
        handles = [leaf for _, leaf in tree_leaves(tree["period"])
                   if isinstance(leaf, StreamedWeight)]
        buckets: dict = {}
        for h in handles:
            buckets.setdefault((h.ct.fmt_name, h.ct.params.astuple()[1:4],
                                h.ct.block_elems), []).append(h)
        assert max(len(m) for m in buckets.values()) > 1
        for members in buckets.values():
            for layer in range(cfg.n_layers):
                flats = [flatten_blocks(h.layer(layer).ct.streams)
                         for h in members]
                assert len(members) == 1 or all(
                    adjacent([getattr(f, field) for f in flats])
                    for field in ("mask", "low", "high_len", "raw"))
        ptrs = [h.ct.streams.low.data_ptr() for h in handles]
        build_schedule(tree["period"], cfg.n_layers)
        assert [h.ct.streams.low.data_ptr() for h in handles] == ptrs
