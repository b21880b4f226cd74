"""The port's plan/execute ``Codec`` against ``repro.core.Codec`` (reference
backend) on the smoke llama3_2_1b serving tree: the same buckets with the
same members, one kernel call per bucket, and streams equal to
compressing each tensor alone.  All comparisons are exact.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.codec_api import Codec as JaxCodec
from repro.models import build_model as jax_build_model
from repro.runtime import streaming as jax_streaming
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.codec_api import (Codec, current_codec,
                                        set_default_codec, use_codec)
from repro_torch.kernels import ops
from repro_torch.runtime import streaming

MIN_BYTES = 1024


@pytest.fixture(scope="module")
def trees():
    jparams = jax_build_model(jax_smoke_config("llama3_2_1b")).init(
        jax.random.key(0))
    params = params_from_jax(jax.device_get(jparams), "cpu",
                             cfg=get_smoke_config("llama3_2_1b"))
    return jparams, params


def _job_arrays(jparams, params, mode):
    """The arrays the serving policy encodes, from both packages, in the
    reference's flatten order."""
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jarrs, tarrs = [], []
    tleaves = dict(streaming.tree_leaves(params))
    for path, leaf in jflat:
        name = jax_streaming._pstr(path)
        jjob = jax_streaming.serving_job(name, leaf, mode, MIN_BYTES)
        tjob = streaming.serving_job(name, tleaves[name], mode, MIN_BYTES)
        assert (jjob is None) == (tjob is None), name
        if jjob is not None:
            jarrs.append(jjob["arr"])
            tarrs.append(tjob["arr"])
    return jarrs, tarrs


def _members(plan):
    """{bucket key without backend / padding: sorted member slots}."""
    return {(b.fmt_name, tuple(b.params_key), b.block_elems):
            sorted(m["slot"] for m in members)
            for b, members in zip(plan.buckets, plan._groups)}


@pytest.mark.parametrize("mode,shards", [("fused", 1), ("stream", 2)])
def test_plans_match_reference_and_launch_once_per_bucket(trees, mode,
                                                          shards,
                                                          monkeypatch):
    jparams, params = trees
    jarrs, tarrs = _job_arrays(jparams, params, mode)
    jcodec, codec = JaxCodec(), Codec()
    jplan = jcodec.plan_encode(jarrs, stacked=True, shards=shards)
    plan = codec.plan_encode(tarrs, stacked=True, shards=shards)
    assert len(plan.buckets) == len(jplan.buckets) >= 1
    assert plan.n_fallback == jplan.n_fallback
    assert _members(plan) == {(k[1], k[2][:3] if len(k[2]) > 3 else k[2],
                               k[3]): v
                              for k, v in ((b.key, sorted(
                                  m["slot"] for m in ms))
                                  for b, ms in zip(jplan.buckets,
                                                   jplan._groups))}
    for b, jb in zip(sorted(plan.buckets, key=lambda b: b.key),
                     sorted(jplan.buckets, key=lambda b: b.key[1:4])):
        assert (b.nblocks, b.n_tensors) == (jb.nblocks, jb.n_tensors)
        assert b.block_bucket == b.nblocks     # the port pads no bucket

    calls = {"encode": 0, "decode": 0}
    real_enc, real_dec = ops.encode_blocks, ops.decode_blocks

    def count(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ops, "encode_blocks", count("encode", real_enc))
    monkeypatch.setattr(ops, "decode_blocks", count("decode", real_dec))
    cts = codec.execute(plan)
    assert calls["encode"] == len(plan.buckets)
    assert codec.encode_cache_stats()["dispatches"] == len(plan.buckets)
    jcts = jcodec.execute(jplan)
    for arr, ct, jct in zip(tarrs, cts, jcts):
        assert (ct is None) == (jct is None)
        if ct is None:
            continue
        # the same streams as compressing this tensor alone, and as the
        # reference's batched encode
        [alone] = Codec().compress_stacked_many([arr], shards=shards)
        for name in ct.streams._fields:
            got = getattr(ct.streams, name)
            assert torch.equal(got, getattr(alone.streams, name)), name
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(jct.streams, name)))
        assert ct.nbytes_wire() == jct.nbytes_wire()

    dplan = codec.plan_decode(cts)
    jdplan = jcodec.plan_decode(jcts)
    assert len(dplan.buckets) == len(jdplan.buckets)
    assert dplan.n_passthrough == jdplan.n_passthrough
    # the reference's pytree flatten drops the None holes: its slots count
    # only the live entries
    live = [i for i, jct in enumerate(jcts) if jct is not None]
    assert sorted(sorted(m["slot"] for m in ms) for ms in dplan._groups) == \
        sorted(sorted(live[m["slot"]] for m in ms) for ms in jdplan._groups)
    decs = codec.execute(dplan)
    assert calls["decode"] == len(dplan.buckets)
    assert codec.decode_cache_stats()["dispatches"] == len(dplan.buckets)
    for arr, dec in zip(tarrs, decs):
        if dec is not None:
            assert torch.equal(dec.view(torch.int16), arr.view(torch.int16))


def test_use_codec_makes_a_codec_ambient_for_the_handles(trees):
    _, params = trees
    codec = Codec()
    outside = current_codec()
    with use_codec(codec):
        assert current_codec() is codec
        tree = streaming.assign_weight_modes(params, mode="stream",
                                             min_bytes=MIN_BYTES, shards=2)
        handle = next(leaf for _, leaf in streaming.tree_leaves(tree)
                      if hasattr(leaf, "tp_axis") and not leaf.flat)
        handle.layer(0).materialize()
    assert current_codec() is outside
    assert codec.encode_cache_stats()["dispatches"] >= 1
    assert codec.decode_cache_stats()["dispatches"] == 1
    # the process default is what current_codec falls back to
    other = Codec()
    prev = set_default_codec(other)
    try:
        assert current_codec() is other
        with use_codec(codec):
            assert current_codec() is codec
    finally:
        set_default_codec(prev)
    assert current_codec() is prev


def test_never_worse_escape_fetches_high_len_once(trees, monkeypatch):
    """The escape reads every stack's high_len in one device-to-host
    copy, and fills each tensor's wire-size cache from it."""
    _, params = trees
    leaves = [t for _, t in streaming.tree_leaves(params) if t.ndim == 3]
    codec = Codec()
    plan = codec.plan_encode(leaves, stacked=True)
    fetched = []
    real_cat = torch.cat

    def cat(parts, *a, **k):
        out = real_cat(parts, *a, **k)
        fetched.append(len(parts))
        return out

    monkeypatch.setattr(torch, "cat", cat)
    cts = codec.execute(plan)
    monkeypatch.undo()
    live = [ct for ct in cts if ct is not None]
    assert live and all(ct._wire_bytes is not None for ct in live)
    # the last cat of execute gathers the high_len of every encoded stack,
    # before the escape drops the ones that would not beat raw bytes
    assert fetched[-1] == sum(b.n_tensors for b in plan.buckets) >= len(live)


@pytest.mark.parametrize("mode", ["fused", "stream"])
def test_materialize_full_many_decodes_once_per_bucket(trees, mode):
    """Every handle of a served tree back to its dense leaf, bit for bit,
    in one decode launch per bucket of the plan over their streams."""
    from repro_torch.runtime.weights import (DenseWeight,
                                             materialize_full_many)
    _, params = trees
    codec = Codec()
    with use_codec(codec):
        tree = streaming.assign_weight_modes(params, mode=mode,
                                             min_bytes=MIN_BYTES, shards=2)
    leaves = dict(streaming.tree_leaves(params))
    pairs = [(name, h) for name, h in streaming.tree_leaves(tree)
             if hasattr(h, "materialize")]
    assert any(not isinstance(h, DenseWeight) for _, h in pairs)
    handles = [h for _, h in pairs]
    plan = codec.plan_decode([None if isinstance(h, DenseWeight) else h.ct
                              for h in handles])
    codec.reset_decode_cache_stats()
    dense = materialize_full_many(handles, codec)
    assert codec.decode_cache_stats()["dispatches"] == len(plan.buckets)
    for (name, _), w in zip(pairs, dense):
        assert torch.equal(w.view(torch.int16),
                           leaves[name].view(torch.int16)), name
