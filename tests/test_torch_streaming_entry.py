"""The port's stream-everything entry points (``runtime/streaming.py``:
``streaming_encode_plan``, ``compress_params_for_streaming``,
``decompress_sliced``, ``materialize_weight_tree``; ``runtime/weights.py:
materialize_full``) against the JAX package's on the same weights (JAX
init through ``convert.params_from_jax``, or seeded numpy stacks): the
same plan (buckets, members, predicted wire bytes), every streamed leaf's
wire record byte-identical, ``stream_stats`` equal, a mismatched plan
refused, served logits bitwise the dense tree's and greedy tokens the
reference's, whole-tree materialisation bitwise in one decode launch per
bucket.  The scenarios of the reference's ``tests/test_streaming.py``,
``test_serving_modes.py::test_resolve_materializes_storage_handles_only``,
``test_codec_api.py::test_streaming_policy_executes_inspected_plan`` and
``test_decode_pipeline.py::test_materialize_weight_tree_batched_and_bit_
exact``.  Every comparison is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import wire as jax_wire
from repro.core.codec_api import Codec as JaxCodec
from repro.models import build_model as jax_build_model
from repro.runtime import streaming as jax_streaming
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import wire
from repro_torch.core.codec_api import Codec, use_codec
from repro_torch.models import build_model
from repro_torch.runtime import streaming
from repro_torch.runtime.weights import (StreamedWeight, is_handle,
                                         materialize_full,
                                         materialize_full_many, resolve)


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


MIN_BYTES, SHARDS = 1024, 2
# the reference's tests/test_streaming.py configs (its scan_layers only
# chooses how JAX traces the layer loop: the port runs every layer
# eagerly), and llama's tied head
ARCHS = ("qwen3_32b", "phi3_5_moe_42b_a6_6b", "llama3_2_1b")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jmodel = jax_build_model(jax_smoke_config(arch))
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_smoke_config(arch)
    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    return arch, jmodel, jparams, build_model(cfg), params, prompts


def _members(plan):
    """Each bucket's key (the reference's without its backend and block
    padding), block and tensor counts, and member slots."""
    return sorted(((b.fmt_name, tuple(b.params_key)[:3], b.block_elems,
                    b.nblocks, b.n_tensors), sorted(m["slot"] for m in ms))
                  for b, ms in zip(plan.buckets, plan._groups))


def test_plan_and_records_match_reference(setup):
    arch, _, jparams, _, params, _ = setup
    jcodec, codec = JaxCodec(), Codec()
    jplan = jax_streaming.streaming_encode_plan(
        jparams, min_bytes=MIN_BYTES, shards=SHARDS, codec=jcodec)
    plan = streaming.streaming_encode_plan(
        params, min_bytes=MIN_BYTES, shards=SHARDS, codec=codec)
    assert (plan.n_inputs, plan.n_fallback, plan.stacked, plan.shards) == \
        (jplan.n_inputs, jplan.n_fallback, jplan.stacked, jplan.shards)
    assert len(plan.buckets) == len(jplan.buckets) >= 1
    assert plan.predicted_wire_bytes == jplan.predicted_wire_bytes
    # the same members in each bucket: the walk's order is the reference's
    assert _members(plan) == _members(jplan)

    tree = streaming.compress_params_for_streaming(
        params, min_bytes=MIN_BYTES, shards=SHARDS, codec=codec, plan=plan)
    assert codec.encode_cache_stats()["dispatches"] == len(plan.buckets)
    jtree = jax_streaming.compress_params_for_streaming(
        jparams, min_bytes=MIN_BYTES, shards=SHARDS, codec=jcodec,
        plan=jplan)
    stats, want = streaming.stream_stats(tree), jax_streaming.stream_stats(
        jtree)
    assert stats.pop("hbm_ratio") == pytest.approx(want.pop("hbm_ratio"),
                                                   rel=1e-12)
    assert stats == want
    assert stats["streamed_tensors"] >= 3
    assert stats["device_bytes"] <= stats["raw_bytes"]
    jleaves = {jax_streaming._pstr(p): leaf for p, leaf in
               jax.tree_util.tree_flatten_with_path(
                   jtree, is_leaf=jax_streaming.is_handle)[0]}
    n = 0
    for name, leaf in streaming.tree_leaves(tree):
        jleaf = jleaves[name]
        assert isinstance(leaf, StreamedWeight) == isinstance(
            jleaf, jax_streaming.StreamedWeight), name
        if not isinstance(leaf, StreamedWeight):
            continue
        n += 1
        assert leaf.execution == jleaf.execution == "materialize"
        assert (leaf.tp_axis, leaf.layer_shape, leaf.flat) == \
            (jleaf.tp_axis, tuple(jleaf.layer_shape), jleaf.flat), name
        assert wire.to_wire(leaf.ct, stacked=True) == \
            jax_wire.to_wire(jleaf.ct, stacked=True), name
    assert n == stats["streamed_tensors"]


def _serve(model, tree, prompts, steps=4):
    logits, cache = model.prefill_fn(
        tree, {"tokens": torch.from_numpy(prompts)}, prompts.shape[1] + 8)
    outs = [logits]
    tok = torch.argmax(logits, -1)
    toks = [tok]
    for _ in range(steps):
        logits, cache = model.decode_fn(tree, cache, tok)
        tok = torch.argmax(logits, -1)
        outs.append(logits)
        toks.append(tok)
    return torch.stack(outs), torch.stack(toks)


def _serve_jax(model, tree, prompts, steps=4):
    logits, cache = model.prefill_fn(
        tree, {"tokens": jnp.asarray(prompts, jnp.int32)},
        prompts.shape[1] + 8)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    for _ in range(steps):
        logits, cache = model.decode_fn(tree, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    return np.stack(toks)


def test_streamed_serve_bitwise_dense_and_tokens_match_reference(setup):
    """Materialize-mode handles on every eligible leaf (the flat embed,
    llama's tied head through it, the MoE expert stacks) resolve before
    their layer runs: logits bitwise the dense tree's."""
    arch, jmodel, jparams, model, params, prompts = setup
    tree = streaming.compress_params_for_streaming(
        params, min_bytes=MIN_BYTES, shards=SHARDS, codec=Codec())
    assert any(isinstance(h, StreamedWeight) and h.flat
               for _, h in streaming.tree_leaves(tree))
    want_logits, want_toks = _serve(model, params, prompts)
    got_logits, got_toks = _serve(model, tree, prompts)
    assert torch.equal(_bits(got_logits), _bits(want_logits))
    assert torch.equal(got_toks, want_toks)
    np.testing.assert_array_equal(got_toks.numpy(),
                                  _serve_jax(jmodel, jparams, prompts))


def test_materialize_weight_tree_bitwise_one_launch_a_bucket(setup):
    _, _, _, _, params, _ = setup
    codec = Codec()
    tree = streaming.compress_params_for_streaming(
        params, min_bytes=MIN_BYTES, shards=SHARDS, codec=codec)
    handles = [h for _, h in streaming.tree_leaves(tree) if is_handle(h)]
    dplan = codec.plan_decode([h.ct for h in handles])
    codec.reset_decode_cache_stats()
    dense = streaming.materialize_weight_tree(tree, codec)
    assert codec.decode_cache_stats()["dispatches"] == len(dplan.buckets)
    got, want = (dict(streaming.tree_leaves(t)) for t in (dense, params))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype
        assert torch.equal(_bits(got[name]), _bits(w)), name
    # each handle alone, one launch each, gives the same bits
    for h, w in zip(handles, materialize_full_many(handles, codec)):
        codec.reset_decode_cache_stats()
        assert torch.equal(_bits(materialize_full(h, codec)), _bits(w))
        assert codec.decode_cache_stats()["dispatches"] == 1


def test_decompress_sliced_is_resolve(setup):
    """A layer slice's storage handles all resolve to dense tensors; the
    reference's alias gives the same bits; matmul-capable handles pass."""
    _, _, _, _, params, _ = setup
    codec = Codec()
    with use_codec(codec):
        tree = streaming.compress_params_for_streaming(
            params, min_bytes=MIN_BYTES, shards=SHARDS)
        sliced = streaming.tree_map_with_path(
            lambda _, a: a.layer(0) if is_handle(a) else a[0],
            tree["period"])
        resolved = resolve(sliced)
        alias = streaming.decompress_sliced(sliced)
        fused = streaming.assign_weight_modes(params, mode="fused",
                                              min_bytes=MIN_BYTES)
        kept = resolve(streaming.tree_map_with_path(
            lambda _, a: a.layer(0) if is_handle(a) else a[0],
            fused["period"]))
    assert not any(is_handle(leaf)
                   for _, leaf in streaming.tree_leaves(resolved))
    for (na, a), (nb, b) in zip(streaming.tree_leaves(resolved),
                                streaming.tree_leaves(alias)):
        assert na == nb and torch.equal(_bits(a), _bits(b)), na
    assert any(is_handle(leaf) for _, leaf in streaming.tree_leaves(kept))


def test_small_leaves_stay_raw():
    """At the default 1 MiB floor the smoke model streams nothing, and the
    tree comes back leaf for leaf."""
    params = build_model(get_smoke_config("qwen3_32b")).init(
        seed=2, device="cpu")
    plan = streaming.streaming_encode_plan(params)
    assert plan.n_inputs == 0 and len(plan.buckets) == 0
    tree = streaming.compress_params_for_streaming(params)
    assert streaming.stream_stats(tree)["streamed_tensors"] == 0
    for (na, a), (nb, b) in zip(streaming.tree_leaves(tree),
                                streaming.tree_leaves(params)):
        assert na == nb and a is b


def _stack(n_layers, per_layer, shape, seed):
    """Seeded bf16 stacks with trained-like outliers, as numpy f32 and the
    two packages' arrays of the same bits."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(n_layers * per_layer) * 0.02
    w[rng.random(w.size) < 2e-3] *= 64.0
    j = jnp.asarray(w.astype(np.float32)).astype(jnp.bfloat16).reshape(
        (n_layers,) + shape)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def test_inspected_plan_runs_and_a_mismatched_plan_raises():
    """The reference's ``test_streaming_policy_executes_inspected_plan``:
    the plan runs in ``len(plan.buckets)`` launches; a plan for other
    shards, another tree or not stacked raises."""
    jw, w = _stack(4, 65_536, (256, 256), seed=2)
    params, jparams = {"period": [{"w": w}]}, {"period": [{"w": jw}]}
    codec = Codec()
    plan = streaming.streaming_encode_plan(params, min_bytes=MIN_BYTES,
                                           shards=1, codec=codec)
    jplan = jax_streaming.streaming_encode_plan(
        jparams, min_bytes=MIN_BYTES, shards=1, codec=JaxCodec())
    assert plan.predicted_wire_bytes == jplan.predicted_wire_bytes
    tree = streaming.compress_params_for_streaming(
        params, min_bytes=MIN_BYTES, shards=1, codec=codec, plan=plan)
    assert codec.encode_cache_stats()["dispatches"] == len(plan.buckets) == 1
    sw = tree["period"][0]["w"]
    assert torch.equal(_bits(torch.movedim(codec.decompress_stacked(sw.ct),
                                           1, 1 + sw.tp_axis)), _bits(w))
    with pytest.raises(ValueError, match="does not match"):
        streaming.compress_params_for_streaming(
            params, min_bytes=MIN_BYTES, shards=2, codec=codec, plan=plan)
    with pytest.raises(ValueError, match="does not match"):
        streaming.compress_params_for_streaming(
            {"period": [{"w": w, "v": w}]}, min_bytes=MIN_BYTES, shards=1,
            codec=codec, plan=plan)
    flat_plan = codec.plan_encode([w], shards=1)
    with pytest.raises(ValueError, match="does not match"):
        streaming.compress_params_for_streaming(
            params, min_bytes=MIN_BYTES, shards=1, codec=codec,
            plan=flat_plan)


def test_materialize_weight_tree_shares_a_decoder_bucket():
    """The reference's ``test_materialize_weight_tree_batched_and_bit_
    exact``: two stacks under one decoder bucket decode in one launch; the
    small norm stays raw."""
    jq, wq = _stack(4, 160_000, (400, 400), seed=20)
    jk, wk = _stack(4, 160_000, (400, 400), seed=30)
    norm = torch.ones((4, 400), dtype=torch.bfloat16)
    params = {"period": [{"wq": wq, "wk": wk, "norm": norm}]}
    jparams = {"period": [{"wq": jq, "wk": jk,
                           "norm": jnp.ones((4, 400), jnp.bfloat16)}]}
    codec, jcodec = Codec(), JaxCodec()
    tree = streaming.compress_params_for_streaming(
        params, min_bytes=MIN_BYTES, shards=SHARDS, codec=codec)
    jtree = jax_streaming.compress_params_for_streaming(
        jparams, min_bytes=MIN_BYTES, shards=SHARDS, codec=jcodec)
    assert sum(is_handle(h) for _, h in streaming.tree_leaves(tree)) == 2
    assert tree["period"][0]["norm"] is norm
    for name in ("wq", "wk"):
        assert wire.to_wire(tree["period"][0][name].ct, stacked=True) == \
            jax_wire.to_wire(jtree["period"][0][name].ct, stacked=True)
    codec.reset_decode_cache_stats()
    out = streaming.materialize_weight_tree(tree, codec)
    assert codec.decode_cache_stats()["dispatches"] == 1
    for name, w in (("wq", wq), ("wk", wk), ("norm", norm)):
        assert torch.equal(_bits(out["period"][0][name]), _bits(w)), name
