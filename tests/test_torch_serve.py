"""The port's serving path against the JAX package on the smoke configs
of the dense family: the same weights (JAX init, carried over with
``convert.params_from_jax``), the same prompts, prefill and 8 greedy
decode steps.  llama3_2_1b ties its head; qwen3_32b normalises q and k per
head (``qk_norm``); stablelm_3b is MHA; minitron_4b's d_model 96 leaves
every matmul tile ragged and its untied head is a flat stream.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.runtime.streaming import assign_weight_modes as jax_assign
from repro.runtime.streaming import mode_mix as jax_mode_mix
from repro.runtime.streaming import stream_stats as jax_stream_stats
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.runtime.streaming import (assign_weight_modes, mode_mix,
                                           stream_stats)


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


DECODE_STEPS = 8
# Logits may differ from the reference by the f32 sum order inside each
# 128-term tile product (XLA and torch order them differently); where that
# moves a bf16 activation cast, the change is about one bf16 ulp (2**-8
# relative) of the smoke activations and logits.  Those are O(1) on the
# llama3_2_1b smoke config (|logit| <= 0.8: the bound is 2**-8) and reach
# |logit| ~ 3.5 on the others, so the bound is 2**-8 times the larger of 1
# and the reference logits' magnitude.
LOGIT_ATOL = 2.0 ** -8
# The MoE smoke configs route each token through the same experts in both
# packages (tests/test_torch_moe.py holds the routed ids equal), and their
# residual reaches |x| in [2, 4), where one bf16 ulp is 2**-6: one flipped
# residual element of qwen3_moe's layer 1 moves a prefill logit by 0.016,
# 1.08x the dense bound.  Their bound is two bf16 ulps of the logits.
MOE_ARCHS = ("phi3_5_moe_42b_a6_6b", "qwen3_moe_235b_a22b")


def _logit_atol(want, arch: str = "") -> float:
    ulps = 2.0 if arch in MOE_ARCHS else 1.0
    return ulps * LOGIT_ATOL * max(1.0, float(np.abs(want).max()))


ARCHS = ("llama3_2_1b", "qwen3_32b", "stablelm_3b", "minitron_4b") \
    + MOE_ARCHS


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = jax_smoke_config(request.param)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    host = jax.device_get(jparams)
    cfg = get_smoke_config(request.param)
    params = params_from_jax(host, "cpu", cfg=cfg)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    return jmodel, jparams, build_model(cfg), params, prompts, request.param


def _serve_jax(model, tree, prompts):
    logits, cache = model.prefill_fn(
        tree, {"tokens": jax.numpy.asarray(prompts, jax.numpy.int32)}, 24)
    out = [np.asarray(logits)]
    tok = jax.numpy.argmax(logits, -1).astype(jax.numpy.int32)
    toks = [np.asarray(tok)]
    for _ in range(DECODE_STEPS):
        logits, cache = model.decode_fn(tree, cache, tok)
        tok = jax.numpy.argmax(logits, -1).astype(jax.numpy.int32)
        out.append(np.asarray(logits))
        toks.append(np.asarray(tok))
    return np.stack(out), np.stack(toks)


def _serve_torch(model, tree, prompts):
    logits, cache = model.prefill_fn(
        tree, {"tokens": torch.from_numpy(prompts)}, 24)
    tok = torch.argmax(logits, -1)
    out, toks = [logits], [tok]
    for _ in range(DECODE_STEPS):
        logits, cache = model.decode_fn(tree, cache, tok)
        tok = torch.argmax(logits, -1)
        out.append(logits)
        toks.append(tok)
    return torch.stack(out), torch.stack(toks)


def test_three_modes_bitwise_equal_and_match_reference(setup):
    jmodel, jparams, model, params, prompts, arch = setup
    want_logits, want_toks = _serve_jax(
        jmodel, jax_assign(jparams, mode="dense", min_bytes=1024, shards=2),
        prompts)
    outs = {}
    for mode in ("dense", "stream", "fused"):
        tree = assign_weight_modes(params, mode=mode, min_bytes=1024,
                                   shards=2)
        jtree = jax_assign(jparams, mode=mode, min_bytes=1024, shards=2)
        assert mode_mix(tree) == jax_mode_mix(jtree), mode
        # every count (overlap_eligible_tensors too) and the byte ratio
        stats, want = stream_stats(tree), jax_stream_stats(jtree)
        assert stats.pop("hbm_ratio") == pytest.approx(
            want.pop("hbm_ratio"), rel=1e-12), mode
        assert stats == want, mode
        outs[mode] = _serve_torch(model, tree, prompts)
    for mode in ("stream", "fused"):
        assert torch.equal(outs[mode][0].view(torch.int32),
                           outs["dense"][0].view(torch.int32)), mode
        assert torch.equal(outs[mode][1], outs["dense"][1]), mode
    logits, toks = outs["fused"]
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                               atol=_logit_atol(want_logits, arch))


def test_raw_tree_serves_like_the_handles(setup):
    """Unassigned weights (plain tensors) serve the same greedy tokens as
    the handle tree: the plain einsum path and the tiled schedule differ
    only in the order of f32 sums."""
    _, _, model, params, prompts, _ = setup
    raw_logits, raw_toks = _serve_torch(model, params, prompts)
    tree = assign_weight_modes(params, mode="dense", min_bytes=1024)
    logits, toks = _serve_torch(model, tree, prompts)
    assert torch.equal(raw_toks, toks)
    np.testing.assert_allclose(raw_logits.numpy(), logits.numpy(), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serve_with_an_expert_cache_bitwise_equal(arch):
    """``launch.serve`` on an MoE smoke config, fused, and fused with
    ``--expert-cache-mb`` 0, an eviction-forcing budget and an unbounded
    one, gives the same greedy tokens and bitwise-equal logits (the three
    modes are held equal above); the store's steps run eagerly."""
    from repro_torch.launch import serve
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--tokens", "4",
            "--batch", "2", "--prompt-len", "8", "--min-bytes", "1024",
            "--mode", "fused"]
    runs = {"fused": serve.main(base)}
    for mb in ("0", "0.05", "1000"):
        runs[mb] = serve.main(base + ["--expert-cache-mb", mb])
        st = runs[mb]["experts"]
        assert st["misses"] > 0 and st["fetches"] > 0
        assert (st["evictions"] > 0) == (mb != "1000")
        assert runs[mb]["stream_stats"]["expert_tensors"] == 3
        assert len(runs[mb]["step_decode_s"]) == len(runs[mb]["step_s"])
    ref = runs["fused"]
    for name, out in runs.items():
        assert torch.equal(out["tokens"], ref["tokens"]), name
        assert torch.equal(out["logits"].view(torch.int32),
                           ref["logits"].view(torch.int32)), name
    assert ref["experts"] is None
