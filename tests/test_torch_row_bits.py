"""A row's bits do not depend on how many rows are computed with it (the
engine's contract, ROADMAP Port convention 4): the port's canonical tiled
matmul ``kernels/ref.py:tiled_matmul_ref`` and the logits head
``models/layers.py:lm_logits`` give every row the same bits at every M and
for either weight layout, so a prompt's logits are the same served alone,
in a batch of 2 or in a batch of 4, in every weight mode; and the batch of
4 still matches the JAX package's greedy tokens within the serve tests'
tolerance.

On the card ``chip_smoke.py`` checks the same property of the kernels
(phase matmul: every leaf at M = 1, 4, 256 and the full-width llama head at
M = 1, 2, 4).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.runtime.streaming import assign_weight_modes as jax_assign
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ref import tiled_matmul_ref
from repro_torch.models import build_model
from repro_torch.models.layers import lm_logits
from repro_torch.runtime.streaming import assign_weight_modes

M_BIG = 300
# tests/test_torch_serve.py's bound: 2**-8 times the larger of 1 and the
# reference logits' magnitude (f32 sums in another order moving a bf16
# activation cast by about one ulp)
LOGIT_ATOL = 2.0 ** -8
DECODE_STEPS = 4


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["row_major", "transposed"])
def test_tiled_matmul_rows_independent_of_m(x_dtype, layout):
    """Rows at M = 1, 2, 4, 8 equal the same rows at M = 300, bitwise, with
    ragged K and N (zero-padded tiles); the transposed view (the layout a
    stream handle materializes, and the tied head ``embed.T``) gives the
    row-major weight's bits."""
    rng = np.random.default_rng(7)
    k, n = 1000, 700
    x = torch.from_numpy(rng.standard_normal((M_BIG, k)).astype(np.float32))
    x = x.to(x_dtype)
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k))
                         .astype(np.float32)).bfloat16()
    if layout == "transposed":
        w = w.t().contiguous().t()
    big = tiled_matmul_ref(x, w)
    assert big.dtype == torch.float32 and tuple(big.shape) == (M_BIG, n)
    np.testing.assert_allclose(big.numpy(), (x.float() @ w.float()).numpy(),
                               rtol=1e-5, atol=1e-5)
    for m in (1, 2, 4, 8):
        for start in (0, M_BIG - m):
            rows = slice(start, start + m)
            assert torch.equal(_bits(tiled_matmul_ref(x[rows], w)),
                               _bits(big[rows])), (m, start)
    if layout == "transposed":
        assert torch.equal(_bits(tiled_matmul_ref(x, w.contiguous())),
                           _bits(big))


def test_lm_logits_rows_independent_of_batch():
    """The head over a tied (V, D) embedding's transposed view: each row
    of a (B, T) batch equal to the row computed alone."""
    rng = np.random.default_rng(8)
    embed = torch.from_numpy((rng.standard_normal((600, 128)) * 0.02)
                             .astype(np.float32)).bfloat16()
    x = torch.from_numpy(rng.standard_normal((4, 3, 128))
                         .astype(np.float32)).bfloat16()
    full = lm_logits(x, embed.T)
    assert tuple(full.shape) == (4, 3, 600)
    for b in range(4):
        for t in range(3):
            alone = lm_logits(x[b:b + 1, t:t + 1], embed.T)
            assert torch.equal(_bits(alone[0, 0]), _bits(full[b, t]))


@pytest.fixture(scope="module")
def llama():
    jcfg = jax_smoke_config("llama3_2_1b")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_smoke_config("llama3_2_1b")
    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 12))
    return jmodel, jparams, build_model(cfg), params, prompts


def _serve(model, tree, prompts):
    logits, cache = model.prefill_fn(
        tree, {"tokens": torch.from_numpy(prompts)}, 12 + DECODE_STEPS + 1)
    tok = torch.argmax(logits, -1)
    out, toks = [logits], [tok]
    for _ in range(DECODE_STEPS):
        logits, cache = model.decode_fn(tree, cache, tok)
        tok = torch.argmax(logits, -1)
        out.append(logits)
        toks.append(tok)
    return torch.stack(out), torch.stack(toks)


@pytest.mark.parametrize("mode", ["dense", "stream", "fused"])
def test_batch_rows_equal_alone_and_in_pairs(llama, mode):
    """A batch of 4 prompts: each prompt's logits (prefill and every decode
    step) bitwise equal to the prompt served alone (M = 1 in every decode
    matmul) and to the first two served as a batch of 2."""
    _, _, model, params, prompts = llama
    tree = assign_weight_modes(params, mode=mode, min_bytes=1024, shards=2)
    full, toks = _serve(model, tree, prompts)
    for i in range(4):
        alone, alone_toks = _serve(model, tree, prompts[i:i + 1])
        assert torch.equal(_bits(alone), _bits(full[:, i:i + 1])), i
        assert torch.equal(alone_toks, toks[:, i:i + 1]), i
    pair, _ = _serve(model, tree, prompts[:2])
    assert torch.equal(_bits(pair), _bits(full[:, :2]))


def test_batch_of_four_modes_equal_and_match_reference(llama):
    """The batch of 4 in the three modes: bitwise equal logits, and the
    reference's greedy tokens within the serve tests' logit tolerance."""
    jmodel, jparams, model, params, prompts = llama
    jtree = jax_assign(jparams, mode="dense", min_bytes=1024, shards=2)
    logits, cache = jmodel.prefill_fn(
        jtree, {"tokens": jax.numpy.asarray(prompts, jax.numpy.int32)},
        12 + DECODE_STEPS + 1)
    want, want_toks = [np.asarray(logits)], []
    tok = jax.numpy.argmax(logits, -1).astype(jax.numpy.int32)
    want_toks.append(np.asarray(tok))
    for _ in range(DECODE_STEPS):
        logits, cache = jmodel.decode_fn(jtree, cache, tok)
        tok = jax.numpy.argmax(logits, -1).astype(jax.numpy.int32)
        want.append(np.asarray(logits))
        want_toks.append(np.asarray(tok))
    want = np.stack(want)
    outs = {mode: _serve(model, assign_weight_modes(
        params, mode=mode, min_bytes=1024, shards=2), prompts)
        for mode in ("dense", "stream", "fused")}
    for mode in ("stream", "fused"):
        assert torch.equal(_bits(outs[mode][0]), _bits(outs["dense"][0]))
        assert torch.equal(outs[mode][1], outs["dense"][1])
    got, toks = outs["fused"]
    np.testing.assert_array_equal(toks.numpy(), np.stack(want_toks))
    atol = LOGIT_ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
