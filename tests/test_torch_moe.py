"""The port's MoE block (``repro_torch/models/moe.py``) against the JAX
package's (``repro/models/moe.py``) on the two MoE smoke configs: the same
JAX-initialised weights (``convert.params_from_jax``) and the same seeded
inputs, at B in {1, 3} and T in {1, 7, 64}.

The routed expert ids must be equal (each token's top-k, and each
(sequence, expert) capacity pick where its gate is positive: zero-gate
slots contribute exactly +0.0 whatever token they hold).  The outputs are
bf16 and differ from the reference by the f32 sum order inside the
products (XLA and the port's tiled matmul order them differently), which
moves an output by at most one bf16 ulp: the bound is ``LOGIT_ATOL``
(2**-8) times the larger of 1 and the reference output's magnitude, as in
tests/test_torch_serve.py.  The aux losses differ by the router product's
f32 sum order: within 1e-6 of the larger of 1 and their magnitude (the
z-loss is ~4 on qwen3_moe's smoke config).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import moe

ARCHS = ("phi3_5_moe_42b_a6_6b", "qwen3_moe_235b_a22b")
LOGIT_ATOL = 2.0 ** -8
AUX_TOL = 1e-6


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    """Layer 0's MoE weights of the smoke config in both packages."""
    jparams = jax_build_model(jax_smoke_config(request.param)).init(
        jax.random.key(0))
    cfg = get_smoke_config(request.param)
    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    jp = jax.tree.map(lambda a: a[0], jparams["period"][0]["moe"])
    tp = {k: v[0] for k, v in params["period"][0]["moe"].items()}
    return cfg, jp, tp


def _jax_route(p, x, k):
    """The reference's routing lines of ``moe_block`` (moe.py:88-101)."""
    b, t, _ = x.shape
    e = p["router"].shape[1]
    logits = jnp.einsum("btd,de->bte", x.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    topk_p, topk_i = jax.lax.top_k(probs, k)
    topk_p = topk_p / jnp.maximum(topk_p.sum(-1, keepdims=True), 1e-9)
    bidx = jnp.arange(b)[:, None, None]
    tidx = jnp.arange(t)[None, :, None]
    assign = jnp.zeros((b, t, e), jnp.float32).at[bidx, tidx, topk_i].set(
        topk_p)
    gate_ec, idx_ec = jax.lax.top_k(assign.transpose(0, 2, 1),
                                    jax_moe.capacity_for(t, e, k))
    return np.asarray(topk_i), np.asarray(gate_ec), np.asarray(idx_ec)


def _inputs(cfg, b, t):
    x = np.random.default_rng(1000 * b + t).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).bfloat16()
    return xj, xt


@pytest.mark.parametrize("t_len,e,k", list(itertools.product(
    (1, 2, 7, 8, 9, 31, 64, 100, 2048), (4, 8, 16, 128), (1, 2, 8))))
def test_capacity_for_matches_reference(t_len, e, k):
    assert moe.capacity_for(t_len, e, k) == jax_moe.capacity_for(t_len, e, k)


@pytest.mark.parametrize("b,t", [(1, 1), (1, 7), (1, 64), (3, 1), (3, 7),
                                 (3, 64)])
def test_moe_block_matches_reference(layer, b, t):
    cfg, jp, tp = layer
    k = cfg.experts_per_token
    xj, xt = _inputs(cfg, b, t)
    want_i, want_gate, want_idx = _jax_route(jp, xj, k)
    r = moe.route(tp["router"], xt, k)
    np.testing.assert_array_equal(r["topk_i"].numpy(), want_i)
    live = want_gate > 0
    np.testing.assert_array_equal(r["gate_ec"].numpy() > 0, live)
    np.testing.assert_array_equal(r["idx_ec"].numpy()[live], want_idx[live])

    want, want_aux = jax_moe.moe_block(jp, xj, k)
    got, aux = moe.moe_block(tp, xt, k)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and got.shape == (b, t, cfg.d_model)
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=0,
        atol=LOGIT_ATOL * max(1.0, float(np.abs(want).max())))
    for name in ("lb_loss", "z_loss"):
        w = float(want_aux[name])
        assert abs(float(aux[name]) - w) <= AUX_TOL * max(1.0, abs(w)), name


def test_ties_break_toward_the_lower_index():
    """The capacity pick of a short sequence is mostly zero-gate ties:
    ``_top`` orders them as ``jax.lax.top_k`` does."""
    x = np.array([[0.0, 0.5, 0.0, 0.0, 0.5, 0.25, 0.0, 0.0]], np.float32)
    vals, idx = moe._top(torch.from_numpy(x), 6)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_dense_stack_and_unrouted_skip_give_the_same_bits(layer):
    """Computing only the routed experts (what an expert store does) gives
    the bits of computing all of them: an unrouted expert adds +0.0."""
    cfg, _, tp = layer
    _, xt = _inputs(cfg, 1, 1)     # one token: k of E experts routed
    want, _ = moe.moe_block(tp, xt, cfg.experts_per_token)
    routed = set(moe.route(tp["router"], xt, cfg.experts_per_token)[
        "topk_i"].unique().tolist())
    assert len(routed) < cfg.n_experts
    orig = moe._expert_weights

    def routed_only(p, topk_i):
        experts, weights = orig(p, topk_i)
        return [e for e in experts if e in routed], weights

    try:
        moe._expert_weights = routed_only
        got, _ = moe.moe_block(tp, xt, cfg.experts_per_token)
    finally:
        moe._expert_weights = orig
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
