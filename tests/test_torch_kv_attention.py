"""Decode attention over an ENEC-compressed KV prefix: the port's
``compress_kv_prefix`` and the plain version of its attention kernel
against the JAX package's (its Pallas kernel in interpret mode, as
tests/test_decode_attention_kv.py runs it) on the same numpy inputs.

The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it against
the plain version there.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BF16 as JAX_BF16
from repro.core import search_for_array as jax_search_for_array
from repro.core.params import EnecParams as JaxEnecParams
from repro.kernels.decode_attention_kv import \
    compress_kv_prefix as jax_compress_kv_prefix
from repro.kernels.decode_attention_kv import \
    decode_attention_kv_enec as jax_decode_attention_kv_enec
from repro_torch.core.dtypes import BF16
from repro_torch.core.params import EnecParams, search_for_array
from repro_torch.kernels import compress_kv_prefix, decode_attention_kv_enec
from repro_torch.kernels import decode_attention_kv as dak

HD = 128
# the tolerance of tests/test_decode_attention_kv.py: f32 sums of the same
# products in another order, through exp and one division
ATOL, RTOL = 2e-5, 1e-4
SHAPES = [(1, 128, 1, 1), (2, 256, 2, 4), (1, 512, 4, 8)]


def _mk(B, S, KV, grp, seed=0, scale=0.3):
    """q, k, v as numpy bf16 (made as the reference test makes them) and
    the reference's params searched over K and V together."""
    rng = np.random.default_rng(seed)

    def t(shape):
        return np.asarray(jnp.asarray(
            rng.standard_normal(shape).astype("float32") * scale
        ).astype(jnp.bfloat16))

    k, v = t((B, S, KV, HD)), t((B, S, KV, HD))
    q = t((B, KV, grp, HD))
    both = np.concatenate([k.ravel(), v.ravel()])
    p = jax_search_for_array(both, JAX_BF16, block_elems=128 * 128)
    return q, k, v, p


def _torch(a):
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _port_params(p):
    return EnecParams(b=p.b, n=p.n, m=p.m, L=p.L, l=p.l)


def _m_equals_n(k, v):
    """Params with no high stream (m == n) covering K and V's exponents."""
    exp = (np.concatenate([k.ravel(), v.ravel()]).view(np.uint16) >> 7) \
        & 0xFF
    lo, hi = int(exp.min()), int(exp.max())
    width = (hi - lo).bit_length() + 1
    return JaxEnecParams(b=hi, n=width, m=width, L=16, l=lo)


def _reference(q, k, v, p):
    ks = jax_compress_kv_prefix(jnp.asarray(k), p)
    vs = jax_compress_kv_prefix(jnp.asarray(v), p)
    out = jax_decode_attention_kv_enec(jnp.asarray(q), ks, vs, p)
    return ks, vs, np.asarray(out)


@pytest.mark.parametrize("B,S,KV,grp", SHAPES)
def test_port_search_finds_the_reference_params(B, S, KV, grp):
    _, k, v, p = _mk(B, S, KV, grp, seed=S)
    both = np.concatenate([k.ravel(), v.ravel()])
    assert search_for_array(both, BF16, block_elems=128 * 128).astuple() \
        == p.astuple()


@pytest.mark.parametrize("B,S,KV,grp", SHAPES)
@pytest.mark.parametrize("m_equals_n", [False, True])
def test_compressed_kv_and_plain_attention_match_reference(B, S, KV, grp,
                                                           m_equals_n):
    q, k, v, p = _mk(B, S, KV, grp, seed=S)
    if m_equals_n:
        p = _m_equals_n(k, v)
    ks_ref, vs_ref, want = _reference(q, k, v, p)
    pp = _port_params(p)
    ks, vs = compress_kv_prefix(_torch(k), pp), compress_kv_prefix(
        _torch(v), pp)
    for got_s, ref_s in ((ks, ks_ref), (vs, vs_ref)):
        for name in got_s._fields:
            np.testing.assert_array_equal(
                getattr(got_s, name).numpy(), np.asarray(getattr(ref_s, name)),
                err_msg=f"stream {name}")
        assert got_s.mask.shape[:3] == (B, KV, S // 128)
    if m_equals_n:
        assert ks.high.shape[-1] == 0
    got = decode_attention_kv_enec(_torch(q), ks, vs, pp)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_plain_attention_matches_dense_softmax():
    """The plain version against decompress-then-attend (the reference
    test's ``_dense``) on the port's own decoded K/V."""
    q, k, v, p = _mk(2, 384, 2, 3, seed=5)
    pp = _port_params(p)
    got = decode_attention_kv_enec(_torch(q), compress_kv_prefix(_torch(k), pp),
                                   compress_kv_prefix(_torch(v), pp), pp)
    qf, kf, vf = (_torch(a).float() for a in (q, k, v))
    scores = torch.einsum("bkgh,bskh->bkgs", qf, kf) / math.sqrt(HD)
    want = torch.einsum("bkgs,bskh->bkgh", torch.softmax(scores, -1), vf)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("shape", [(1, 128, 1, 64), (1, 100, 1, 128),
                                   (2, 200, 2, 128)])
def test_compress_rejects_wrong_head_dim_or_ragged_prefix(shape):
    kv = torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="S % 128"):
        compress_kv_prefix(kv, EnecParams(b=127, n=4, m=2, L=16, l=120))


def test_attention_rejects_wrong_head_dim():
    q, k, v, p = _mk(1, 128, 1, 2, seed=1)
    pp = _port_params(p)
    ks, vs = compress_kv_prefix(_torch(k), pp), compress_kv_prefix(
        _torch(v), pp)
    with pytest.raises(ValueError, match="grp, 128"):
        decode_attention_kv_enec(torch.zeros((1, 1, 2, 64)), ks, vs, pp)
    with pytest.raises(ValueError, match="lead"):
        decode_attention_kv_enec(torch.zeros((1, 2, 2, 128)), ks, vs, pp)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v, p = _mk(1, 128, 1, 2, seed=2)
    pp = _port_params(p)
    ks, vs = compress_kv_prefix(_torch(k), pp), compress_kv_prefix(
        _torch(v), pp)
    with pytest.raises(ValueError, match="CUDA"):
        dak.decode_attention_kv_enec_cuda(_torch(q), ks, vs, pp)
    assert dak.LAUNCHES.n == 0

