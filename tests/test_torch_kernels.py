"""The plain versions of the port's kernels against the JAX package's
Pallas kernels (run in interpret mode, as tests/test_kernels.py runs them)
on the same numpy inputs.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jax_codec
from repro.core.api import slice_stacked as jax_slice
from repro.core.codec_api import Codec as JaxCodec
from repro.core.dtypes import BF16 as JAX_BF16
from repro.kernels import ref as jax_ref
from repro.kernels.decompress_matmul import decompress_matmul as jax_fused
from repro.kernels.enec_decode import decode_blocks_pallas
from repro.kernels.enec_encode import encode_blocks_pallas
from repro_torch.core import codec
from repro_torch.core.api import slice_stacked
from repro_torch.core.codec_api import Codec
from repro.core import params as jax_params
from repro.core.dtypes import FORMATS as JAX_FORMATS
from repro_torch.core.dtypes import BF16, FORMATS, to_container
from repro_torch.core.params import EnecParams
from repro_torch.kernels.decompress_matmul import (DENSE_LAUNCHES,
                                                  FUSED_LAUNCHES,
                                                  decompress_matmul_cuda,
                                                  decompress_matmul_plain,
                                                  dense_matmul_cuda,
                                                  dense_matmul_plain)
from repro_torch.kernels import enec_decode, enec_encode, ops

# f32 sums of the same products in another order: |error| grows with the
# number of terms (K <= 512 here) and the magnitude of the partial sums
MATMUL_RTOL, MATMUL_ATOL = 1e-5, 1e-5


def _bf16(a):
    return np.asarray(jnp.asarray(np.asarray(a, np.float32)).astype(
        jnp.bfloat16))


def _torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _decode_case(kind, n_elems=2048, nblocks=2):
    rng = np.random.default_rng(len(kind))
    n = n_elems * nblocks
    if kind == "searched":
        w = _bf16(rng.standard_normal(n) * 0.02)
        bits = w.view(np.uint16)
        exp = (bits >> 7) & 0xFF
        lo, hi = int(exp.min()), int(exp.max())
        p = EnecParams(b=hi - 3, n=(hi - lo).bit_length() + 1, m=3, L=16,
                       l=lo)
    elif kind == "m_equals_n":
        bits = ((rng.integers(120, 128, n) << 7)
                | rng.integers(0, 1 << 16, n) & 0x807F).astype(np.uint16)
        p = EnecParams(b=127, n=4, m=4, L=16, l=120)
    else:   # all groups anomalous in block 0, none in block 1
        exps = np.concatenate([np.full(n_elems, 120), np.full(n_elems, 127)])
        bits = ((exps << 7) | rng.integers(0, 128, n)).astype(np.uint16)
        p = EnecParams(b=127, n=4, m=2, L=16, l=120)
    return bits.reshape(nblocks, n_elems), p


@pytest.mark.parametrize("kind", ["searched", "m_equals_n", "all_and_none"])
def test_plain_decode_bit_exact_against_pallas_kernel(kind):
    bits, p = _decode_case(kind)
    n_elems = bits.shape[1]
    t_bits = torch.from_numpy(bits.astype(np.int32))
    streams = codec.encode_blocks(t_bits, BF16, p)
    j_streams = jax_codec.BlockStreams(
        *(jnp.asarray(a.numpy()) for a in streams))
    want = np.asarray(decode_blocks_pallas(j_streams, n_elems, JAX_BF16, p,
                                           interpret=True))
    got = enec_decode.decode_blocks_plain(streams, n_elems, BF16, p)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)
    np.testing.assert_array_equal(want, bits)
    routed = ops.decode_blocks(streams, n_elems, BF16, p)
    assert torch.equal(routed, got)


_NP_UINT = {"bf16": np.uint16, "fp16": np.uint16, "fp32": np.uint32}


def _encode_case(fmt_key, m_equals_n=False, n_elems=2048, nblocks=2):
    """(B, N) unsigned bits of realistic weights and their searched
    params (or, for m == n, params that leave no high stream)."""
    rng = np.random.default_rng(len(fmt_key) + 7 * m_equals_n)
    w = rng.standard_normal(n_elems * nblocks) * 0.02
    w[rng.random(w.size) < 3e-3] *= 32
    dt = {"bf16": jnp.bfloat16, "fp16": np.float16, "fp32": np.float32}
    arr = np.asarray(jnp.asarray(w.astype(np.float32)).astype(dt[fmt_key]))
    bits = arr.view(_NP_UINT[fmt_key]).reshape(nblocks, n_elems)
    fmt = FORMATS[fmt_key]
    exp = (bits.astype(np.int64) >> fmt.mant_bits) & fmt.exp_mask
    lo, hi = int(exp.min()), int(exp.max())
    if m_equals_n:
        n = max((hi - lo).bit_length(), 1)
        p = EnecParams(b=hi, n=n, m=n, L=16, l=lo)
    else:
        p = jax_params.search_for_array(arr, JAX_FORMATS[fmt_key],
                                        block_elems=n_elems)
    return bits, p


# bytes are compared exactly: the encoder is integer bit packing
@pytest.mark.parametrize("fmt_key,m_equals_n", [("bf16", False),
                                                ("fp16", False),
                                                ("fp32", False),
                                                ("bf16", True)])
def test_plain_encoder_byte_identical_to_pallas_kernel(fmt_key, m_equals_n):
    bits, p = _encode_case(fmt_key, m_equals_n)
    fmt = FORMATS[fmt_key]
    want = encode_blocks_pallas(jnp.asarray(bits), JAX_FORMATS[fmt_key], p,
                                interpret=True)
    t_bits = torch.from_numpy(bits.astype(np.int64)).to(fmt.work_dtype)
    got = enec_encode.encode_blocks_plain(to_container(t_bits, fmt), fmt, p)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=f"stream {name}")
    if m_equals_n:
        assert got.high.shape[-1] == 0 and int(got.high_len.sum()) == 0
    routed = ops.encode_blocks(t_bits, fmt, p)
    for a, b in zip(routed, got):
        assert torch.equal(a, b)
    dec = ops.decode_blocks(got, bits.shape[1], fmt, p)
    np.testing.assert_array_equal(
        dec.numpy().view(_NP_UINT[fmt_key]), bits)


def _fused_pair(k, n, shards, seed):
    rng = np.random.default_rng(seed)
    w = _bf16(rng.standard_normal((k, n)) * 0.02)
    [jct] = JaxCodec().tile_weights_for_fusion_many([jnp.asarray(w)],
                                                    shards=shards)
    [tct] = Codec().tile_weights_for_fusion_many([_torch(w)], shards=shards)
    assert dataclasses.asdict(tct.params) == dataclasses.asdict(jct.params)
    for name in jct.streams._fields:
        np.testing.assert_array_equal(getattr(tct.streams, name).numpy(),
                                      np.asarray(getattr(jct.streams, name)))
    return w, jax_slice(jct, 0), slice_stacked(tct, 0)


@pytest.mark.parametrize("mkn,shards", [((8, 256, 384), 1),
                                        ((8, 250, 384), 1),
                                        ((4, 128, 120), 1),
                                        ((8, 256, 384), 2)])
def test_plain_fused_matmul_against_pallas_kernel(mkn, shards):
    m, k, n = mkn
    w, jct, tct = _fused_pair(k, n, shards, seed=k + n + shards)
    x = _bf16(np.random.default_rng(m).standard_normal((m, k)))
    want = np.asarray(jax_fused(jnp.asarray(x), jct, k, n, interpret=True))
    got = decompress_matmul_plain(_torch(x), tct, k, n)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=MATMUL_RTOL,
                               atol=MATMUL_ATOL)
    # the reference's plain canonical matmul on the dense weight
    want_dense = np.asarray(jax_ref.tiled_matmul_ref(jnp.asarray(x),
                                                     jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want_dense, rtol=MATMUL_RTOL,
                               atol=MATMUL_ATOL)
    # inside the port the fused and dense plain paths are bitwise equal
    dense = dense_matmul_plain(_torch(x), _torch(w))
    assert torch.equal(got.view(torch.int32), dense.view(torch.int32))
    assert torch.equal(ops.decompress_matmul(_torch(x), tct, k, n)
                       .view(torch.int32), got.view(torch.int32))
    assert torch.equal(ops.tiled_matmul(_torch(x), _torch(w))
                       .view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("fmt_key", ["fp16", "fp32"])
def test_plain_fused_matmul_other_formats(fmt_key):
    k, n, m = 256, 128, 4
    rng = np.random.default_rng(9)
    dt = {"fp16": np.float16, "fp32": np.float32}[fmt_key]
    w = (rng.standard_normal((k, n)) * 0.02).astype(dt)
    x = rng.standard_normal((m, k)).astype(np.float32)
    [tct] = Codec().tile_weights_for_fusion_many([torch.from_numpy(w)])
    assert tct.fmt == FORMATS[fmt_key]
    got = decompress_matmul_plain(torch.from_numpy(x), slice_stacked(
        tct, 0), k, n)
    want = np.asarray(jax_ref.tiled_matmul_ref(jnp.asarray(x),
                                               jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=MATMUL_RTOL,
                               atol=MATMUL_ATOL)
    dense = dense_matmul_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(got.view(torch.int32), dense.view(torch.int32))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: CPU tensors never reach it
    (ops routes them to the plain version)."""
    bits, p = _decode_case("searched")
    streams = codec.encode_blocks(torch.from_numpy(bits.astype(np.int32)),
                                  BF16, p)
    vec = torch.zeros(bits.shape[0], dtype=torch.int32)
    with pytest.raises(ValueError):
        enec_decode.decode_blocks_cuda(streams, bits.shape[1], BF16, p, vec,
                                       vec)
    with pytest.raises(ValueError):
        dense_matmul_cuda(torch.zeros(2, 128), torch.zeros(128, 128))
    _, _, tct = _fused_pair(256, 128, 1, seed=5)
    with pytest.raises(ValueError):
        decompress_matmul_cuda(torch.zeros(2, 256, dtype=torch.bfloat16),
                               tct, 256, 128)
    with pytest.raises(ValueError):
        enec_encode.encode_blocks_cuda(
            to_container(torch.from_numpy(bits.astype(np.int32)), BF16), BF16,
            p, vec)
    assert enec_decode.LAUNCHES.n == 0 and DENSE_LAUNCHES.n == 0
    assert FUSED_LAUNCHES.n == 0
    assert enec_encode.LAUNCHES.n == 0
