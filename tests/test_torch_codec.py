"""The port's block codec against the JAX reference on the same inputs.

Inputs are made with numpy from a seed and fed to both packages; the
stream bytes must be identical and the decode bit-exact (ENEC is
lossless, so every comparison here is exact).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitio as jax_bitio
from repro.core import codec as jax_codec
from repro.core import wire as jax_wire
from repro.core import params as jax_params
from repro.core import stats as jax_stats
from repro.core.codec_api import Codec as JaxCodec
from repro.core.dtypes import FORMATS as JAX_FORMATS
from repro_torch.core import bitio, codec, stats
from repro_torch.core.api import record_overhead_bytes, slice_stacked
from repro_torch.core.codec_api import Codec
from repro_torch.core.dtypes import FORMATS
from repro_torch.core.params import EnecParams, search, widen_for_range

NP_FLOAT = {"bf16": jnp.bfloat16, "fp16": np.float16, "fp32": np.float32}
NP_UINT = {"bf16": np.uint16, "fp16": np.uint16, "fp32": np.uint32}


def _weights(fmt_key, size, seed, outlier=3e-3):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(size) * 0.02
    w[rng.random(size) < outlier] *= 32
    return np.asarray(jnp.asarray(w.astype(np.float32)).astype(
        NP_FLOAT[fmt_key]))


def _both(arr, fmt_key):
    """numpy float array -> (jax array, torch tensor) of the same bits."""
    bits = arr.view(NP_UINT[fmt_key])
    t_bits = torch.from_numpy(bits.astype(np.int64)).to(
        FORMATS[fmt_key].work_dtype)
    return jnp.asarray(bits), t_bits


def _assert_streams_equal(ref, got):
    for name in ref._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)),
            err_msg=f"stream {name}")


@pytest.mark.parametrize("n", [2048, 16384])
def test_piece_map_and_packing_match_reference_every_width(n):
    for width in range(1, 25):
        rng = np.random.default_rng(width * 7 + n)
        vals = rng.integers(0, 1 << width, size=(2, n)).astype(np.uint32)
        ref = np.asarray(jax_bitio.pack_fixed(vals, width, xp=np))
        assert bitio.packed_nbytes(n, width) == ref.shape[-1]
        # the closed-form map reads every element back out of the
        # reference's bytes
        offs, shifts, nbits, dsts = bitio.piece_map(width, n)
        back = np.zeros_like(vals, dtype=np.int64)
        for p in range(offs.shape[0]):
            piece = (ref[:, offs[p]].astype(np.int64) >> shifts[p]) \
                & ((1 << nbits[p]) - 1)
            back |= piece << dsts[p]
        np.testing.assert_array_equal(back, vals, err_msg=f"width {width}")
        got = bitio.pack_fixed(torch.from_numpy(vals.astype(np.int64)), width)
        np.testing.assert_array_equal(got.numpy(), ref,
                                      err_msg=f"pack width {width}")
        un = bitio.unpack_fixed(torch.from_numpy(ref), n, width, torch.int64)
        np.testing.assert_array_equal(un.numpy(), vals)


def test_bool_mask_packing_matches_reference():
    rng = np.random.default_rng(3)
    bits = rng.random((3, 128)) < 0.4
    ref = np.asarray(jax_bitio.pack_bool_mask(jnp.asarray(bits)))
    got = bitio.pack_bool_mask(torch.from_numpy(bits))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        bitio.unpack_bool_mask(got, 128).numpy(), bits)


@pytest.mark.parametrize("fmt_key", ["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("n_elems", [2048, 16384])
def test_encode_streams_byte_identical_searched_params(fmt_key, n_elems):
    arr = _weights(fmt_key, 2 * n_elems, seed=n_elems)
    j_bits, t_bits = _both(arr, fmt_key)
    jfmt, fmt = JAX_FORMATS[fmt_key], FORMATS[fmt_key]
    p = jax_params.search_for_array(arr, jfmt, block_elems=n_elems)
    ref = jax_codec.encode_blocks(j_bits.reshape(2, n_elems), jfmt, p)
    got = codec.encode_blocks(t_bits.reshape(2, n_elems), fmt, p)
    _assert_streams_equal(ref, got)
    dec = codec.decode_blocks(got, n_elems, fmt, p)
    np.testing.assert_array_equal(
        dec.numpy().view(NP_UINT[fmt_key]).reshape(-1),
        arr.view(NP_UINT[fmt_key]))


# the (m, n, L) grid of tests/test_kernels.py, plus the all-anomalous
# (m=1) and no-anomaly (m == n) edges
@pytest.mark.parametrize("m,n_width,L", [(1, 4, 16), (3, 6, 16), (5, 6, 32),
                                         (2, 7, 64), (6, 6, 16), (1, 8, 128)])
@pytest.mark.parametrize("n_elems", [2048, 16384])
def test_encode_decode_param_grid(m, n_width, L, n_elems):
    arr = _weights("bf16", 2 * n_elems, seed=m * 10 + n_width, outlier=0)
    bits = arr.view(np.uint16)
    exp = (bits >> 7) & 0xFF
    if int(exp.max()) - int(exp.min()) >= (1 << n_width):
        # keep the draw injective for this n: clamp the exponent range
        lo = int(exp.max()) - (1 << n_width) + 1
        bits = np.where(exp < lo, (bits & 0x807F) | (lo << 7),
                        bits).astype(np.uint16)
        exp = (bits >> 7) & 0xFF
    p = EnecParams(b=int(exp.max()), n=n_width, m=m, L=L, l=int(exp.min()))
    j_bits, t_bits = _both(bits.view(jnp.bfloat16), "bf16")
    ref = jax_codec.encode_blocks(j_bits.reshape(2, n_elems),
                                  JAX_FORMATS["bf16"], p)
    got = codec.encode_blocks(t_bits.reshape(2, n_elems), FORMATS["bf16"], p)
    _assert_streams_equal(ref, got)
    if m == n_width:
        assert got.high.shape[-1] == 0
    dec = codec.decode_blocks(got, n_elems, FORMATS["bf16"], p)
    np.testing.assert_array_equal(dec.numpy().view(np.uint16).reshape(-1),
                                  bits)


def test_all_and_no_anomaly_blocks():
    n_elems, L = 2048, 16
    p = EnecParams(b=127, n=4, m=2, L=L, l=120)
    # block 0: every group anomalous (exponents far from b); block 1: none
    exps = np.concatenate([np.full(n_elems, 120), np.full(n_elems, 127)])
    rng = np.random.default_rng(0)
    bits = ((exps << 7) | rng.integers(0, 1 << 7, exps.size)
            | (rng.integers(0, 2, exps.size) << 15)).astype(np.uint16)
    j_bits, t_bits = _both(bits.view(jnp.bfloat16), "bf16")
    ref = jax_codec.encode_blocks(j_bits.reshape(2, n_elems),
                                  JAX_FORMATS["bf16"], p)
    got = codec.encode_blocks(t_bits.reshape(2, n_elems), FORMATS["bf16"], p)
    _assert_streams_equal(ref, got)
    assert int(got.high_len[0]) == n_elems * (p.n - p.m)
    assert int(got.high_len[1]) == 0
    dec = codec.decode_blocks(got, n_elems, FORMATS["bf16"], p)
    np.testing.assert_array_equal(dec.numpy().view(np.uint16).reshape(-1),
                                  bits)


def test_decode_per_block_params_across_the_wrap_boundary():
    """Blocks of two tensors with different (b, l) but the same (n, m, L)
    decode in one call with per-block vectors.  Exponents fill each
    window up to its modular-wrap edge, where applying one block's (b, l)
    to the other corrupts values."""
    n_elems = 2048
    rng = np.random.default_rng(5)
    ps = [EnecParams(b=126, n=4, m=2, L=16, l=120),
          EnecParams(b=100, n=4, m=2, L=16, l=90)]
    fmt, jfmt = FORMATS["bf16"], JAX_FORMATS["bf16"]
    blocks, streams = [], []
    for p in ps:
        exps = rng.integers(p.l, p.l + (1 << p.n), n_elems)
        exps[:2] = (p.l, p.l + (1 << p.n) - 1)
        bits = ((exps << 7) | rng.integers(0, 128, n_elems)).astype(np.uint16)
        blocks.append(bits)
        _, t_bits = _both(bits.view(jnp.bfloat16), "bf16")
        streams.append(codec.encode_blocks(t_bits.reshape(1, n_elems), fmt,
                                           p))
    joint = codec.BlockStreams(*(torch.cat(f) for f in zip(*streams)))
    b_vec = torch.tensor([p.b for p in ps], dtype=torch.int32)
    l_vec = torch.tensor([p.l for p in ps], dtype=torch.int32)
    want = np.stack(blocks)
    got = codec.decode_blocks(joint, n_elems, fmt, ps[0], b_vec, l_vec)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)
    jref = jax_codec.decode_blocks(
        jax_codec.BlockStreams(*(jnp.asarray(a.numpy()) for a in joint)),
        n_elems, jfmt, ps[0], b_vec=jnp.asarray(b_vec.numpy()),
        l_vec=jnp.asarray(l_vec.numpy()))
    np.testing.assert_array_equal(np.asarray(jref), want)
    bad = codec.decode_blocks(joint, n_elems, fmt, ps[0])
    assert not np.array_equal(bad.numpy().view(np.uint16), want)


@pytest.mark.parametrize("fmt_key", ["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("size", [5000, 3 * 65536 + 17])
def test_stats_search_picks_reference_params(fmt_key, size):
    arr = _weights(fmt_key, size, seed=size)
    j_bits, t_bits = _both(arr, fmt_key)
    jfmt, fmt = JAX_FORMATS[fmt_key], FORMATS[fmt_key]
    ref = jax_stats.stack_stats(j_bits[None], jfmt)
    got = stats.stack_stats(t_bits[None], fmt)
    np.testing.assert_array_equal(got.hist, ref.hist)
    assert got.bounds() == ref.bounds()
    p_ref = jax_params.widen_for_range(jax_params.search(ref.hist, jfmt),
                                       *ref.bounds())
    p_got = widen_for_range(search(got.hist, fmt), *got.bounds())
    assert dataclasses.asdict(p_got) == dataclasses.asdict(p_ref)


@pytest.mark.parametrize("shards", [1, 2])
def test_compress_stacked_wire_bytes_and_streams_match_reference(shards):
    rng = np.random.default_rng(11)
    stack = np.asarray(jnp.asarray(
        (rng.standard_normal((3, 96, 200)) * 0.02).astype(np.float32)
    ).astype(jnp.bfloat16))
    [ref] = JaxCodec(block_elems=2048).compress_stacked_many(
        [jnp.asarray(stack)], shards=shards)
    t = torch.from_numpy(stack.view(np.int16).copy()).view(torch.bfloat16)
    [got] = Codec(block_elems=2048).compress_stacked_many([t], shards=shards)
    assert dataclasses.asdict(got.params) == dataclasses.asdict(ref.params)
    assert got.nbytes_wire() == ref.nbytes_wire()
    _assert_streams_equal(ref.streams, got.streams)
    codec_obj = Codec(block_elems=2048)
    layer = codec_obj.decompress_array(slice_stacked(got, 1))
    assert codec_obj.decode_cache_stats()["dispatches"] == 1
    np.testing.assert_array_equal(layer.view(torch.int16).numpy(),
                                  stack[1].view(np.int16))


def test_const_and_raw_escapes_and_overhead():
    codec_obj = Codec(block_elems=2048)
    x = torch.full((64, 40), 0.5, dtype=torch.bfloat16)
    ct = codec_obj.compress_array(x)
    ref = JaxCodec(block_elems=2048).compress_array(
        jnp.full((64, 40), 0.5, jnp.bfloat16))
    assert ct.mode == ref.mode == "const"
    assert ct.nbytes_wire() == ref.nbytes_wire()
    assert torch.equal(codec_obj.decompress_array(ct), x)
    ints = torch.arange(10, dtype=torch.int32)
    raw = codec_obj.compress_array(ints)
    assert raw.mode == "raw"
    assert raw.nbytes_wire() == JaxCodec().compress_array(
        jnp.arange(10, dtype=jnp.int32)).nbytes_wire()
    assert torch.equal(codec_obj.decompress_array(raw), ints)
    for mode in ("enec", "raw", "const"):
        for ndim in (1, 2, 3):
            assert record_overhead_bytes(mode, ndim) == \
                jax_wire.record_overhead_bytes(mode, ndim)
