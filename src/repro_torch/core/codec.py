"""ENEC block codec (paper §IV-B + §V), plain PyTorch port of
``repro/core/codec.py`` with byte-identical streams.

A tensor is flattened, padded to a multiple of the block size and encoded
block by block:

  exponent --linear map--> y --group (L)--> 1-bit anomaly mask per group
  low  stream: low ``m`` bits of EVERY element        (fixed length)
  high stream: high ``n-m`` bits of anomalous groups  (rank-ordered,
               zero-padded to its static bound)
  raw  stream: sign|mantissa lanes                    (fixed length)

This module is the plain version on every device: the encoder runs here on
the card too (set-up work), and the decoder is the reference the CUDA
kernel ``csrc/enec_decode.cu`` is held against.  Bit work is done in
``int32`` (``int64`` for fp32 patterns), never in unsigned torch types.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import bitio, transform
from .dtypes import FloatFormat, combine_fields, split_fields, to_container
from .params import DEFAULT_BLOCK_ELEMS, EnecParams

# blocks encoded per pass: bounds the int32 intermediates of a large
# tensor (the 262M-element embed) to a few hundred MB each
ENCODE_CHUNK_BLOCKS = 2048


class BlockStreams(NamedTuple):
    """Static-shape per-block streams for one tensor (leading dims =
    blocks)."""
    mask: torch.Tensor      # (B, G/8)  uint8 — per-group anomaly bits
    low: torch.Tensor       # (B, packed(N, m)) uint8
    high: torch.Tensor      # (B, packed(N, n-m)) uint8 — rank-ordered
    high_len: torch.Tensor  # (B,) int32 — true high-stream length in BITS
    raw: torch.Tensor       # (B, packed(N, raw_bits)) uint8

    def map(self, fn) -> "BlockStreams":
        return BlockStreams(*(fn(a) for a in self))


def stream_shapes(n_elems: int, fmt: FloatFormat, p: EnecParams):
    """Static byte widths of each stream for an N-element block."""
    return {
        "mask": n_elems // p.L // 8,
        "low": bitio.packed_nbytes(n_elems, p.m),
        "high": bitio.packed_nbytes(n_elems, p.n - p.m),
        "raw": bitio.packed_nbytes(n_elems, fmt.raw_bits),
    }


def _encode_chunk(bits, fmt: FloatFormat, p: EnecParams, b_vec):
    nblocks, n = bits.shape
    g = n // p.L
    exp, raw = split_fields(bits, fmt)
    y = transform.forward(exp.to(torch.int32), b_vec, p.n)     # (B, N)
    yg = y.reshape(nblocks, g, p.L)
    # §V-B: a group is anomalous iff any element has a bit at >= m
    anom = ((yg >> p.m) != 0).any(dim=2)                        # (B, G)
    mask = bitio.pack_bool_mask(anom)
    low = bitio.pack_fixed(y & ((1 << p.m) - 1), p.m)
    # rank-ordered dense scatter of the anomalous groups' high bits; the
    # other groups are all-zero rows written into the overflow row G
    anom_i = anom.to(torch.int32)
    rank = torch.cumsum(anom_i, dim=1, dtype=torch.int32) - anom_i
    target = torch.where(anom, rank, g).to(torch.int64)
    high_dense = torch.zeros((nblocks, g + 1, p.L), dtype=torch.int32,
                             device=bits.device)
    high_dense.scatter_(1, target[:, :, None].expand(-1, -1, p.L),
                        yg >> p.m)
    high = bitio.pack_fixed(high_dense[:, :g].reshape(nblocks, n), p.n - p.m)
    high_len = anom_i.sum(dim=1, dtype=torch.int32) * (p.L * (p.n - p.m))
    rawp = bitio.pack_fixed(raw, fmt.raw_bits)
    return BlockStreams(mask=mask, low=low, high=high, high_len=high_len,
                        raw=rawp)


def encode_blocks(bits: torch.Tensor, fmt: FloatFormat, p: EnecParams,
                  b_vec=None) -> BlockStreams:
    """bits: (B, N) unsigned bit values in ``fmt.work_dtype``.

    ``b_vec`` (a ``(B,)`` per-block tensor) overrides ``p.b``.  Large
    inputs are encoded in chunks of :data:`ENCODE_CHUNK_BLOCKS` blocks.
    """
    nblocks, n = bits.shape
    assert n % p.L == 0 and (n // p.L) % 8 == 0, (n, p.L)
    if b_vec is None:
        b_vec = torch.full((nblocks,), p.b, dtype=torch.int32,
                           device=bits.device)
    parts = [_encode_chunk(bits[s:s + ENCODE_CHUNK_BLOCKS], fmt, p,
                           b_vec[s:s + ENCODE_CHUNK_BLOCKS])
             for s in range(0, nblocks, ENCODE_CHUNK_BLOCKS)]
    if len(parts) == 1:
        return parts[0]
    return BlockStreams(*(torch.cat(f) for f in zip(*parts)))


def decode_blocks(streams: BlockStreams, n_elems: int, fmt: FloatFormat,
                  p: EnecParams, b_vec=None, l_vec=None) -> torch.Tensor:
    """Inverse of :func:`encode_blocks` -> (B, N) bits in the signed
    container ``fmt.bits_dtype`` (``.view(fmt.float_dtype)`` gives floats).

    ``b_vec`` / ``l_vec`` ((B,) tensors) override ``p.b`` / ``p.l`` per
    block, so tensors with different searched params decode together.
    """
    nblocks = streams.mask.shape[0]
    g = n_elems // p.L
    anom = bitio.unpack_bool_mask(streams.mask, g)             # (B, G)
    anom_i = anom.to(torch.int32)
    rank = torch.cumsum(anom_i, dim=1, dtype=torch.int32) - anom_i
    y_low = bitio.unpack_fixed(streams.low, n_elems, p.m)
    high_dense = bitio.unpack_fixed(streams.high, n_elems, p.n - p.m)
    high_dense = high_dense.reshape(nblocks, g, p.L)
    # reverse gather (paper Alg. 1 line 21): group g reads row rank[g]
    gathered = torch.gather(
        high_dense, 1, rank.to(torch.int64)[:, :, None].expand(-1, -1, p.L))
    gathered = torch.where(anom[:, :, None], gathered, 0)
    y = y_low | (gathered.reshape(nblocks, n_elems) << p.m)
    exp = transform.inverse(y, p.b if b_vec is None else b_vec, p.n,
                            p.l if l_vec is None else l_vec)
    raw = bitio.unpack_fixed(streams.raw, n_elems, fmt.raw_bits,
                             out_dtype=fmt.work_dtype)
    bits = combine_fields(exp.to(fmt.work_dtype) & 0xFFFF, raw, fmt)
    return to_container(bits, fmt)


def flatten_blocks(s: BlockStreams) -> BlockStreams:
    """Collapse every leading ``(L, [shards,] B)`` stream layout to one
    flat block axis (the layout the per-block decoder consumes).  The
    block count is explicit: the high stream has zero width when m == n."""
    nblocks = 1
    for d in s.mask.shape[:-1]:
        nblocks *= int(d)
    return BlockStreams(
        mask=s.mask.reshape(nblocks, s.mask.shape[-1]),
        low=s.low.reshape(nblocks, s.low.shape[-1]),
        high=s.high.reshape(nblocks, s.high.shape[-1]),
        high_len=s.high_len.reshape(nblocks),
        raw=s.raw.reshape(nblocks, s.raw.shape[-1]))


# ---------------------------------------------------------------------------
# whole-array helpers (flatten / pad / reshape to blocks)
# ---------------------------------------------------------------------------

def pad_count(size: int, block_elems: int = DEFAULT_BLOCK_ELEMS) -> int:
    return (-size) % block_elems


def to_blocks(bits: torch.Tensor, block_elems: int = DEFAULT_BLOCK_ELEMS):
    """Flat bit values -> (B, N) with zero padding."""
    flat = bits.reshape(-1)
    return F.pad(flat, (0, pad_count(flat.numel(), block_elems))).reshape(
        -1, block_elems)


def stacked_blocks(bits2d: torch.Tensor,
                   block_elems: int = DEFAULT_BLOCK_ELEMS,
                   shards: int = 1, pad_value: int = 0):
    """(L, per) bit values of a layer stack -> ((L*Bs, N) blocks, Bs).

    Row ``l*Bs + b`` is block ``b`` of layer ``l``; each layer is padded to
    the block size and (``shards > 1``) to a block count divisible by
    ``shards``.  ``pad_value`` is the modal exponent's bit pattern
    (``b << mant_bits``), so padding costs no high-stream bits.
    """
    n_layers, per = bits2d.shape
    nblocks = (per + block_elems - 1) // block_elems
    if shards > 1:
        nblocks += (-nblocks) % shards
    total_pad = nblocks * block_elems - per
    if total_pad:
        bits2d = F.pad(bits2d, (0, total_pad), value=pad_value)
    return bits2d.reshape(n_layers * nblocks, block_elems), nblocks


def from_blocks(bits: torch.Tensor, shape, fmt: FloatFormat) -> torch.Tensor:
    """(B, N) decoded bit containers -> the float tensor of ``shape``."""
    size = 1
    for s in shape:
        size *= s
    return bits.reshape(-1)[:size].view(fmt.float_dtype).reshape(shape)
