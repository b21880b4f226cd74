"""Hierarchical halving bit-packing (paper §V-B, Alg. 2), port of
``repro/core/bitio.py`` with the same byte layout.

Layout of ``pack_fixed(vals, width)`` for N lanes (N a power of two):
whole byte planes first (plane ``k`` holds byte ``k`` of every lane), then
the sub-byte residue ``a = width % 8`` folded: lane ``i`` is OR-ed with
lane ``i + len/2`` shifted by the current width until the width crosses 8
bits; the low byte of every lane is emitted and the overflow recurses with
width ``W - 8`` over the shorter lane count.

The reference replays that fold step by step.  A GPU thread decoding one
element cannot, so this module writes the fold once in closed form:
:func:`piece_map` gives, for every element ``i``, each piece of its bits as
``(byte offset, bit shift, bit count, destination shift)``.  After ``F``
folds of a level with ``len = N / 2**F`` lanes, element ``i`` sits in lane
``j = i % len`` at bit ``a * bitrev_F(i // len)``; the part below bit 8 is
in byte ``base + j``, the rest is bits of element ``j`` of the next level.
Both :func:`pack_fixed` and :func:`unpack_fixed` here, and the CUDA decoder
(``csrc/enec_block.cuh``, ``unpack_elem``), use this map.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["pack_fixed", "unpack_fixed", "packed_nbytes", "piece_map",
           "pack_bool_mask", "unpack_bool_mask", "pack_straight",
           "unpack_straight", "exact_from_straight", "straight_from_exact"]


def fold_plan(a: int, n: int):
    """Alg. 2's fold loop for sub-width ``a`` over ``n`` lanes:
    (width, lane count, folds) at the emit point."""
    width, length, folds = a, n, 0
    while width < 8 and length > 1:
        width *= 2
        length //= 2
        folds += 1
    return width, length, folds


def _bitrev(q: np.ndarray, bits: int) -> np.ndarray:
    r = np.zeros_like(q)
    for _ in range(bits):
        r = (r << 1) | (q & 1)
        q = q >> 1
    return r


def _halving_nbytes(a: int, n: int) -> int:
    width, length, _ = fold_plan(a, n)
    if width < 8:
        return 1
    total = length
    if width - 8:
        total += _halving_nbytes(width - 8, length)
    return total


def packed_nbytes(n: int, width: int) -> int:
    """Exact byte length of ``pack_fixed`` output for N lanes of ``width``
    bits."""
    if width == 0:
        return 0
    total = (width // 8) * n
    if width % 8:
        total += _halving_nbytes(width % 8, n)
    return total


@functools.lru_cache(maxsize=None)
def piece_map(width: int, n: int):
    """Closed-form layout of ``pack_fixed``: four ``(P, n)`` int64 arrays
    ``(offset, shift, nbits, dst)``.  Bits ``[dst, dst + nbits)`` of
    element ``i`` are bits ``[shift, shift + nbits)`` of stream byte
    ``offset``; pieces with ``nbits == 0`` are padding."""
    assert n & (n - 1) == 0, f"lane count must be a power of two, got {n}"
    i = np.arange(n, dtype=np.int64)
    zero = np.zeros(n, np.int64)
    pieces = [(k * n + i, zero, zero + 8, zero + 8 * k)
              for k in range(width // 8)]
    a = width % 8
    base, elem, lo, cnt = (width // 8) * n, i, zero, zero + a
    dst, length = zero + 8 * (width // 8), n
    while cnt.any():
        w, sub, folds = fold_plan(a, length)
        j = elem % sub
        pos = a * _bitrev(elem // sub, folds) + lo
        hi = pos + cnt
        take = np.clip(np.minimum(hi, 8) - pos, 0, None)
        pieces.append((base + j, np.where(take > 0, pos, 0), take,
                       np.where(take > 0, dst, 0)))
        dst = dst + take
        lo = np.maximum(pos, 8) - 8
        cnt = np.where(hi > 8, hi - 8 - lo, 0)
        elem, base, a, length = j, base + sub, w - 8, sub
    return tuple(np.stack(f) for f in zip(*pieces))


@functools.lru_cache(maxsize=64)
def _piece_tensors(width: int, n: int, device: str):
    offs, shifts, nbits, dsts = piece_map(width, n)
    small = (torch.as_tensor(f, dtype=torch.int32, device=device)
             for f in (shifts, nbits, dsts))
    return (torch.as_tensor(offs, device=device), *small)


def pack_fixed(vals: torch.Tensor, width: int) -> torch.Tensor:
    """Pack (..., N) non-negative integer lanes of ``width`` significant
    bits into uint8 (..., packed_nbytes(N, width)).  Each byte's pieces
    come from distinct bit fields, so their sum is their OR."""
    n = vals.shape[-1]
    out = torch.zeros(vals.shape[:-1] + (packed_nbytes(n, width),),
                      dtype=torch.int32, device=vals.device)
    if width == 0:
        return out.to(torch.uint8)
    offs, shifts, nbits, dsts = _piece_tensors(width, n, str(vals.device))
    for p in range(offs.shape[0]):
        part = ((vals >> dsts[p]) & ((1 << nbits[p]) - 1)) << shifts[p]
        out.index_add_(-1, offs[p], part.to(torch.int32))
    return out.to(torch.uint8)


def unpack_fixed(stream: torch.Tensor, n: int, width: int,
                 out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Inverse of :func:`pack_fixed`: (..., packed_nbytes(n, width)) uint8
    -> (..., n) ``out_dtype`` (a signed type wide enough for ``width``)."""
    out = torch.zeros(stream.shape[:-1] + (n,), dtype=out_dtype,
                      device=stream.device)
    if width == 0:
        return out
    offs, shifts, nbits, dsts = _piece_tensors(width, n, str(stream.device))
    for p in range(offs.shape[0]):
        byte = stream.index_select(-1, offs[p]).to(out_dtype)
        out |= ((byte >> shifts[p]) & ((1 << nbits[p]) - 1)) << dsts[p]
    return out


_BIT_WEIGHTS = tuple(1 << k for k in range(8))


def pack_bool_mask(bits: torch.Tensor) -> torch.Tensor:
    """(..., G) bool -> (..., G//8) uint8, G multiple of 8, little-endian."""
    g = bits.shape[-1]
    assert g % 8 == 0
    b = bits.to(torch.int32).reshape(bits.shape[:-1] + (g // 8, 8))
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=bits.device)
    return (b * w).sum(-1).to(torch.uint8)


def unpack_bool_mask(bytes_: torch.Tensor, g: int) -> torch.Tensor:
    """Inverse of :func:`pack_bool_mask` -> (..., G) bool."""
    shifts = torch.arange(8, dtype=torch.int32, device=bytes_.device)
    bits = (bytes_.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(bytes_.shape[:-1] + (g,)).bool()


# ---------------------------------------------------------------------------
# exact bit streams (the wire form of the variable-length high stream)
# ---------------------------------------------------------------------------
#
# The wire stores each block's high stream as a straight little-endian bit
# concatenation of its ``count`` rank-ordered values, byte-padded per block
# (``repro/core/bitio.py:np_pack_bits_exact``).  The reference loops over
# blocks on the host with ``np.bitwise_or.at``.  Here the straight packing
# of all N lanes of every block is one tensor operation on the streams'
# device (:func:`pack_straight`; lanes past ``count`` are zero, so a block's
# exact bytes are a prefix of its straight row).  On a save the streams'
# device selects every block's prefix at once (:func:`exact_from_straight`)
# and only the exact bytes cross to the host; on a
# load the exact bytes go to the device as they are and are scattered
# into rows there (:func:`straight_from_exact`).

STRAIGHT_CHUNK_BLOCKS = 2048     # bounds the (B, N, width) bit intermediates


def straight_nbytes(n: int, width: int) -> int:
    return (n * width + 7) // 8


def pack_straight(vals: torch.Tensor, width: int) -> torch.Tensor:
    """(B, N) non-negative lanes of ``width`` bits -> (B, ceil(N*width/8))
    uint8, each row the straight little-endian concatenation of its
    lanes."""
    nblocks, n = vals.shape
    out = torch.zeros((nblocks, straight_nbytes(n, width)), dtype=torch.uint8,
                      device=vals.device)
    if width == 0:
        return out
    shifts = torch.arange(width, dtype=torch.int32, device=vals.device)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32,
                           device=vals.device)
    pad = (-n * width) % 8
    for s in range(0, nblocks, STRAIGHT_CHUNK_BLOCKS):
        v = vals[s:s + STRAIGHT_CHUNK_BLOCKS].to(torch.int32)
        bits = ((v[..., None] >> shifts) & 1).reshape(v.shape[0], -1)
        if pad:
            bits = torch.nn.functional.pad(bits, (0, pad))
        out[s:s + v.shape[0]] = (bits.reshape(v.shape[0], -1, 8)
                                 * weights).sum(-1).to(torch.uint8)
    return out


def unpack_straight(stream: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """Inverse of :func:`pack_straight` -> (B, n) int32."""
    nblocks = stream.shape[0]
    out = torch.zeros((nblocks, n), dtype=torch.int32, device=stream.device)
    if width == 0:
        return out
    shifts = torch.arange(8, dtype=torch.int32, device=stream.device)
    weights = torch.arange(width, dtype=torch.int32, device=stream.device)
    for s in range(0, nblocks, STRAIGHT_CHUNK_BLOCKS):
        row = stream[s:s + STRAIGHT_CHUNK_BLOCKS].to(torch.int32)
        bits = ((row[..., None] >> shifts) & 1).reshape(row.shape[0], -1)
        bits = bits[:, :n * width].reshape(row.shape[0], n, width)
        out[s:s + row.shape[0]] = (bits << weights).sum(-1, dtype=torch.int32)
    return out


def exact_from_straight(straight, nbytes) -> bytes:
    """Concatenate the first ``nbytes[b]`` bytes of every row ``b`` of a
    (B, W) array (each block's exact high stream): a host array, or a
    tensor on any device, which selects the bytes before the (smaller)
    copy to the host."""
    if isinstance(straight, torch.Tensor):
        dev = straight.device
        nbytes = torch.as_tensor(nbytes, device=dev)
        keep = torch.arange(straight.shape[1], device=dev)[None, :] \
            < nbytes[:, None]
        return straight[keep].cpu().numpy().tobytes()
    keep = np.arange(straight.shape[1])[None, :] < nbytes[:, None]
    return straight[keep].tobytes()


def straight_from_exact(exact: torch.Tensor, nbytes: torch.Tensor,
                        width_bytes: int) -> torch.Tensor:
    """Inverse of :func:`exact_from_straight`, on ``exact``'s device: the
    per-block exact byte runs (concatenated, ``nbytes[b]`` each; both 1-D
    tensors on one device) -> zero-padded (B, width_bytes) uint8."""
    dev = exact.device
    out = torch.zeros((nbytes.shape[0], width_bytes), dtype=torch.uint8,
                      device=dev)
    if not width_bytes or not exact.numel():
        return out
    cols = torch.arange(width_bytes, device=dev)[None, :]
    nbytes = nbytes.to(torch.int64)
    # source offset of each chunk of rows: one small transfer to the host
    ends = [0] + torch.cumsum(nbytes, 0)[STRAIGHT_CHUNK_BLOCKS - 1::
                                         STRAIGHT_CHUNK_BLOCKS].tolist()
    for k, s in enumerate(range(0, nbytes.shape[0], STRAIGHT_CHUNK_BLOCKS)):
        rows = out[s:s + STRAIGHT_CHUNK_BLOCKS]
        end = ends[k + 1] if k + 1 < len(ends) else exact.numel()
        rows.masked_scatter_(cols < nbytes[s:s + rows.shape[0], None],
                             exact[ends[k]:end])
    return out
