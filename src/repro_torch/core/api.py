"""ENEC data model (port of ``repro/core/api.py``): ``CompressedTensor``
with exact wire accounting, the fused-matmul tile layout, the const / raw
escapes, the tree walk of the codec's tree-level API and the stateless
wire-size utilities (:func:`tree_ratio`, :func:`precompute_wire_bytes`,
:func:`abstract_compressed`).  The codec pipeline itself lives on
:class:`repro_torch.core.codec_api.Codec`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import codec
from .codec import BlockStreams
from .dtypes import DTYPE_NAMES, FORMATS, FloatFormat, format_for, to_container
from .params import DEFAULT_BLOCK_ELEMS, EnecParams

# enec-v2 framed-record overhead, byte for byte the reference's
# ``core/wire.py:record_overhead_bytes``: frame header ("<IHHQI" = 20) +
# magic/mode/fmt/stack (8) + ndim (4) + dtype tag (8) + block_elems/shards
# (8) + 8 per shape dim; enec records add params ("<5i" = 20) + nblocks (4)
FRAME_HEADER_BYTES = 20
_RECORD_COMMON_BYTES = 8 + 4 + 8 + 8
_RECORD_PARAMS_BYTES = 20 + 4

SUPPORTED_FLOAT_DTYPES = tuple(DTYPE_NAMES)


def record_overhead_bytes(mode: str, ndim: int) -> int:
    base = FRAME_HEADER_BYTES + _RECORD_COMMON_BYTES + 8 * ndim
    return base + (_RECORD_PARAMS_BYTES if mode == "enec" else 0)


def dtype_from_str(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass
class CompressedTensor:
    """ENEC-compressed view of one tensor.

    mode == "enec": ``streams`` carries the block streams, with a leading
    ``shards`` dim when ``shards > 1``; a stacked tensor carries one more
    leading ``(L,)`` dim while the metadata describes one layer.
    mode == "raw" / "const": ``raw_bytes`` holds the buffer / one value.
    """
    streams: Optional[BlockStreams]
    raw_bytes: Optional[torch.Tensor]
    fmt_name: str
    params: Optional[EnecParams]
    shape: tuple
    dtype_str: str
    block_elems: int
    shards: int
    mode: str

    def __post_init__(self):
        self._wire_bytes = None

    @property
    def fmt(self) -> FloatFormat:
        return FORMATS[self.fmt_name]

    @property
    def itemsize(self) -> int:
        return dtype_from_str(self.dtype_str).itemsize

    def nbytes_device(self) -> int:
        """Bytes of the padded device layout."""
        arrays = self.streams if self.mode == "enec" else (self.raw_bytes,)
        return sum(a.numel() * a.element_size() for a in arrays)

    def nbytes_wire(self) -> int:
        """Exact size of the framed enec-v2 record (same arithmetic as the
        reference; the high stream is byte-padded per block)."""
        overhead = record_overhead_bytes(self.mode, len(self.shape))
        if self.mode == "const":
            return self.itemsize + overhead
        if self.mode == "raw":
            return int(np.prod(self.shape)) * self.itemsize + overhead
        if self._wire_bytes is None:
            self._set_wire_bytes(self.streams.high_len.cpu())
        return self._wire_bytes

    def _set_wire_bytes(self, high_len_bits) -> int:
        """Fill the wire-size cache from a host copy of the per-block
        ``high_len`` vector (bits), so that ``nbytes_wire`` needs no device
        sync after an encode or a ``from_wire``.  The wire byte-pads the
        high stream per block, hence the vector and not its sum."""
        s = self.streams
        hl = np.asarray(high_len_bits, np.int64).reshape(-1)
        # per block: its mask, low and raw rows (a rank's slice of a placed
        # tensor passes the whole record's high_len)
        fixed = hl.size * (s.mask.shape[-1] + s.low.shape[-1]
                           + s.raw.shape[-1])
        overhead = record_overhead_bytes(self.mode, len(self.shape))
        self._wire_bytes = (fixed + int(((hl + 7) // 8).sum())
                            + 4 * hl.size + overhead)
        return self._wire_bytes

    def nbytes_raw(self) -> int:
        return int(np.prod(self.shape)) * self.itemsize

    def ratio(self) -> float:
        return self.nbytes_raw() / max(self.nbytes_wire(), 1)


def raw_tensor(x: torch.Tensor, shards: int) -> CompressedTensor:
    """Raw escape: the tensor's bytes, stored as they are."""
    return CompressedTensor(
        streams=None, raw_bytes=x.reshape(-1).view(torch.uint8),
        fmt_name="bf16", params=None, shape=tuple(x.shape),
        dtype_str=DTYPE_NAMES.get(x.dtype, str(x.dtype).split(".")[-1]),
        block_elems=0, shards=shards, mode="raw")


def const_tensor(first_bits: int, x: torch.Tensor, fmt: FloatFormat,
                 block_elems: int, shards: int) -> CompressedTensor:
    """Const escape: one repeated bit pattern, stored once."""
    value = torch.tensor([first_bits], dtype=fmt.work_dtype)
    buf = to_container(value, fmt).view(torch.uint8).to(x.device)
    return CompressedTensor(
        streams=None, raw_bytes=buf, fmt_name=fmt.name, params=None,
        shape=tuple(x.shape), dtype_str=DTYPE_NAMES[x.dtype],
        block_elems=block_elems, shards=shards, mode="const")


def slice_stacked(ct: CompressedTensor, index: int) -> CompressedTensor:
    """Layer ``index`` of a stacked tensor as a standalone tensor."""
    return dataclasses.replace(ct, streams=ct.streams.map(lambda a: a[index]))


# ---------------------------------------------------------------------------
# tile layout for the fused decompress+matmul kernel
# ---------------------------------------------------------------------------

MATMUL_TILE = 128
# one 128x128 weight tile holds exactly one 16,384-element ENEC block
assert MATMUL_TILE * MATMUL_TILE == DEFAULT_BLOCK_ELEMS


def _padded(k: int, n: int):
    t = MATMUL_TILE
    return -(-k // t) * t, -(-n // t) * t


def matmul_tiles(w: torch.Tensor) -> torch.Tensor:
    """(L, K, N) or (K, N) weight -> (L, n_tiles * k_tiles * TILE*TILE).

    Tile ``t = n_tile * k_tiles + k_tile`` of layer ``l`` is stored
    row-major at block ``(l, t)``; ragged K/N are zero-padded (zeros, so
    the padded products vanish exactly).
    """
    t = MATMUL_TILE
    if w.ndim == 2:
        w = w[None]
    n_layers, k, n = w.shape
    kp, np_ = _padded(k, n)
    if (kp, np_) != (k, n):
        w = F.pad(w, (0, np_ - n, 0, kp - k))
    tiles = w.reshape(n_layers, kp // t, t, np_ // t, t)
    return tiles.permute(0, 3, 1, 2, 4).reshape(n_layers, -1)


def untile_matmul_weight(flat: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Inverse of :func:`matmul_tiles` for one layer: flat tiles ->
    (k, n) with the padding stripped."""
    t = MATMUL_TILE
    kp, np_ = _padded(k, n)
    tiles = flat.reshape(np_ // t, kp // t, t, t)
    return tiles.permute(1, 2, 0, 3).reshape(kp, np_)[:k, :n]


# ---------------------------------------------------------------------------
# trees: nested dicts / lists / tuples / NamedTuples, walked in the
# reference's flatten order (dict keys sorted, sequence items and a
# NamedTuple's fields in order); a NamedTuple's children are named by
# field, as ``jax.tree_util.tree_flatten_with_path`` names them ("opt/step",
# "opt/m/..."); anything else (a tensor, a handle, a CompressedTensor,
# None) is a leaf
# ---------------------------------------------------------------------------

def _children(tree):
    """(name, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in sorted(tree.items())]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def tree_leaves(tree, path: str = ""):
    """(path, leaf) pairs of a nested dict/list tree, handles as leaves,
    dict keys in sorted order: the reference's flatten order (the codec's
    plan slots, and the flatten slots of ``runtime/weights.py:resolve``'s
    ``prefetched``)."""
    children = _children(tree)
    if children is None:
        yield path, tree
        return
    for k, v in children:
        yield from tree_leaves(v, f"{path}/{k}" if path else k)


def tree_map_with_path(fn, tree, path: str = ""):
    """Rebuild ``tree`` with ``fn(path, leaf)`` at every leaf, visited in
    :func:`tree_leaves` order."""
    children = _children(tree)
    if children is None:
        return fn(path, tree)
    out = [tree_map_with_path(fn, v, f"{path}/{k}" if path else k)
           for k, v in children]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), out))
    if hasattr(tree, "_fields"):
        return type(tree)(*out)
    return type(tree)(out)


# ---------------------------------------------------------------------------
# wire-size utilities (stateless: no codec needed)
# ---------------------------------------------------------------------------

def precompute_wire_bytes(cts: Sequence[CompressedTensor]) -> None:
    """Fill the ``nbytes_wire`` cache of many tensors with ONE device-to-
    host transfer of their ``high_len`` vectors (each ``nbytes_wire`` call
    would otherwise fetch its own)."""
    pending = [c for c in cts if c.mode == "enec" and c._wire_bytes is None]
    if not pending:
        return
    host = torch.cat([c.streams.high_len.reshape(-1)
                      for c in pending]).cpu().numpy()
    off = 0
    for c in pending:
        n = c.streams.high_len.numel()
        c._set_wire_bytes(host[off:off + n])
        off += n


def tree_ratio(ctree) -> dict:
    """Compression accounting over a tree of compressed tensors (at most
    one host transfer for the whole tree)."""
    cts = [c for _, c in tree_leaves(ctree) if isinstance(c, CompressedTensor)]
    precompute_wire_bytes(cts)
    raw = sum(c.nbytes_raw() for c in cts)
    wire = sum(c.nbytes_wire() for c in cts)
    return {"tensors": len(cts), "raw_bytes": raw, "compressed_bytes": wire,
            "ratio": raw / max(wire, 1)}


def abstract_compressed(shape, dtype: torch.dtype, p: EnecParams,
                        block_elems: int = DEFAULT_BLOCK_ELEMS,
                        shards: int = 1) -> CompressedTensor:
    """A CompressedTensor of ``meta`` tensors (nothing allocated) with the
    layout :meth:`Codec.compress_array` would give a tensor of ``shape``
    and ``dtype`` under ``p``."""
    fmt = format_for(dtype)
    size = 1
    for s in shape:
        size *= s
    nblocks = (size + block_elems - 1) // block_elems
    nblocks += (-nblocks) % shards
    widths = codec.stream_shapes(block_elems, fmt, p)
    lead = (shards, nblocks // shards) if shards > 1 else (nblocks,)

    def meta(shape_, dt=torch.uint8):
        return torch.empty(shape_, dtype=dt, device="meta")

    streams = BlockStreams(
        mask=meta(lead + (widths["mask"],)),
        low=meta(lead + (widths["low"],)),
        high=meta(lead + (widths["high"],)),
        high_len=meta(lead, torch.int32),
        raw=meta(lead + (widths["raw"],)))
    return CompressedTensor(
        streams=streams, raw_bytes=None, fmt_name=fmt.name, params=p,
        shape=tuple(shape), dtype_str=DTYPE_NAMES[dtype],
        block_elems=block_elems, shards=shards, mode="enec")
