"""The kernels' cost route on ``meta`` tensors: shape propagation and an
analytic cost record for the dry-run (``launch/dryrun.py``).

``kernels/ops.py`` sends a ``meta`` input here, as it sends a CPU input to
the plain version and a CUDA input to the kernel.  Each function returns
empty ``meta`` outputs of the kernel's exact shapes and dtypes and adds
what the card's kernel would do to :data:`RECORD`, by the name of its
launch counter (``build.LaunchCounter``):

  launches  one a call, as the wrapper counts one on the card (inside
            :func:`repeated`, the steps of a time loop that ran once);
  flops     the matmul kernels' 2 M K N (kernel 2 and 2'), the decode
            attention's 4 B KV grp S 128 (its two products); 0 for the
            codec kernels and the scan (integer work);
  bytes     each input and output once, every stream at its static width
            (the kernel table's bound: a kernel reads each operand and
            stream byte once and writes each output once; kernel 1 and 5
            read only a block's ``high_len`` bits of the high stream, which
            ``meta`` does not know, so this is their upper bound).

Nothing here reaches the plain version or the card, and no kernel source
is involved: a ``meta`` input holds no data to compute on.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.codec import BlockStreams, stream_shapes

# name -> {"launches", "flops", "bytes"}, summed over the calls since the
# last reset()
RECORD: dict = {}
_REPEAT = [1]    # launches a call stands for (the innermost repeated())


def reset() -> None:
    RECORD.clear()


def snapshot() -> dict:
    """A copy of the record, by kernel name."""
    return {name: dict(v) for name, v in RECORD.items()}


@contextlib.contextmanager
def repeated(n: int):
    """Inside the block each call counts ``n`` launches (its FLOPs and
    bytes once): the one step a recurrent time loop runs on ``meta`` stands
    for the ``n`` steps whose kernels the card launches
    (``models/layers.py:scan_steps``)."""
    _REPEAT.append(_REPEAT[-1] * int(n))
    try:
        yield
    finally:
        _REPEAT.pop()


def repeat_factor() -> int:
    """The launches a call counts here (1 outside :func:`repeated`)."""
    return _REPEAT[-1]


def is_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _add(name: str, flops: int, nbytes: int) -> None:
    r = RECORD.setdefault(name, {"launches": 0, "flops": 0, "bytes": 0})
    r["launches"] += _REPEAT[-1]
    r["flops"] += int(flops)
    r["bytes"] += int(nbytes)


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def encode_blocks(bits: torch.Tensor, fmt, p, b_vec=None) -> BlockStreams:
    """Kernel 4: (B, N) bits -> the flat streams of B blocks."""
    nblocks, n_elems = bits.shape
    widths = stream_shapes(n_elems, fmt, p)
    out = BlockStreams(
        mask=_empty((nblocks, widths["mask"]), torch.uint8),
        low=_empty((nblocks, widths["low"]), torch.uint8),
        high=_empty((nblocks, widths["high"]), torch.uint8),
        high_len=_empty((nblocks,), torch.int32),
        raw=_empty((nblocks, widths["raw"]), torch.uint8))
    _add("enec_encode", 0, nblocks * n_elems * fmt.bits_dtype.itemsize
         + 4 * nblocks + _nbytes(*out))
    return out


def decode_blocks(streams: BlockStreams, n_elems: int, fmt,
                  out=None) -> torch.Tensor:
    """Kernel 1: flat streams -> (B, N) bit containers (``out`` when
    given); the per-block b and l vectors are read too."""
    nblocks = streams.mask.shape[0]
    if out is None:
        out = _empty((nblocks, n_elems), fmt.bits_dtype)
    _add("enec_decode", 0, _nbytes(*streams) + 8 * nblocks
         + nblocks * n_elems * fmt.bits_dtype.itemsize)
    return out


def _split_workspace(m: int, k: int, n: int) -> None:
    """Kernel 2's split-K workspace, made and freed as on the card (its
    bytes count in the dry-run's peak, not in the kernel's traffic: the
    partials stay in L2 on a decode batch)."""
    from .decompress_matmul import plan
    pl = plan(m, k, n)
    if pl.split:
        _empty((pl.ws_floats,), torch.float32)


def decompress_matmul(x: torch.Tensor, ct, k: int, n: int) -> torch.Tensor:
    """Kernel 2 (fused): out (M, n) f32 = x (M, k) @ W, W read once as its
    tile streams."""
    m = x.shape[0]
    _split_workspace(m, k, n)
    out = _empty((m, n), torch.float32)
    _add("decompress_matmul", 2 * m * k * n,
         _nbytes(x, out, *ct.streams))
    return out


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel 2' (dense-tile): out (M, N) f32 = x (M, K) @ w (K, N)."""
    m, (k, n) = x.shape[0], w.shape
    _split_workspace(m, k, n)
    out = _empty((m, n), torch.float32)
    _add("dense_tile_matmul", 2 * m * k * n, _nbytes(x, w, out))
    return out


def idd_scan(x: torch.Tensor) -> torch.Tensor:
    """Kernel 3: (B, N) -> (B, N) int32 inclusive prefix sums."""
    out = _empty(tuple(x.shape), torch.int32)
    _add("idd_scan", 0, _nbytes(x, out))
    return out


def decode_attention_kv(q: torch.Tensor, k_streams: BlockStreams,
                        v_streams: BlockStreams) -> torch.Tensor:
    """Kernel 5: q (B, KV, grp, 128) over the K/V prefix of C blocks of
    128 tokens -> (B, KV, grp, 128) f32; two products of 2 x 128 a token
    and query head."""
    b, n_kv, grp, hd = q.shape
    tokens = k_streams.mask.shape[2] * 128
    out = _empty(tuple(q.shape), torch.float32)
    _add("decode_attention_kv", 4 * b * n_kv * grp * tokens * hd,
         _nbytes(q, out, *k_streams, *v_streams))
    return out
