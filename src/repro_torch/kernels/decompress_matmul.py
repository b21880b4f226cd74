"""Fused ENEC decode + matmul: the CUDA kernel ``csrc/decompress_matmul.cu``
(fused entry and dense-tile entry) and their plain versions (counterpart
of ``repro/kernels/decompress_matmul.py``).

Both entries realise the canonical contraction of ``ref.tiled_matmul_ref``:
128x128 weight tiles, one f32 partial product per tile added in k order.
On the card the fused entry decodes each tile from its ENEC block; the
dense-tile entry loads it from a dense weight.  They share the
accumulation code, so their results are bitwise equal.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import codec
from repro_torch.core.api import MATMUL_TILE, CompressedTensor

from . import build
from .ref import decompress_matmul_ref as decompress_matmul_plain  # noqa
from .ref import tiled_matmul_ref as dense_matmul_plain  # noqa: F401

TILE = MATMUL_TILE
FUSED_LAUNCHES = build.LaunchCounter()
DENSE_LAUNCHES = build.LaunchCounter()

_c = ctypes
_FUSED_ARGTYPES = ([_c.c_void_p, _c.c_int] + [_c.c_void_p] * 4
                   + [_c.c_int] * 11 + [_c.c_void_p] + [_c.c_int] * 3
                   + [_c.c_void_p])
_DENSE_ARGTYPES = ([_c.c_void_p, _c.c_int, _c.c_void_p, _c.c_int,
                    _c.c_longlong, _c.c_longlong, _c.c_void_p]
                   + [_c.c_int] * 3 + [_c.c_void_p])
_W_FMT = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def _fn(name: str, argtypes):
    fn = getattr(build.load("decompress_matmul"), name)
    fn.argtypes, fn.restype = argtypes, _c.c_int
    return fn


def _check_x(x: torch.Tensor, k: int):
    if x.device.type != "cuda":
        raise ValueError(f"the matmul kernel needs CUDA tensors, got "
                         f"{x.device}")
    if x.ndim != 2 or x.shape[1] != k or not x.is_contiguous() \
            or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be a contiguous bf16/f32 (M, {k}) tensor; "
                         f"got {x.dtype} {tuple(x.shape)}")


def decompress_matmul_cuda(x: torch.Tensor, ct: CompressedTensor, k: int,
                           n: int) -> torch.Tensor:
    """out (M, n) f32 = x (M, k) @ W, W held only as ENEC tile streams
    (one layer; a TP-sharded ``(S, B/S, ...)`` layout is flattened, which
    restores the n-major tile order)."""
    _check_x(x, k)
    if ct.mode != "enec":
        raise ValueError("the fused kernel requires enec tile streams")
    s = ct.streams
    if s.mask.ndim != (3 if ct.shards > 1 else 2):
        raise ValueError("stacked streams: slice one layer first")
    s = codec.flatten_blocks(s)
    tiles = (-(-k // TILE)) * (-(-n // TILE))
    widths = codec.stream_shapes(TILE * TILE, ct.fmt, ct.params)
    for name in ("mask", "low", "high", "raw"):
        t = getattr(s, name)
        if t.device != x.device or t.dtype != torch.uint8 \
                or tuple(t.shape) != (tiles, widths[name]) \
                or not t.is_contiguous():
            raise ValueError(f"{name} stream must be contiguous uint8 "
                             f"({tiles}, {widths[name]}) on {x.device}")
    out = torch.empty((x.shape[0], n), dtype=torch.float32, device=x.device)
    p, fmt = ct.params, ct.fmt
    high = s.high if widths["high"] else s.mask
    err = _fn("decompress_matmul_launch", _FUSED_ARGTYPES)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), s.mask.data_ptr(),
        s.low.data_ptr(), high.data_ptr(), s.raw.data_ptr(), p.b, p.l, p.L,
        p.n, p.m, fmt.total_bits, fmt.mant_bits, widths["mask"],
        widths["low"], widths["high"], widths["raw"], out.data_ptr(),
        x.shape[0], k, n, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "decompress_matmul")
    FUSED_LAUNCHES.n += 1
    return out


def dense_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The dense-tile entry: out (M, N) f32 = x (M, K) @ w (K, N), any
    strides of ``w``, in the fused entry's exact schedule."""
    k, n = w.shape
    _check_x(x, k)
    if w.device != x.device or w.dtype not in _W_FMT:
        raise ValueError(f"w must be a bf16/fp16/f32 tensor on {x.device}; "
                         f"got {w.dtype} on {w.device}")
    out = torch.empty((x.shape[0], n), dtype=torch.float32, device=x.device)
    err = _fn("dense_tile_matmul_launch", _DENSE_ARGTYPES)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        _W_FMT[w.dtype], w.stride(0), w.stride(1), out.data_ptr(),
        x.shape[0], k, n, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dense_tile_matmul")
    DENSE_LAUNCHES.n += 1
    return out
