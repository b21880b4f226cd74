"""ENEC block decoder: the CUDA kernel ``csrc/enec_decode.cu`` and its plain
version (counterpart of ``repro/kernels/enec_decode.py``).

:func:`decode_blocks_cuda` launches the kernel on CUDA tensors and raises on
anything else; :func:`decode_blocks_plain` is the plain PyTorch version the
CPU path runs and the kernel is held against.  ``kernels/ops.py`` routes a
call by the streams' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import codec
from repro_torch.core.dtypes import FloatFormat
from repro_torch.core.params import EnecParams

from . import build
from .ref import decode_blocks_ref as decode_blocks_plain  # noqa: F401

LAUNCHES = build.LaunchCounter()

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


def _fn():
    fn = build.load("enec_decode").enec_decode_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check_stream(t: torch.Tensor, name: str, rows: int, width: int, dev):
    if t.device != dev or t.dtype != torch.uint8 or t.ndim != 2 \
            or not t.is_contiguous() or tuple(t.shape) != (rows, width):
        raise ValueError(
            f"{name} stream must be a contiguous uint8 ({rows}, {width}) "
            f"tensor on {dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def decode_blocks_cuda(streams: codec.BlockStreams, n_elems: int,
                       fmt: FloatFormat, p: EnecParams,
                       b_vec: torch.Tensor, l_vec: torch.Tensor
                       ) -> torch.Tensor:
    """Decode flat ``(B, ...)`` streams on the card -> (B, N) bits in
    ``fmt.bits_dtype``.  ``b_vec``/``l_vec``: (B,) int32 per-block
    inverse-map parameters."""
    dev = streams.mask.device
    if dev.type != "cuda":
        raise ValueError(f"decode_blocks_cuda needs CUDA tensors, got {dev}")
    nblocks = streams.mask.shape[0]
    widths = codec.stream_shapes(n_elems, fmt, p)
    for name in ("mask", "low", "high", "raw"):
        _check_stream(getattr(streams, name), name, nblocks, widths[name],
                      dev)
    for name, v in (("b_vec", b_vec), ("l_vec", l_vec)):
        if v.device != dev or v.dtype != torch.int32 \
                or tuple(v.shape) != (nblocks,) or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 "
                             f"({nblocks},) tensor on {dev}")
    out = torch.empty((nblocks, n_elems), dtype=fmt.bits_dtype, device=dev)
    high = streams.high if widths["high"] else streams.mask
    err = _fn()(streams.mask.data_ptr(), streams.low.data_ptr(),
                high.data_ptr(), streams.raw.data_ptr(), b_vec.data_ptr(),
                l_vec.data_ptr(), out.data_ptr(), nblocks, n_elems, p.L,
                p.n, p.m, fmt.total_bits, fmt.mant_bits, widths["mask"],
                widths["low"], widths["high"], widths["raw"],
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "enec_decode")
    LAUNCHES.n += 1
    return out
