"""ENEC block encoder: the CUDA kernel ``csrc/enec_encode.cu`` and its plain
version (counterpart of ``repro/kernels/enec_encode.py``).

:func:`encode_blocks_cuda` launches the kernel on CUDA tensors and raises on
anything else; :func:`encode_blocks_plain` is the plain PyTorch encoder the
CPU path runs and the kernel is held against.  ``kernels/ops.py`` routes a
call by the input's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import codec
from repro_torch.core.dtypes import FloatFormat
from repro_torch.core.params import EnecParams

from . import build
from .ref import encode_blocks_ref as encode_blocks_plain  # noqa: F401

LAUNCHES = build.LaunchCounter()

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


def _fn():
    fn = build.load("enec_encode").enec_encode_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def encode_blocks_cuda(bits: torch.Tensor, fmt: FloatFormat, p: EnecParams,
                       b_vec: torch.Tensor) -> codec.BlockStreams:
    """Encode (B, N) raw float bits on the card -> flat ``BlockStreams``.

    ``bits`` holds each element's bit pattern in ``fmt.bits_dtype`` (the
    float tensor's storage viewed as int16 / int32); ``b_vec`` is the (B,)
    int32 per-block linear-map parameter.  N must be a power of two with
    N / L groups a multiple of 8."""
    dev = bits.device
    if dev.type != "cuda":
        raise ValueError(f"encode_blocks_cuda needs CUDA tensors, got {dev}")
    if bits.dtype != fmt.bits_dtype or bits.ndim != 2 \
            or not bits.is_contiguous():
        raise ValueError(f"bits must be a contiguous {fmt.bits_dtype} "
                         f"(B, N) tensor; got {bits.dtype} "
                         f"{tuple(bits.shape)}")
    nblocks, n_elems = bits.shape
    if n_elems & (n_elems - 1) or n_elems % p.L or (n_elems // p.L) % 8:
        raise ValueError(f"block of {n_elems} elements: need a power of two "
                         f"with N / L (L={p.L}) a multiple of 8")
    if b_vec.device != dev or b_vec.dtype != torch.int32 \
            or tuple(b_vec.shape) != (nblocks,) or not b_vec.is_contiguous():
        raise ValueError(f"b_vec must be a contiguous int32 ({nblocks},) "
                         f"tensor on {dev}")
    widths = codec.stream_shapes(n_elems, fmt, p)
    out = {name: torch.empty((nblocks, widths[name]), dtype=torch.uint8,
                             device=dev)
           for name in ("mask", "low", "high", "raw")}
    high_len = torch.empty((nblocks,), dtype=torch.int32, device=dev)
    high = out["high"] if widths["high"] else out["mask"]
    err = _fn()(bits.data_ptr(), b_vec.data_ptr(), out["mask"].data_ptr(),
                out["low"].data_ptr(), high.data_ptr(), high_len.data_ptr(),
                out["raw"].data_ptr(), nblocks, n_elems, p.L, p.n, p.m,
                fmt.total_bits, fmt.mant_bits, widths["mask"], widths["low"],
                widths["high"], widths["raw"],
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "enec_encode")
    LAUNCHES.n += 1
    return codec.BlockStreams(mask=out["mask"], low=out["low"],
                              high=out["high"], high_len=high_len,
                              raw=out["raw"])
