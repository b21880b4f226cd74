"""ENEC block encoder: the CUDA kernel ``csrc/enec_encode.cu`` and its plain
version (counterpart of ``repro/kernels/enec_encode.py``).

:func:`encode_blocks_cuda` launches the kernel on CUDA tensors and raises on
anything else; :func:`encode_blocks_plain` is the plain PyTorch encoder the
CPU path runs and the kernel is held against.  ``kernels/ops.py`` routes a
call by the input's device.

:func:`plan` is the decoder's (``kernels/enec_decode.py``): the lanes branch
for bf16 blocks of 16384 elements with a power-of-two group length in
16..2048 and n <= 9, the generic branch for the rest, on a persistent grid
of one CTA per resident slot of the card (CTA c encoding blocks c, c +
grid, ..).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import codec
from repro_torch.core.dtypes import FloatFormat
from repro_torch.core.params import EnecParams

from . import build, enec_decode
from .enec_decode import Plan, lanes_ok, plan  # noqa: F401
from .ref import encode_blocks_ref as encode_blocks_plain  # noqa: F401

LAUNCHES = build.LaunchCounter("enec_encode")
MIN_BLOCK = 64           # the packer needs >= 8 lanes at every level

_c = ctypes
_ARGTYPES = ([_c.c_void_p] * 7 + [_c.c_longlong] + [_c.c_int] * 12
             + [_c.c_void_p])


def launch_plan(nblocks: int, n_elems: int, fmt: FloatFormat, p: EnecParams,
                device, grid: int = None, lanes: bool = None) -> tuple:
    """(Plan, {grid, lanes, ctas_per_sm, sm_count, smem_bytes}) of an
    encode call on ``device`` (``enec_decode.launch_plan`` with this
    kernel's resources)."""
    return enec_decode.launch_plan(nblocks, n_elems, fmt, p, device, grid,
                                   lanes, "enec_encode")


def encode_blocks_cuda(bits: torch.Tensor, fmt: FloatFormat, p: EnecParams,
                       b_vec: torch.Tensor, *, grid: int = None,
                       lanes: bool = None) -> codec.BlockStreams:
    """Encode (B, N) raw float bits on the card -> flat ``BlockStreams``.

    ``bits`` holds each element's bit pattern in ``fmt.bits_dtype`` (the
    float tensor's storage viewed as int16 / int32); ``b_vec`` is the (B,)
    int32 per-block linear-map parameter.  N must be a power of two of at
    least 64 with N / L groups a multiple of 8, and n <= 9 (every float
    format's exponent range).  ``grid`` / ``lanes`` override the plan (the
    chip checks hold every grid and both branches against the plain
    encoder)."""
    dev = bits.device
    if dev.type != "cuda":
        raise ValueError(f"encode_blocks_cuda needs CUDA tensors, got {dev}")
    if bits.dtype != fmt.bits_dtype or bits.ndim != 2 \
            or not bits.is_contiguous():
        raise ValueError(f"bits must be a contiguous {fmt.bits_dtype} "
                         f"(B, N) tensor; got {bits.dtype} "
                         f"{tuple(bits.shape)}")
    nblocks, n_elems = bits.shape
    if n_elems & (n_elems - 1) or n_elems < MIN_BLOCK or n_elems % p.L \
            or (n_elems // p.L) % 8:
        raise ValueError(f"block of {n_elems} elements: need a power of two "
                         f">= {MIN_BLOCK} with N / L (L={p.L}) a multiple "
                         f"of 8")
    if not 1 <= p.m <= p.n <= 9:
        raise ValueError(f"the kernel takes 1 <= m <= n <= 9; got "
                         f"{p.astuple()}")
    if b_vec.device != dev or b_vec.dtype != torch.int32 \
            or tuple(b_vec.shape) != (nblocks,) or not b_vec.is_contiguous():
        raise ValueError(f"b_vec must be a contiguous int32 ({nblocks},) "
                         f"tensor on {dev}")
    widths = codec.stream_shapes(n_elems, fmt, p)
    args = enec_decode.launch_args(nblocks, n_elems, fmt, p, dev, grid,
                                   lanes, "enec_encode")
    out = {name: torch.empty((nblocks, widths[name]), dtype=torch.uint8,
                             device=dev)
           for name in ("mask", "low", "high", "raw")}
    high_len = torch.empty((nblocks,), dtype=torch.int32, device=dev)
    high = out["high"] if widths["high"] else out["mask"]
    err = enec_decode.entry("enec_encode", "enec_encode_launch", _ARGTYPES)(
        bits.data_ptr(), b_vec.data_ptr(), out["mask"].data_ptr(),
        out["low"].data_ptr(), high.data_ptr(), high_len.data_ptr(),
        out["raw"].data_ptr(), nblocks, *args,
        torch._C._cuda_getCurrentRawStream(dev.index))
    build.check(err, "enec_encode")
    LAUNCHES.n += 1
    return codec.BlockStreams(mask=out["mask"], low=out["low"],
                              high=out["high"], high_len=high_len,
                              raw=out["raw"])
