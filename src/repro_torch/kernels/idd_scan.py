"""Batched inclusive prefix sum: the CUDA kernel ``csrc/idd_scan.cu`` and
its plain version (counterpart of ``repro/kernels/idd_scan.py``).

:func:`idd_scan_cuda` launches the kernel on CUDA tensors and raises on
anything else; :func:`idd_scan_plain` is the plain PyTorch version the CPU
path runs and the kernel is held against.  ``kernels/ops.py`` routes a call
by the input's device.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import idd_scan_ref as idd_scan_plain  # noqa: F401

LANE = 128
LAUNCHES = build.LaunchCounter()

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def _fn():
    fn = build.load("idd_scan").idd_scan_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def check_shape(x: torch.Tensor) -> None:
    """The reference's contract: (B, N) int32 or bool, N % 128 == 0."""
    if x.ndim != 2 or x.shape[1] % LANE:
        raise ValueError(f"idd_scan takes (B, N) with N % {LANE} == 0; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.int32, torch.bool):
        raise ValueError(f"idd_scan takes int32 or bool; got {x.dtype}")


def idd_scan_cuda(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum along the last axis of (B, N) int32 or
    bool ``x`` on the card, bitwise equal to ``torch.cumsum``."""
    if x.device.type != "cuda":
        raise ValueError(f"idd_scan_cuda needs a CUDA tensor, got {x.device}")
    check_shape(x)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    err = _fn()(x.data_ptr(), int(x.dtype == torch.bool), out.data_ptr(),
                x.shape[0], x.shape[1],
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "idd_scan")
    LAUNCHES.n += 1
    return out
