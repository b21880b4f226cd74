"""Batched inclusive prefix sum: the CUDA kernel ``csrc/idd_scan.cu`` and
its plain version (counterpart of ``repro/kernels/idd_scan.py``).

:func:`idd_scan_cuda` launches the kernel on CUDA tensors and raises on
anything else; :func:`idd_scan_plain` is the plain PyTorch version the CPU
path runs and the kernel is held against.  ``kernels/ops.py`` routes a call
by the input's device.

:func:`plan` picks the kernel's branch for a shape (the C side obeys it):
one warp a row for rows of up to a few thousand elements or for enough
rows to fill the card, else the single-pass look-back scan across CTAs
over tiles of 8192 elements.  The look-back's status words and ticket are
kept per (device, stream) with the epoch of the last launch on them, so
they need no memset per call.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import build
from .ref import idd_scan_ref as idd_scan_plain  # noqa: F401

LANE = 128
ROW_WARPS = 8            # warp rows: rows a CTA
TILE = 8192              # look-back: elements a tile (one CTA)
WARP_RUN = 1024          # look-back: elements a warp of a tile
STEP = 1024              # warp rows: elements a warp step
WARP_MAX_N = 8192        # rows up to this length: one warp a row
ROWS_PER_SM = 32         # ... or at least this many rows an SM
EPOCH_LIMIT = 1 << 30    # the status words keep 30 bits of epoch
LAUNCHES = build.LaunchCounter("idd_scan")

_c = ctypes
_ARGTYPES = [_c.c_void_p, _c.c_int, _c.c_void_p, _c.c_int, _c.c_int,
             _c.c_int, _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_uint,
             _c.c_void_p]
_WS: dict = {}           # (device, stream) -> [status, ticket, last epoch]
_SMS: dict = {}          # device index -> SM count
_FN = []                 # the bound C entry, once loaded


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's schedule for ``rows`` rows of ``n`` elements: warp rows
    (``lookback`` False; ``grid`` CTAs of 8 rows) or the look-back scan
    (``grid`` = rows x ``tiles_per_row`` CTAs, one tile each)."""
    rows: int
    n: int
    is_bool: bool
    lookback: bool

    @property
    def tiles_per_row(self) -> int:
        return -(-self.n // TILE) if self.lookback else 1

    @property
    def grid(self) -> int:
        return (self.rows * self.tiles_per_row if self.lookback
                else -(-self.rows // ROW_WARPS))


@functools.lru_cache(maxsize=256)
def plan(rows: int, n: int, is_bool: bool, sm_count: int) -> Plan:
    """Warp rows where a row is short or the rows alone fill the card (32
    rows an SM: a quarter of the warps an SM holds), the look-back scan
    otherwise."""
    lookback = n > WARP_MAX_N and rows < ROWS_PER_SM * sm_count
    return Plan(rows, n, bool(is_bool), lookback)


def _fn():
    if not _FN:
        fn = build.load("idd_scan").idd_scan_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def check_shape(x: torch.Tensor) -> None:
    """The reference's contract: (B, N) int32 or bool, N % 128 == 0."""
    if x.ndim != 2 or x.shape[1] % LANE:
        raise ValueError(f"idd_scan takes (B, N) with N % {LANE} == 0; got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.int32, torch.bool):
        raise ValueError(f"idd_scan takes int32 or bool; got {x.dtype}")


def _sm_count(index: int) -> int:
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return sms


def _workspace(device, stream: int, words: int):
    """The stream's status words (grown as needed), its ticket and the
    next epoch; a fresh or regrown set starts from zeros at epoch 1."""
    ws = _WS.get((device, stream))
    if ws is None or ws[0].numel() < words or ws[2] + 1 >= EPOCH_LIMIT:
        ws = [torch.zeros(max(words, 1024), dtype=torch.int64, device=device),
              torch.zeros(1, dtype=torch.int32, device=device), 0]
        _WS[(device, stream)] = ws
    ws[2] += 1
    return ws[0], ws[1], ws[2]


def idd_scan_cuda(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum along the last axis of (B, N) int32 or
    bool ``x`` on the card, bitwise equal to ``torch.cumsum``.  It refuses
    a CUDA graph capture: the look-back's epoch is a host argument, which a
    replay would repeat against status words that already hold it."""
    build.refuse_in_capture("kernel 3 (its look-back epoch is a host "
                            "argument)")
    if x.device.type != "cuda":
        raise ValueError(f"idd_scan_cuda needs a CUDA tensor, got {x.device}")
    check_shape(x)
    x = x.contiguous()
    if x.data_ptr() % 16:          # the kernel loads 16 bytes a lane
        x = x.clone()
    dev = x.get_device()
    p = plan(x.shape[0], x.shape[1], x.dtype == torch.bool, _sm_count(dev))
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    # the raw handle of the current stream, without building a Stream
    stream = torch._C._cuda_getCurrentRawStream(dev)
    status = ticket = None
    epoch = 0
    if p.lookback:
        status, ticket, epoch = _workspace(x.device, stream, p.grid)
    err = _fn()(x.data_ptr(), int(p.is_bool), out.data_ptr(), p.rows, p.n,
                int(p.lookback), p.grid,
                None if status is None else status.data_ptr(),
                None if ticket is None else ticket.data_ptr(), epoch, stream)
    build.check(err, "idd_scan")
    LAUNCHES.n += 1
    return out
