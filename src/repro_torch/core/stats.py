"""Tensor statistics for the compression pipeline (port of
``repro/core/stats.py``): exponent histogram, exact exponent min/max and
per-layer const flags, computed on the tensor's device; only those few
hundred values cross to the host, in one transfer for many stacks; and
the exact histogram of :func:`exponent_histogram_device`.

Above ``HIST_SAMPLE_CAP`` elements the histogram is taken over the same
strided sample as the reference (stride ``max(1, size // cap) | 1``), so
``params.search`` picks the same :class:`EnecParams`.  Losslessness never
depends on the sample: the exact bounds feed ``params.widen_for_range``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .dtypes import FloatFormat

HIST_SAMPLE_CAP = 1 << 16


@dataclasses.dataclass(frozen=True)
class StackStats:
    """Host-side summary of one ``(L, ...)`` stack."""
    hist: np.ndarray       # (2**exp_bits,) int64 — (sampled) histogram
    lo: int                # exact min exponent over the whole stack
    hi: int                # exact max exponent over the whole stack
    is_const: np.ndarray   # (L,) bool — layer is one repeated bit pattern
    first: np.ndarray      # (L,) int64 — first element's bits per layer

    def bounds(self) -> Tuple[int, int]:
        return self.lo, self.hi


def stack_stats_device(bits2d: torch.Tensor, fmt: FloatFormat):
    """(hist, min, max, is_const, first) of an ``(L, N)`` stack of bit
    patterns, left on its device; pair with :func:`fetch_stats` to bring
    many stacks' statistics to the host in one transfer.  ``bits2d`` may
    hold the patterns in ``fmt.work_dtype`` or in the signed container
    ``fmt.bits_dtype`` (the float's own storage)."""
    exp = ((bits2d >> fmt.mant_bits) & fmt.exp_mask).reshape(-1)
    stride = max(1, exp.numel() // HIST_SAMPLE_CAP) | 1
    hist = torch.bincount(exp[::stride], minlength=1 << fmt.exp_bits)
    is_const = (bits2d == bits2d[:, :1]).all(dim=1)
    first = bits2d[:, 0].to(torch.int64) & fmt.bits_mask
    return (hist, exp.min(), exp.max(), is_const, first)


def fetch_stats(device_stats) -> list:
    """Many :func:`stack_stats_device` results -> :class:`StackStats`, with
    ONE device-to-host transfer for all of them."""
    if not device_stats:
        return []
    parts = [torch.cat([t.reshape(-1).to(torch.int64) for t in st])
             for st in device_stats]
    host = torch.cat(parts).cpu().numpy()
    out, off = [], 0
    for hist, _, _, is_const, _ in device_stats:
        nh, nl = hist.numel(), is_const.numel()
        h = host[off:off + nh]
        lo, hi = host[off + nh], host[off + nh + 1]
        c = host[off + nh + 2:off + nh + 2 + nl]
        f = host[off + nh + 2 + nl:off + nh + 2 + 2 * nl]
        off += nh + 2 + 2 * nl
        out.append(StackStats(hist=h.astype(np.int64), lo=int(lo), hi=int(hi),
                              is_const=c.astype(bool),
                              first=f.astype(np.int64)))
    return out


def stack_stats(bits2d: torch.Tensor, fmt: FloatFormat) -> StackStats:
    """Statistics of one ``(L, N)`` stack (one transfer)."""
    return fetch_stats([stack_stats_device(bits2d, fmt)])[0]


def exponent_histogram_device(x: torch.Tensor, fmt: FloatFormat
                              ) -> torch.Tensor:
    """EXACT exponent histogram of a float tensor, on its device: equal
    bin for bin to ``params.exponent_histogram`` (no sampling, unlike
    :func:`stack_stats_device`).  Integer work only: the bit patterns in
    ``fmt.work_dtype``, masked after the shift.  The (2**exp_bits,) int64
    result stays on the device so callers can batch the transfer."""
    bits = x.reshape(-1).contiguous().view(fmt.bits_dtype).to(fmt.work_dtype)
    exp = (bits >> fmt.mant_bits) & fmt.exp_mask
    return torch.bincount(exp, minlength=1 << fmt.exp_bits)
