"""Tensor statistics for the compression pipeline (port of
``repro/core/stats.py``): exponent histogram, exact exponent min/max and
per-layer const flags, computed on the tensor's device; only those few
hundred values cross to the host.

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


def stack_stats(bits2d: torch.Tensor, fmt: FloatFormat) -> StackStats:
    """Statistics of an ``(L, N)`` stack of bit values (work dtype)."""
    exp = ((bits2d >> fmt.mant_bits) & fmt.exp_mask).reshape(-1)
    stride = max(1, exp.numel() // HIST_SAMPLE_CAP) | 1
    hist = torch.bincount(exp[::stride], minlength=1 << fmt.exp_bits)
    is_const = (bits2d == bits2d[:, :1]).all(dim=1)
    host = [t.cpu() for t in (hist, exp.min(), exp.max(), is_const,
                              bits2d[:, 0])]
    return StackStats(hist=host[0].numpy().astype(np.int64),
                      lo=int(host[1]), hi=int(host[2]),
                      is_const=host[3].numpy().astype(bool),
                      first=host[4].numpy().astype(np.int64))
