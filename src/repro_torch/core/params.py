"""ENEC parameter tuning (paper §V-E): offline histogram-driven search.

Phase 1: exponent histogram -> p(x), l, h.
Phase 2: exhaustive search of the linear-map parameter ``b``; base width
         ``n`` from Eq. 1; cost ``D = sum p(x) * y`` (Eq. 3).
Phase 3: joint search of threshold ``m`` and group length ``L`` minimizing
         expected bits  B_exp = 1/L + n + (m - n) * p(m)**L   (Eq. 4).

Host-side numpy only — runs once per tensor in O(256^2), negligible next to
any real compression job (the paper runs this offline too, §VI).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .dtypes import FloatFormat

# Group lengths must be >= 16 (32-byte alignment on Ascend; a (8,128) vreg
# quantum on TPU points the same way) and divide the block size.
CANDIDATE_GROUP_LENGTHS = (16, 32, 64, 128)
DEFAULT_BLOCK_ELEMS = 16384  # paper §VI-D: best block size that fits local memory


@dataclasses.dataclass(frozen=True)
class EnecParams:
    """The (b, n, m, L) tuple of paper Table IV plus bookkeeping fields."""
    b: int          # linear mapping parameter
    n: int          # base bit-width (incl. the wrap sign bit, Eq. 1)
    m: int          # encoding threshold bit-width (m <= n)
    L: int          # group length
    l: int          # min exponent at search time (needed for exact inverse)
    expected_bits: float = 0.0   # predicted exponent bits/element (Eq. 4)

    def astuple(self):
        return (self.b, self.n, self.m, self.L)


def exponent_histogram(exp: np.ndarray, exp_bits: int) -> np.ndarray:
    return np.bincount(exp.reshape(-1).astype(np.int64), minlength=1 << exp_bits)


def _bits_for(v: int) -> int:
    """floor(log2(v)) + 1 for v >= 1, else 0."""
    return int(v).bit_length()


def _bits_ceil(v: int) -> int:
    """ceil(log2(v)) for v >= 1, else 0."""
    if v <= 0:
        return 0
    return int(math.ceil(math.log2(v))) if v > 1 else 0


def base_width_for(b: int, l: int, h: int) -> int:
    """Eq. 1: minimal n such that y = (b - x) mod 2**n is injective on [l, h]."""
    n = max(_bits_for(b - l), _bits_ceil(h - b)) + 1
    # Guard the paper's formula with the exact injectivity condition.
    while (h - l) >= (1 << n):
        n += 1
    return n


def _phase3(p: np.ndarray, b: int, n: int, block_elems: int,
            group_lengths) -> tuple:
    """Eq. 4 joint (m, L) search for a fixed (b, n). Returns (B_exp, m, L)."""
    xs = np.arange(p.shape[0], dtype=np.int64)
    y = (b - xs) % (1 << n)
    widths = np.array([_bits_for(int(v)) for v in y])
    p_le = np.array([float(p[widths <= m].sum()) for m in range(n + 1)])
    best = (1.0 / max(group_lengths) + n, n, max(group_lengths))
    for L in group_lengths:
        if L > block_elems or block_elems % L or (block_elems // L) % 8:
            continue
        for m in range(1, n + 1):
            bexp = 1.0 / L + n + (m - n) * (p_le[m] ** L)
            if bexp < best[0]:
                best = (bexp, m, L)
    return best


def search(hist: np.ndarray, fmt: FloatFormat,
           block_elems: int = DEFAULT_BLOCK_ELEMS,
           group_lengths=CANDIDATE_GROUP_LENGTHS,
           mode: str = "paper") -> EnecParams:
    """Full §V-E search. ``hist``: exponent histogram (len 2**exp_bits).

    mode="paper": faithful two-phase search — Phase 2 minimizes the
    probability-weighted transformed value D (Eq. 3), Phase 3 then picks
    (m, L) via Eq. 4.
    mode="joint": beyond-paper — minimize the *final* objective B_exp over
    (b, n, m, L) directly (still O(256·n·m·L), trivial offline).  Strictly
    at least as good as the two-phase search; see bench_ablation.
    """
    total = int(hist.sum())
    if total == 0:
        return EnecParams(b=0, n=1, m=1, L=group_lengths[0], l=0, expected_bits=1.0)
    nz = np.nonzero(hist)[0]
    l, h = int(nz[0]), int(nz[-1])
    p = hist / total
    xs = np.arange(hist.shape[0], dtype=np.int64)

    if mode == "paper":
        # -- Phase 2: exhaustive b, n from Eq. 1, minimize D = sum p(x)*y --
        best = None
        for b in range(l, h + 1):
            n = base_width_for(b, l, h)
            y = (b - xs) % (1 << n)
            d = float(np.dot(p, y))
            key = (d, n)
            if best is None or key < best[0]:
                best = (key, b, n)
        _, b_star, n_star = best
        bexp, m_star, l_star = _phase3(p, b_star, n_star, block_elems,
                                       group_lengths)
    elif mode == "joint":
        best = None
        for b in range(l, h + 1):
            n_min = base_width_for(b, l, h)
            for n in (n_min, n_min + 1):  # a wider n can enable a better m
                if n > fmt.exp_bits + 1:
                    continue
                bexp, m, L = _phase3(p, b, n, block_elems, group_lengths)
                if best is None or bexp < best[0]:
                    best = (bexp, b, n, m, L)
        bexp, b_star, n_star, m_star, l_star = best
    else:
        raise ValueError(f"unknown search mode {mode!r}")
    return EnecParams(b=b_star, n=n_star, m=m_star, L=l_star, l=l,
                      expected_bits=float(bexp))


def search_for_array(x: np.ndarray, fmt: FloatFormat, **kw) -> EnecParams:
    """Search params for a concrete weight array (host path)."""
    bits = np.ascontiguousarray(x).view(fmt.np_uint_dtype)
    exp = (bits >> fmt.mant_bits) & fmt.exp_mask
    return search(exponent_histogram(exp, fmt.exp_bits), fmt, **kw)


def widen_for_range(params: EnecParams, l: int, h: int) -> EnecParams:
    """Widening escape for transferred params (DESIGN.md §2.iii).

    Decode recovers ``x = params.l + ((b - y - params.l) mod 2**n)``, so the
    round trip is exact iff every exponent lies in the window
    ``[params.l, params.l + 2**n)``.  When this tensor's observed range
    ``[l, h]`` escapes that window — below, above, or on BOTH ends — lower
    ``l`` and/or grow ``n`` by the minimum that restores coverage, keeping
    (b, m, L) untouched; losslessness is unconditional.  ``m <= n`` is
    preserved because ``n`` only ever grows.

    (Historical note: this used to route through :func:`base_width_for`,
    whose Eq. 1 search-time formula carries a +1 wrap-sign margin — it
    widened tensors whose range the decode window already covered, and
    overshot ``n`` when it did widen.)
    """
    if l >= params.l and (h - params.l) < (1 << params.n):
        return params                      # window already covers [l, h]
    l2 = min(params.l, l)
    n = params.n
    while (h - l2) >= (1 << n):
        n += 1
    return dataclasses.replace(params, n=n, l=l2)


def expected_ratio(params: EnecParams, fmt: FloatFormat) -> float:
    """Predicted compression ratio from Eq. 4 ('Formula Avg CR' in the AE)."""
    bits_per_elem = params.expected_bits + fmt.raw_bits
    return fmt.total_bits / bits_per_elem
