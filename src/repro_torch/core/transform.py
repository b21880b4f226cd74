"""Branch-free integer transformation (paper §V-C), port of
``repro/core/transform.py``.

``y = (b - x) mod 2**n`` maps frequent exponents to small values; the
inverse ``x = l + ((b - l - y) mod 2**n)`` is exact while the exponent
range seen at encode time fits ``[l, l + 2**n)``.  ``b`` and ``l`` are ints
or per-block ``(B,)`` tensors broadcast against the leading axis of a
``(B, N)`` operand; everything runs in signed integer types and masks, so
the results equal the reference's unsigned arithmetic.
"""
from __future__ import annotations

import torch


def _lead(v, like: torch.Tensor):
    if isinstance(v, torch.Tensor) and v.ndim:
        return v.to(like.dtype).reshape(v.shape + (1,) * (like.ndim - v.ndim))
    return int(v)


def forward(x: torch.Tensor, b, n: int) -> torch.Tensor:
    """``y = (b - x) mod 2**n``."""
    return (_lead(b, x) - x) & ((1 << n) - 1)


def inverse(y: torch.Tensor, b, n: int, l) -> torch.Tensor:
    """``x = l + ((b - l - y) mod 2**n)``."""
    mod = (1 << n) - 1
    bb, ll = _lead(b, y), _lead(l, y)
    return ll + ((((bb - ll) & mod) - y) & mod)
