"""Float-format bit layouts used by the ENEC codec (port of
``repro/core/dtypes.py``).

ENEC splits a float into its exponent field (compressed) and the
sign|mantissa residue (stored raw, paper §IV-B).  torch has no shifts on
``uint16``/``uint32``, so bit work happens on signed containers wide enough
to hold the unsigned pattern: ``int32`` for 16-bit formats, ``int64`` for
fp32.  A float tensor's bits are read through ``Tensor.view`` of the signed
type of its width and masked to the unsigned value.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    name: str
    total_bits: int
    exp_bits: int
    mant_bits: int

    @property
    def raw_bits(self) -> int:
        """Width of the stored-raw residue: sign bit + mantissa bits."""
        return 1 + self.mant_bits

    @property
    def float_dtype(self) -> torch.dtype:
        return {"bf16": torch.bfloat16, "fp16": torch.float16,
                "fp32": torch.float32}[self.name]

    @property
    def bits_dtype(self) -> torch.dtype:
        """Signed container of the float's width (the storage of decoded
        bits; ``.view(float_dtype)`` gives the floats back)."""
        return torch.int16 if self.total_bits == 16 else torch.int32

    @property
    def np_uint_dtype(self):
        """numpy's unsigned type of the float's width (host-side search)."""
        return np.uint16 if self.total_bits == 16 else np.uint32

    @property
    def work_dtype(self) -> torch.dtype:
        """Signed type wide enough for the unsigned bit pattern."""
        return torch.int32 if self.total_bits == 16 else torch.int64

    @property
    def bits_mask(self) -> int:
        return (1 << self.total_bits) - 1

    @property
    def exp_mask(self) -> int:
        return (1 << self.exp_bits) - 1

    @property
    def mant_mask(self) -> int:
        return (1 << self.mant_bits) - 1


BF16 = FloatFormat("bf16", 16, 8, 7)
FP16 = FloatFormat("fp16", 16, 5, 10)
FP32 = FloatFormat("fp32", 32, 8, 23)

FORMATS = {"bf16": BF16, "fp16": FP16, "fp32": FP32}

DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
               torch.float32: "float32"}


def format_for(dtype: torch.dtype) -> FloatFormat:
    for fmt in FORMATS.values():
        if fmt.float_dtype == dtype:
            return fmt
    raise ValueError(f"ENEC supports bf16/fp16/fp32, got {dtype}")


def to_bits(x: torch.Tensor) -> torch.Tensor:
    """Float tensor -> its unsigned bit pattern in the format's work type."""
    fmt = format_for(x.dtype)
    return x.view(fmt.bits_dtype).to(fmt.work_dtype) & fmt.bits_mask


def to_container(bits: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Unsigned bit values (work type) -> the signed container of the
    float's width, bit for bit (values above the signed range wrap)."""
    half = 1 << (fmt.total_bits - 1)
    bits = bits & fmt.bits_mask
    return torch.where(bits >= half, bits - (1 << fmt.total_bits),
                       bits).to(fmt.bits_dtype)


def split_fields(bits: torch.Tensor, fmt: FloatFormat):
    """bits -> (exponent, raw) where raw = sign<<mant_bits | mantissa."""
    exp = (bits >> fmt.mant_bits) & fmt.exp_mask
    sign = (bits >> (fmt.total_bits - 1)) & 1
    raw = (bits & fmt.mant_mask) | (sign << fmt.mant_bits)
    return exp, raw


def combine_fields(exp: torch.Tensor, raw: torch.Tensor, fmt: FloatFormat):
    """Inverse of :func:`split_fields` (wraps to the format's width exactly
    as the reference's unsigned arithmetic does)."""
    sign = (raw >> fmt.mant_bits) & 1
    mant = raw & fmt.mant_mask
    out = (sign << (fmt.total_bits - 1)) | (exp << fmt.mant_bits) | mant
    return out & fmt.bits_mask
