"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

The CPU path runs these, the tests hold them against the JAX package, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.  They
follow the kernels' algorithms; they are not a fallback: a CUDA tensor
always goes to its kernel (``kernels/ops.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import codec
from repro_torch.core.api import MATMUL_TILE, CompressedTensor

TILE = MATMUL_TILE


def encode_blocks_ref(bits: torch.Tensor, fmt, p, b_vec=None):
    """Plain ENEC block encode: (B, N) bits -> flat ``BlockStreams`` (the
    plain version of ``csrc/enec_encode.cu``).  ``bits`` may hold the bit
    patterns in the signed container ``fmt.bits_dtype`` (the kernel's
    input) or already in ``fmt.work_dtype``."""
    if bits.dtype != fmt.work_dtype:
        bits = bits.to(fmt.work_dtype) & fmt.bits_mask
    return codec.encode_blocks(bits, fmt, p, b_vec)


def decode_blocks_ref(streams, n_elems: int, fmt, p, b_vec=None,
                      l_vec=None) -> torch.Tensor:
    """Plain ENEC block decode: (B, ...) streams -> (B, N) bit containers
    (the plain version of ``csrc/enec_decode.cu``)."""
    return codec.decode_blocks(streams, n_elems, fmt, p, b_vec, l_vec)


def tiled_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Canonical serve matmul: x (M, K) @ w (K, N) -> (M, N) f32 in the
    fused kernel's schedule — 128x128 weight tiles, zero-padded ragged
    edges, one f32 partial product per tile added to the strip's sum in
    k order.  Every weight mode's ``matmul`` on the CPU is this function,
    which makes dense / stream / fused logits bit-identical there."""
    m, k = x.shape
    k2, n = w.shape
    assert k == k2, (x.shape, w.shape)
    kp, np_ = -(-k // TILE) * TILE, -(-n // TILE) * TILE
    xf = F.pad(x.float(), (0, kp - k))
    wf = F.pad(w.float(), (0, np_ - n, 0, kp - k))
    strips = []
    for ni in range(np_ // TILE):
        acc = None
        for ki in range(kp // TILE):
            part = xf[:, ki * TILE:(ki + 1) * TILE] @ \
                wf[ki * TILE:(ki + 1) * TILE, ni * TILE:(ni + 1) * TILE]
            acc = part if acc is None else acc + part
        strips.append(acc)
    return torch.cat(strips, dim=1)[:, :n]


def decompress_matmul_ref(x: torch.Tensor, ct: CompressedTensor, k: int,
                          n: int, codec_obj=None) -> torch.Tensor:
    """Decompress-untile-then-tiled-matmul: the plain version of the fused
    kernel ``csrc/decompress_matmul.cu``."""
    from repro_torch.core.codec_api import current_codec
    w = (codec_obj or current_codec()).untile_matmul_weight(ct, k, n)
    return tiled_matmul_ref(x, w)
