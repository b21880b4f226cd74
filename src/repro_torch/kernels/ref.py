"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

The CPU path runs these, the tests hold them against the JAX package, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.  They
follow the kernels' algorithms; they are not a fallback: a CUDA tensor
always goes to its kernel (``kernels/ops.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import codec
from repro_torch.core.api import MATMUL_TILE, CompressedTensor
from repro_torch.core.dtypes import BF16

TILE = MATMUL_TILE
KV_TOK = 128            # tokens per compressed KV chunk
KV_HD = 128             # head_dim of the compressed KV attention
KV_BLOCK_ELEMS = KV_TOK * KV_HD     # one chunk of one head = one ENEC block


def idd_scan_ref(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, int32 (the plain version
    of ``csrc/idd_scan.cu``)."""
    return torch.cumsum(x.to(torch.int32), dim=-1, dtype=torch.int32)


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


def tile_product(xt: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """One k tile's f32 partial: xt (M, 128) @ wt (128, N') -> (M, N').

    The products are formed elementwise and summed by a fixed pairwise
    tree over k (k and k + 64 first, ...), all elementwise tensor ops, so
    every output element's bits depend only on its own row and column:
    never on M, on the strides or on the library's choice of a matmul
    kernel for the shape (a CPU ``@`` gives a row other bits at M = 1 than
    inside a larger M)."""
    t = xt[:, :, None] * wt[None, :, :]
    while t.shape[1] > 1:
        h = t.shape[1] // 2
        t = t[:, :h] + t[:, h:]
    return t[:, 0]


def tiled_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Canonical serve matmul: x (M, K) @ w (K, N) -> (M, N) f32 in the
    fused kernel's schedule — 128x128 weight tiles, zero-padded ragged
    edges, one f32 partial product per tile (:func:`tile_product`) added
    to the strip's sum in k order.  Every weight mode's ``matmul`` and the
    logits head on the CPU are this function, which makes dense / stream /
    fused logits bit-identical there, and each row's bits independent of
    M and of the weight's strides."""
    m, k = x.shape
    k2, n = w.shape
    assert k == k2, (x.shape, w.shape)
    kp, np_ = -(-k // TILE) * TILE, -(-n // TILE) * TILE
    xf = F.pad(x.float(), (0, kp - k))
    wf = F.pad(w.float(), (0, np_ - n, 0, kp - k))
    acc = None       # every strip at once: columns never mix
    for ki in range(kp // TILE):
        ks = slice(ki * TILE, (ki + 1) * TILE)
        part = tile_product(xf[:, ks], wf[ks])
        acc = part if acc is None else acc + part
    return acc[:, :n]


def decompress_matmul_ref(x: torch.Tensor, ct: CompressedTensor, k: int,
                          n: int, codec_obj=None) -> torch.Tensor:
    """Decompress-untile-then-tiled-matmul: the plain version of the fused
    kernel ``csrc/decompress_matmul.cu``."""
    from repro_torch.core.codec_api import current_codec
    w = (codec_obj or current_codec()).untile_matmul_weight(ct, k, n)
    return tiled_matmul_ref(x, w)


def check_kv_attention_args(q, k_streams, v_streams, p) -> dict:
    """Shapes of one compressed-KV attention call, checked: q (B, KV, grp,
    128), K and V streams (B, KV, C, width) of 16384-element bf16 blocks
    under ``p``; returns the stream widths."""
    if q.ndim != 4 or q.shape[3] != KV_HD:
        raise ValueError(f"q must be (B, KV, grp, {KV_HD}); got "
                         f"{tuple(q.shape)}")
    widths = codec.stream_shapes(KV_BLOCK_ELEMS, BF16, p)
    lead = tuple(k_streams.mask.shape[:3])
    if lead[:2] != tuple(q.shape[:2]):
        raise ValueError(f"streams lead with {lead}, q with "
                         f"{tuple(q.shape[:2])}")
    for which, s in (("k", k_streams), ("v", v_streams)):
        for name in ("mask", "low", "high", "raw"):
            t = getattr(s, name)
            if tuple(t.shape) != lead + (widths[name],):
                raise ValueError(f"{which} {name} stream must be {lead} + "
                                 f"({widths[name]},); got {tuple(t.shape)}")
    return widths


def decode_attention_kv_ref(q, k_streams, v_streams, p) -> torch.Tensor:
    """Plain decode attention over a compressed KV prefix (the plain
    version of ``csrc/decode_attention_kv.cu``): decode every K and V block
    with the plain decoder, then the kernel's chunked online softmax in
    f32 (running max from -1e30, output acc / max(l, 1e-30)).
    q (B, KV, grp, 128) -> o (B, KV, grp, 128) f32."""
    check_kv_attention_args(q, k_streams, v_streams, p)
    b, n_kv, grp, hd = q.shape
    n_chunks = k_streams.mask.shape[2]

    def tiles(streams):
        bits = codec.decode_blocks(codec.flatten_blocks(streams),
                                   KV_BLOCK_ELEMS, BF16, p)
        return bits.view(torch.bfloat16).reshape(b, n_kv, n_chunks, KV_TOK,
                                                 hd)

    k, v = tiles(k_streams), tiles(v_streams)
    qf = q.float()
    scale = 1.0 / math.sqrt(hd)
    acc = torch.zeros((b, n_kv, grp, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, n_kv, grp, 1), -1e30, dtype=torch.float32,
                   device=q.device)
    denom = torch.zeros_like(m)
    for c in range(n_chunks):
        scores = torch.einsum("bkgh,bkth->bkgt", qf, k[:, :, c].float()) \
            * scale
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        prob = torch.exp(scores - m_new)
        corr = torch.exp(m - m_new)
        denom = denom * corr + prob.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgt,bkth->bkgh", prob,
                                        v[:, :, c].float())
        m = m_new
    return acc / torch.clamp(denom, min=1e-30)
