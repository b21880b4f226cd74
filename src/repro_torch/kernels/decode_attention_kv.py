"""Decode attention over an ENEC-compressed KV prefix: the CUDA kernel
``csrc/decode_attention_kv.cu`` and its plain version (counterpart of
``repro/kernels/decode_attention_kv.py``).

The frozen prefix of a bf16 KV cache is compressed per (batch, kv_head,
chunk of 128 tokens): with head_dim 128 one chunk is 128 x 128 = 16384
elements, one ENEC block.  :func:`compress_kv_prefix` lays the cache out
that way and encodes it (the encode kernel on the card);
:func:`decode_attention_kv_enec_cuda` runs one query token's GQA group
over the compressed prefix with an online softmax, never writing the
dense K/V to device memory.  ``kernels/ops.py`` routes a call by device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import codec
from repro_torch.core.dtypes import BF16
from repro_torch.core.params import EnecParams

from . import build
from .ref import KV_BLOCK_ELEMS as BLOCK_ELEMS
from .ref import KV_HD as HD
from .ref import KV_TOK as TOK
from .ref import check_kv_attention_args
from .ref import decode_attention_kv_ref as decode_attention_kv_plain  # noqa

LAUNCHES = build.LaunchCounter()

_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 12
             + [ctypes.c_float, ctypes.c_void_p])


def _fn():
    fn = build.load("decode_attention_kv").decode_attention_kv_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def compress_kv_prefix(kv: torch.Tensor, p: EnecParams) -> codec.BlockStreams:
    """kv: (B, S, KV, 128) bf16, S % 128 == 0 -> BlockStreams with leading
    dims (B, KV, S/128), byte-identical to the reference's.

    ``p`` must cover the exponent range of both K and V (search on both
    together, or widen with ``params.widen_for_range``): this low-level
    path does not widen as ``compress_array`` does."""
    from .ops import encode_blocks      # ops imports this module
    b, s, n_kv, hd = kv.shape
    if kv.dtype != torch.bfloat16 or hd != HD or s % TOK:
        raise ValueError(f"kv must be bf16 (B, S, KV, {HD}) with S % {TOK} "
                         f"== 0; got {kv.dtype} {tuple(kv.shape)}")
    tiles = kv.permute(0, 2, 1, 3).reshape(b * n_kv * (s // TOK),
                                           BLOCK_ELEMS)
    streams = encode_blocks(tiles.view(BF16.bits_dtype), BF16, p)
    return streams.map(lambda a: a.reshape((b, n_kv, s // TOK)
                                           + a.shape[1:]))


def decode_attention_kv_enec_cuda(q: torch.Tensor,
                                  k_streams: codec.BlockStreams,
                                  v_streams: codec.BlockStreams,
                                  p: EnecParams) -> torch.Tensor:
    """o (B, KV, grp, 128) f32: bf16 queries ``q`` (B, KV, grp, 128)
    attend over the whole compressed prefix (streams of
    :func:`compress_kv_prefix`) on the card."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_kv_enec_cuda needs CUDA tensors, "
                         f"got {dev}")
    widths = check_kv_attention_args(q, k_streams, v_streams, p)
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"q must be contiguous bf16; got {q.dtype}")
    for s in (k_streams, v_streams):
        for name in ("mask", "low", "high", "raw"):
            t = getattr(s, name)
            if t.device != dev or t.dtype != torch.uint8 \
                    or not t.is_contiguous():
                raise ValueError(f"{name} stream must be contiguous uint8 "
                                 f"on {dev}")
    b, n_kv, grp, hd = q.shape
    n_chunks = k_streams.mask.shape[2]
    out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    ks, vs = k_streams, v_streams
    kh = ks.high if widths["high"] else ks.mask    # m == n: no high stream
    vh = vs.high if widths["high"] else vs.mask
    err = _fn()(q.data_ptr(), ks.mask.data_ptr(), ks.low.data_ptr(),
                kh.data_ptr(), ks.raw.data_ptr(), vs.mask.data_ptr(),
                vs.low.data_ptr(), vh.data_ptr(), vs.raw.data_ptr(),
                out.data_ptr(), b * n_kv, grp, n_chunks, p.b, p.l, p.L, p.n,
                p.m, widths["mask"], widths["low"], widths["high"],
                widths["raw"], 1.0 / math.sqrt(hd),
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "decode_attention_kv")
    LAUNCHES.n += 1
    return out
