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

:func:`plan` splits the (pair, chunk) items of a call into contiguous
ranges, one a CTA, on a grid sized to the card (flash-decoding split-KV),
and sizes the workspace of the partials; the kernel obeys it.  The
per-pair arrival counters of the ordered combine are kept per (device,
stream), as kernel 2's are, and are not made inside a graph capture.
"""
from __future__ import annotations

import ctypes
import dataclasses
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

LAUNCHES = build.LaunchCounter("decode_attention_kv")
MAX_GRP = 16             # query heads a kv head the kernel takes (two
                         # 8-wide mma blocks)

_c = ctypes
_ARGTYPES = ([_c.c_void_p] * 12 + [_c.c_int] * 13 + [_c.c_float, _c.c_void_p])
_COUNTERS: dict = {}     # (device, stream) -> per-pair arrival counters
_RESOURCES: dict = {}    # (device, grp, params, widths) -> (smem, per_sm, sms)
_FNS: dict = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """Split-KV for one call: ``pairs`` (b, kv_head) pairs of ``n_chunks``
    chunks are I = pairs * n_chunks items (item = pair * n_chunks + chunk,
    which is also its block in the streams); CTA c of ``grid`` takes the
    items of ``ranges()[c]``.  Each CTA has two partial slots of
    ``grp * (128 + 2)`` f32 (m, l, acc) in the workspace: slot 0 for the
    first pair of its range, slot 1 for the last, used only where the
    range holds part of a pair."""
    pairs: int
    n_chunks: int
    grp: int
    grid: int

    @property
    def items(self) -> int:
        return self.pairs * self.n_chunks

    def range(self, c: int) -> tuple:
        return (c * self.items // self.grid,
                (c + 1) * self.items // self.grid)

    def ranges(self) -> list:
        return [self.range(c) for c in range(self.grid)]

    def cta_of(self, item: int) -> int:
        """The CTA whose range holds ``item`` (the kernel's ``cta_of``)."""
        return -(-(item + 1) * self.grid // self.items) - 1

    def contributors(self, pair: int) -> range:
        """The CTAs whose ranges hold chunks of ``pair``, in chunk order."""
        c = self.n_chunks
        return range(self.cta_of(pair * c), self.cta_of(pair * c + c - 1) + 1)

    @property
    def ws_floats(self) -> int:
        return 2 * self.grid * self.grp * (HD + 2)

    @property
    def ws_bytes(self) -> int:
        return 4 * self.ws_floats


def plan(pairs: int, n_chunks: int, grp: int, sm_count: int,
         ctas_per_sm: int) -> Plan:
    """One CTA per resident slot of the card (``sm_count`` x
    ``ctas_per_sm``), never more CTAs than items."""
    return Plan(pairs, n_chunks, grp,
                max(1, min(pairs * n_chunks, sm_count * ctas_per_sm)))


def _fn(name: str, argtypes):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load("decode_attention_kv"), name)
        fn.argtypes, fn.restype = argtypes, _c.c_int
        _FNS[name] = fn
    return fn


def resources(device, grp: int, p: EnecParams, widths: dict) -> tuple:
    """(dynamic shared bytes, resident CTAs per SM, SM count) of the kernel
    for this configuration on ``device``, from the C side's queries."""
    key = (device, grp, p.astuple(), tuple(widths.values()))
    res = _RESOURCES.get(key)
    if res is None:
        buf = (_c.c_int * 3)()
        with torch.cuda.device(device):
            err = _fn("decode_attention_kv_resources",
                      [_c.c_int] * 8 + [_c.c_void_p])(
                grp, p.L, p.n, p.m, widths["mask"], widths["low"],
                widths["high"], widths["raw"], _c.addressof(buf))
        build.check(err, "decode_attention_kv resources")
        res = _RESOURCES[key] = tuple(buf)
    return res


def launch_plan(q: torch.Tensor, k_streams: codec.BlockStreams,
                p: EnecParams, grid: int = None) -> tuple:
    """(Plan, {grid, items, ctas_per_sm, sm_count, smem_bytes, ws_bytes})
    of a call on ``q``'s device: the planner's grid, or ``grid``."""
    b, n_kv, grp, _ = q.shape
    widths = codec.stream_shapes(BLOCK_ELEMS, BF16, p)
    smem, per_sm, sms = resources(q.device, grp, p, widths)
    pl = plan(b * n_kv, k_streams.mask.shape[2], grp, sms, per_sm)
    if grid is not None:
        if not 1 <= grid <= max(1, pl.items):
            raise ValueError(f"grid {grid} outside 1..{pl.items}")
        pl = dataclasses.replace(pl, grid=grid)
    return pl, dict(grid=pl.grid, items=pl.items, ctas_per_sm=per_sm,
                    sm_count=sms, smem_bytes=smem, ws_bytes=pl.ws_bytes)


def _counters(device, stream: int, pairs: int) -> torch.Tensor:
    key = (device, stream)
    ctr = _COUNTERS.get(key)
    if ctr is None or ctr.numel() < pairs:
        build.refuse_in_capture(
            f"kernel 5's arrival counters for stream {stream:#x}")
        ctr = torch.zeros(max(pairs, 256), dtype=torch.int32, device=device)
        _COUNTERS[key] = ctr
    return ctr


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
                                  p: EnecParams, grid: int = None
                                  ) -> torch.Tensor:
    """o (B, KV, grp, 128) f32: bf16 queries ``q`` (B, KV, grp, 128)
    attend over the whole compressed prefix (streams of
    :func:`compress_kv_prefix`) on the card.  ``grid`` overrides the
    planner's CTA count (any 1 <= grid <= items gives a result within the
    tolerance of the plain version; each grid its own bits)."""
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
    if not 1 <= grp <= MAX_GRP:
        raise ValueError(f"the kernel takes 1..{MAX_GRP} query heads a kv "
                         f"head; got {grp}")
    if not 1 <= p.m <= p.n <= BF16.exp_bits + 1 \
            or not 0 <= p.l <= BF16.exp_mask:
        raise ValueError(f"the kernel takes 1 <= m <= n <= "
                         f"{BF16.exp_bits + 1} and 0 <= l <= "
                         f"{BF16.exp_mask}; got {p}")
    if p.L & (p.L - 1) or not 16 <= p.L <= BLOCK_ELEMS // 8:
        raise ValueError(f"the kernel takes a power-of-two group length in "
                         f"16..{BLOCK_ELEMS // 8}; got {p.L}")
    n_chunks = k_streams.mask.shape[2]
    pl, _ = launch_plan(q, k_streams, p, grid)
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    ws = torch.empty(pl.ws_floats, dtype=torch.float32, device=dev)
    ctr = _counters(dev, stream, pl.pairs)
    ks, vs = k_streams, v_streams
    kh = ks.high if widths["high"] else ks.mask    # m == n: no high stream
    vh = vs.high if widths["high"] else vs.mask
    err = _fn("decode_attention_kv_launch", _ARGTYPES)(
        q.data_ptr(), ks.mask.data_ptr(), ks.low.data_ptr(), kh.data_ptr(),
        ks.raw.data_ptr(), vs.mask.data_ptr(), vs.low.data_ptr(),
        vh.data_ptr(), vs.raw.data_ptr(), out.data_ptr(), ws.data_ptr(),
        ctr.data_ptr(), pl.pairs, grp, n_chunks, pl.grid, p.b, p.l, p.L, p.n,
        p.m, widths["mask"], widths["low"], widths["high"], widths["raw"],
        1.0 / math.sqrt(hd), stream)
    build.check(err, "decode_attention_kv")
    LAUNCHES.n += 1
    return out
