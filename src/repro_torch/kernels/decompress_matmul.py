"""Fused ENEC decode + matmul: the CUDA kernel ``csrc/decompress_matmul.cu``
(fused entry and dense-tile entry) and their plain versions (counterpart
of ``repro/kernels/decompress_matmul.py``).

Both entries realise the canonical contraction of ``ref.tiled_matmul_ref``:
128x128 weight tiles, one f32 partial product per tile added in k order.
On the card the fused entry decodes each tile from its ENEC block; the
dense-tile entry loads it from a dense weight.  They share the tile
product and the ordered sum, so their results are bitwise equal.

:func:`plan` chooses the kernel's schedule for a shape (the C side obeys
it: a workspace means ordered split-K, none the serial k walk) and sizes
the workspace.  The per-strip arrival counters are kept per (device,
stream): calls on one stream run in order and share them, calls on two
streams never do.  They are made on a stream's first call; made inside a
CUDA graph capture they would come from the graph's private pool and be
captured as a memset, so that raises (warm up on the capturing stream
first, as ``runtime/captured.py`` does).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import codec
from repro_torch.core.api import MATMUL_TILE, CompressedTensor
from repro_torch.core.dtypes import FORMATS

from . import build, cost
from .ref import decompress_matmul_ref as decompress_matmul_plain  # noqa
from .ref import tiled_matmul_ref as dense_matmul_plain  # noqa: F401

TILE = MATMUL_TILE
# The schedule by M: ordered split-K up to SPLIT_MAX_M (decode batches;
# the kernel's CTAs hold at most 32 rows), the serial k walk above
# (prefill), where split-K's partials would outweigh the tiles.
SPLIT_MAX_M = 16
FUSED_LAUNCHES = build.LaunchCounter("decompress_matmul")
DENSE_LAUNCHES = build.LaunchCounter("dense_tile_matmul")

_c = ctypes
_FUSED_ARGTYPES = ([_c.c_void_p, _c.c_int] + [_c.c_void_p] * 4
                   + [_c.c_int] * 11 + [_c.c_void_p] * 3 + [_c.c_int] * 3
                   + [_c.c_void_p])
_DENSE_ARGTYPES = ([_c.c_void_p, _c.c_int, _c.c_void_p, _c.c_int,
                    _c.c_longlong, _c.c_longlong] + [_c.c_void_p] * 3
                   + [_c.c_int] * 3 + [_c.c_void_p])
_W_FMT = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_COUNTERS: dict = {}     # (device, stream) -> per-strip arrival counters
_FNS: dict = {}          # C entry name -> bound ctypes function


@dataclasses.dataclass(frozen=True)
class Plan:
    """The schedule for one (M, K, N), the same for both entries:
    ``split`` (ordered split-K) or the serial k walk; ``ws_floats`` f32 of
    workspace (one partial of M x 128 per tile, split only)."""
    m: int
    k_tiles: int
    n_tiles: int
    split: bool

    @property
    def tiles(self) -> int:
        return self.k_tiles * self.n_tiles

    @property
    def ws_floats(self) -> int:
        return self.tiles * self.m * TILE if self.split else 0


def plan(m: int, k: int, n: int) -> Plan:
    return Plan(m, -(-k // TILE), -(-n // TILE), m <= SPLIT_MAX_M)


def _outputs(m: int, k: int, n: int, device, stream: int):
    """``out`` (m, n) f32 and, in the split branch, the workspace (a
    tensor of its own, given back to the caching allocator in stream order
    when the call returns; None otherwise) and the stream's per-strip
    arrival counters, which the kernel leaves at 0."""
    p = plan(m, k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    if not p.split:
        return out, None, 0
    ws = torch.empty(p.ws_floats, dtype=torch.float32, device=device)
    key = (device, stream)
    ctr = _COUNTERS.get(key)
    if ctr is None or ctr.numel() < p.n_tiles:
        build.refuse_in_capture(
            f"kernel 2's arrival counters for stream {stream:#x} (a warm-up "
            f"call of the same shapes on the capturing stream makes them)")
        ctr = torch.zeros(max(p.n_tiles, 256), dtype=torch.int32,
                          device=device)
        _COUNTERS[key] = ctr
    return out, ws, ctr.data_ptr()


def last_plan() -> dict:
    """The last launch's grid, resident CTAs per SM, dynamic shared bytes,
    SM count and branch, as the C side chose them."""
    fn = build.load("decompress_matmul").matmul_last_plan
    fn.argtypes, fn.restype = [_c.c_void_p], None
    buf = (_c.c_int * 5)()
    fn(_c.addressof(buf))
    return dict(zip(("grid", "ctas_per_sm", "smem_bytes", "sm_count",
                     "split"), list(buf)))


def _fn(name: str, argtypes):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load("decompress_matmul"), name)
        fn.argtypes, fn.restype = argtypes, _c.c_int
        _FNS[name] = fn
    return fn


def _stream(device_index: int) -> int:
    """The current CUDA stream of the device, as the raw handle the C
    entries take (what ``torch.cuda.current_stream().cuda_stream`` gives,
    without building a Stream object on every call of a decode step)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _check_x(x: torch.Tensor, k: int):
    if not x.is_cuda:
        raise ValueError(f"the matmul kernel needs CUDA tensors, got "
                         f"{x.device}")
    if x.ndim != 2 or x.shape[1] != k or not x.is_contiguous() \
            or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be a contiguous bf16/f32 (M, {k}) tensor; "
                         f"got {x.dtype} {tuple(x.shape)}")


@functools.lru_cache(maxsize=None)
def _widths(fmt_name: str, p) -> dict:
    return codec.stream_shapes(TILE * TILE, FORMATS[fmt_name], p)


def decompress_matmul_cuda(x: torch.Tensor, ct: CompressedTensor, k: int,
                           n: int) -> torch.Tensor:
    """out (M, n) f32 = x (M, k) @ W, W held only as ENEC tile streams
    (one layer; a TP-sharded ``(S, B/S, ...)`` layout is read as its flat
    block axis, which is the n-major tile order).  A ``meta`` x takes the
    cost route (``kernels/cost.py``)."""
    if cost.is_meta(x):
        return cost.decompress_matmul(x, ct, k, n)
    _check_x(x, k)
    if ct.mode != "enec":
        raise ValueError("the fused kernel requires enec tile streams")
    s = ct.streams
    if s.mask.ndim != (3 if ct.shards > 1 else 2):
        raise ValueError("stacked streams: slice one layer first")
    tiles = (-(-k // TILE)) * (-(-n // TILE))
    widths = _widths(ct.fmt_name, ct.params)
    dev = x.get_device()
    for name in ("mask", "low", "high", "raw"):
        t, w = getattr(s, name), widths[name]
        if t.dtype != torch.uint8 or t.shape[-1] != w \
                or t.numel() != tiles * w or not t.is_contiguous() \
                or t.get_device() != dev:
            raise ValueError(f"{name} stream must be contiguous uint8, "
                             f"{tiles} blocks of {w} bytes on {x.device}")
    stream = _stream(dev)
    out, ws, ctr = _outputs(x.shape[0], k, n, x.device, stream)
    p, fmt = ct.params, ct.fmt
    high = s.high if widths["high"] else s.mask
    err = _fn("decompress_matmul_launch", _FUSED_ARGTYPES)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), s.mask.data_ptr(),
        s.low.data_ptr(), high.data_ptr(), s.raw.data_ptr(), p.b, p.l, p.L,
        p.n, p.m, fmt.total_bits, fmt.mant_bits, widths["mask"],
        widths["low"], widths["high"], widths["raw"], out.data_ptr(),
        _ptr(ws), ctr, x.shape[0], k, n, stream)
    build.check(err, "decompress_matmul")
    FUSED_LAUNCHES.n += 1
    return out


def dense_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The dense-tile entry: out (M, N) f32 = x (M, K) @ w (K, N), any
    strides of ``w``, in the fused entry's exact schedule.  A ``meta`` x
    takes the cost route (``kernels/cost.py``)."""
    if cost.is_meta(x):
        return cost.dense_matmul(x, w)
    k, n = w.shape
    _check_x(x, k)
    if w.device != x.device or w.dtype not in _W_FMT:
        raise ValueError(f"w must be a bf16/fp16/f32 tensor on {x.device}; "
                         f"got {w.dtype} on {w.device}")
    stream = _stream(x.get_device())
    out, ws, ctr = _outputs(x.shape[0], k, n, x.device, stream)
    err = _fn("dense_tile_matmul_launch", _DENSE_ARGTYPES)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        _W_FMT[w.dtype], w.stride(0), w.stride(1), out.data_ptr(),
        _ptr(ws), ctr, x.shape[0], k, n, stream)
    build.check(err, "dense_tile_matmul")
    DENSE_LAUNCHES.n += 1
    return out
