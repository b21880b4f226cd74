"""ENEC block decoder: the CUDA kernel ``csrc/enec_decode.cu`` and its plain
version (counterpart of ``repro/kernels/enec_decode.py``).

:func:`decode_blocks_cuda` launches the kernel on CUDA tensors and raises on
anything else; :func:`decode_blocks_plain` is the plain PyTorch version the
CPU path runs and the kernel is held against.  ``kernels/ops.py`` routes a
call by the streams' device.

:func:`plan` picks the kernel's branch for a call (the C side obeys it):
the lanes branch for bf16 blocks of 16384 elements with a power-of-two
group length in 16..2048 and n <= 9 (every block of the serving path), the
generic branch for the rest; and a persistent grid of one CTA per resident
slot of the card, CTA c decoding blocks c, c + grid, ...
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import codec
from repro_torch.core.dtypes import FORMATS, FloatFormat
from repro_torch.core.params import EnecParams

from . import build
from .ref import decode_blocks_ref as decode_blocks_plain  # noqa: F401

LAUNCHES = build.LaunchCounter("enec_decode")
LANES_BLOCK = 16384      # the lanes branch's block size

_c = ctypes
_ARGTYPES = ([_c.c_void_p] * 8 + [_c.c_longlong] + [_c.c_int] * 12
             + [_c.c_void_p])
_RES_ARGTYPES = [_c.c_int] * 11 + [_c.c_void_p]
_RESOURCES: dict = {}    # (library, device, lanes, config) -> resources
_LAUNCHES: dict = {}     # a call's shape and overrides -> C arguments
_FNS: dict = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch over ``nblocks`` blocks: the branch (``lanes``) and the
    CTAs; CTA c takes blocks c, c + grid, .."""
    nblocks: int
    lanes: bool
    grid: int

    def blocks(self, cta: int) -> range:
        """The blocks CTA ``cta`` takes, in order (the kernel's walk)."""
        return range(cta, self.nblocks, self.grid)


def lanes_ok(fmt: FloatFormat, n_elems: int, p: EnecParams) -> bool:
    """The lanes branch's preconditions (``decode_staged_lanes_bf16`` and
    ``lanes::WarpRank``: bf16, 16384 elements, L a power of two with N / L
    groups in 8..1024, n <= 9)."""
    return (fmt.name == "bf16" and n_elems == LANES_BLOCK and p.n <= 9
            and 16 <= p.L <= 2048 and p.L & (p.L - 1) == 0)


def plan(nblocks: int, fmt: FloatFormat, n_elems: int, p: EnecParams,
         sm_count: int, ctas_per_sm: int) -> Plan:
    """The branch by :func:`lanes_ok`; one CTA per resident slot of the
    card (``sm_count`` x ``ctas_per_sm``), never more CTAs than blocks
    (the encoder's plan too)."""
    return Plan(nblocks, lanes_ok(fmt, n_elems, p),
                max(1, min(nblocks, sm_count * ctas_per_sm)))


def entry(lib: str, name: str, argtypes):
    """The C entry ``name`` of library ``lib``, bound once."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load(lib), name)
        fn.argtypes, fn.restype = argtypes, _c.c_int
        _FNS[name] = fn
    return fn


@functools.lru_cache(maxsize=None)
def _widths(n_elems: int, fmt_name: str, n: int, m: int, big_l: int) -> dict:
    return codec.stream_shapes(n_elems, FORMATS[fmt_name],
                               EnecParams(b=0, n=n, m=m, L=big_l, l=0))


def _config(fmt: FloatFormat, n_elems: int, p: EnecParams) -> tuple:
    """The block configuration the C entries take: block size, L, n, m,
    the format's widths and the four streams' bytes a block."""
    w = _widths(n_elems, fmt.name, p.n, p.m, p.L)
    return (n_elems, p.L, p.n, p.m, fmt.total_bits, fmt.mant_bits,
            w["mask"], w["low"], w["high"], w["raw"])


def resources(device, lanes: bool, fmt: FloatFormat, n_elems: int,
              p: EnecParams, lib: str = "enec_decode") -> tuple:
    """(dynamic shared bytes, resident CTAs per SM, SM count) of a branch
    of the decoder (or, ``lib`` "enec_encode", the encoder) on
    ``device``, from the C side's queries."""
    config = _config(fmt, n_elems, p)
    key = (lib, device, lanes, config)
    res = _RESOURCES.get(key)
    if res is None:
        buf = (_c.c_int * 3)()
        with torch.cuda.device(device):
            err = entry(lib, f"{lib}_resources", _RES_ARGTYPES)(
                int(lanes), *config, _c.addressof(buf))
        build.check(err, f"{lib} resources")
        res = _RESOURCES[key] = tuple(buf)
    return res


def launch_plan(nblocks: int, n_elems: int, fmt: FloatFormat, p: EnecParams,
                device, grid: int = None, lanes: bool = None,
                lib: str = "enec_decode") -> tuple:
    """(Plan, {grid, lanes, ctas_per_sm, sm_count, smem_bytes}) of a call of
    the decoder (or the encoder) on ``device``: the planner's choice, or
    the given grid and branch (``lanes`` False forces the generic branch;
    True where :func:`lanes_ok` fails raises)."""
    ok = lanes_ok(fmt, n_elems, p)
    if lanes and not ok:
        raise ValueError(f"the lanes branch does not take {fmt.name} blocks "
                         f"of {n_elems} with {p.astuple()}")
    use_lanes = ok if lanes is None else lanes
    smem, per_sm, sms = resources(device, use_lanes, fmt, n_elems, p, lib)
    pl = Plan(nblocks, use_lanes, max(1, min(nblocks, sms * per_sm)))
    if grid is not None:
        if not 1 <= grid <= max(1, nblocks):
            raise ValueError(f"grid {grid} outside 1..{nblocks}")
        pl = dataclasses.replace(pl, grid=grid)
    return pl, dict(grid=pl.grid, lanes=pl.lanes, ctas_per_sm=per_sm,
                    sm_count=sms, smem_bytes=smem)


def launch_args(nblocks: int, n_elems: int, fmt: FloatFormat, p: EnecParams,
                device, grid: int = None, lanes: bool = None,
                lib: str = "enec_decode") -> tuple:
    """The C entry's configuration, branch and grid for a call: planned
    once a shape (and override), then looked up."""
    key = (lib, device, nblocks, n_elems, fmt.name, p.n, p.m, p.L, grid,
           lanes)
    args = _LAUNCHES.get(key)
    if args is None:
        pl, _ = launch_plan(nblocks, n_elems, fmt, p, device, grid, lanes,
                            lib)
        args = _LAUNCHES[key] = (_config(fmt, n_elems, p)
                                 + (int(pl.lanes), pl.grid))
    return args


def _check_stream(t: torch.Tensor, name: str, rows: int, width: int, dev):
    if t.device != dev or t.dtype != torch.uint8 or t.ndim != 2 \
            or not t.is_contiguous() or tuple(t.shape) != (rows, width):
        raise ValueError(
            f"{name} stream must be a contiguous uint8 ({rows}, {width}) "
            f"tensor on {dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def decode_blocks_cuda(streams: codec.BlockStreams, n_elems: int,
                       fmt: FloatFormat, p: EnecParams,
                       b_vec: torch.Tensor, l_vec: torch.Tensor, *,
                       grid: int = None, lanes: bool = None,
                       out: torch.Tensor = None) -> torch.Tensor:
    """Decode flat ``(B, ...)`` streams on the card -> (B, N) bits in
    ``fmt.bits_dtype``.  ``b_vec``/``l_vec``: (B,) int32 per-block
    inverse-map parameters; ``streams.high_len`` (B,) int32, each block's
    high-stream length in bits (the kernel copies only the high bytes it
    needs).  ``grid`` / ``lanes`` override the plan (the chip checks hold
    every grid and both branches against the plain decoder).  ``out``: a
    contiguous (B, N) tensor of ``fmt.bits_dtype`` on the streams' device
    to decode into (the prefetch pipeline's fixed slot buffers), else a
    new one."""
    dev = streams.mask.device
    if dev.type != "cuda":
        raise ValueError(f"decode_blocks_cuda needs CUDA tensors, got {dev}")
    nblocks = streams.mask.shape[0]
    widths = _widths(n_elems, fmt.name, p.n, p.m, p.L)
    for name in ("mask", "low", "high", "raw"):
        _check_stream(getattr(streams, name), name, nblocks, widths[name],
                      dev)
    high_len = streams.high_len.reshape(-1)
    for name, v in (("b_vec", b_vec), ("l_vec", l_vec),
                    ("high_len", high_len)):
        if v.device != dev or v.dtype != torch.int32 \
                or tuple(v.shape) != (nblocks,):
            raise ValueError(f"{name} must be an int32 ({nblocks},) tensor "
                             f"on {dev}")
    b_vec, l_vec, high_len = (v.contiguous() for v in (b_vec, l_vec,
                                                       high_len))
    args = launch_args(nblocks, n_elems, fmt, p, dev, grid, lanes)
    if out is None:
        out = torch.empty((nblocks, n_elems), dtype=fmt.bits_dtype,
                          device=dev)
    elif out.device != dev or out.dtype != fmt.bits_dtype \
            or tuple(out.shape) != (nblocks, n_elems) \
            or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {fmt.bits_dtype} "
                         f"({nblocks}, {n_elems}) tensor on {dev}; got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    high = streams.high if widths["high"] else streams.mask
    err = entry("enec_decode", "enec_decode_launch", _ARGTYPES)(
        streams.mask.data_ptr(), streams.low.data_ptr(), high.data_ptr(),
        high_len.data_ptr(), streams.raw.data_ptr(), b_vec.data_ptr(),
        l_vec.data_ptr(), out.data_ptr(), nblocks, *args,
        torch._C._cuda_getCurrentRawStream(dev.index))
    build.check(err, "enec_decode")
    LAUNCHES.n += 1
    return out
