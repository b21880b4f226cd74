"""Exact packed wire/file format for ENEC-compressed tensors (port of
``repro/core/wire.py``; the bytes are the reference's in both directions).

The device layout pads each block's high stream to its static bound; the
wire stores the exact bits.  Record layout per tensor (little endian):

  magic  u32 = 0xE47C0DEC
  mode   u8 (0=enec, 1=raw, 2=const), fmt u8, stack u16 (0 = plain record;
         else the leading layer-stack length L of every stream)
  ndim u32, shape i64[ndim], dtype tag u8[8]
  block_elems u32, shards u32
  params: b i32, n i32, m i32, L i32, l i32  (enec mode)
  nblocks u32                      (TOTAL flat blocks: stack * shards * B)
  high_len u32[nblocks]            (bits)
  mask | low | raw                 (fixed-size streams, concatenated)
  high                             (exact bit stream, byte padded per block)

enec-v2 frame (the self-delimiting container unit):

  frame_magic u32 = 0xE47C0DF2
  version u16 = 2, flags u16 (reserved, must be 0)
  payload_len u64
  payload_crc u32                  (CRC32 of the payload bytes)
  payload bytes

The reference converts each block's high stream between the device's
halving layout and the exact bit string in a host loop over blocks.  Here
the conversion to and from a straight bit layout of every block is one
tensor operation on the streams' device (``bitio.pack_straight`` /
``unpack_straight``).  A save selects all blocks' exact prefixes on the
streams' device at once and copies only them to the host
(``bitio.exact_from_straight``), and a writer takes a record's buffers as
they are (:func:`wire_parts`, :func:`frame_parts`); a load uploads the exact
bytes as they are and scatters them into rows on the device
(``bitio.straight_from_exact``): no per-block Python loop at either end.
Every host-to-device upload of a deserialization goes through
:func:`h2d`, counted on a codec's ledger, so a load moves the record's
stream bytes and nothing more.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device

from . import bitio
from . import codec as block_codec
from .api import FRAME_HEADER_BYTES, CompressedTensor, record_overhead_bytes
from .codec import BlockStreams
from .dtypes import FORMATS
from .params import EnecParams

MAGIC = 0xE47C0DEC
_FMT_TAGS = {"bf16": 0, "fp16": 1, "fp32": 2}
_FMT_FROM_TAG = {v: k for k, v in _FMT_TAGS.items()}
_MODE_TAGS = {"enec": 0, "raw": 1, "const": 2}
_MODE_FROM_TAG = {v: k for k, v in _MODE_TAGS.items()}

FRAME_MAGIC = 0xE47C0DF2
FRAME_VERSION = 2
_FRAME_HDR = struct.Struct("<IHHQI")   # magic, version, flags, len, crc
assert _FRAME_HDR.size == FRAME_HEADER_BYTES

__all__ = ["WireError", "h2d", "frame", "frame_parts", "read_frame",
           "iter_frames", "record_overhead_bytes", "to_wire", "wire_parts",
           "from_wire", "wire_stack",
           "RecordHeader", "parse_header", "split_streams", "enec_tensor"]


class WireError(ValueError):
    """A wire record or frame failed validation.  Carries the record's
    coordinates where known: ``record`` (leaf name), ``pack`` (pack file)
    and ``offset`` (the frame's byte offset in the pack); outer layers fill
    the unset ones with :meth:`with_context`."""

    def __init__(self, message, *, record=None, pack=None, offset=None):
        super().__init__(message)
        self.record = record
        self.pack = pack
        self.offset = offset

    def with_context(self, *, record=None, pack=None, offset=None):
        if self.record is None:
            self.record = record
        if self.pack is None:
            self.pack = pack
        if self.offset is None:
            self.offset = offset
        return self

    def __str__(self):
        base = self.args[0] if self.args else ""
        ctx = [f"{k}={v}" for k, v in (("record", self.record),
                                       ("pack", self.pack),
                                       ("offset", self.offset))
               if v is not None]
        return f"{base} [{', '.join(ctx)}]" if ctx else str(base)


def h2d(arr: np.ndarray, device, codec=None, *,
        dense: bool = False) -> torch.Tensor:
    """Upload one host array to ``device``, counting its bytes on
    ``codec`` (default: the ambient codec); ``dense=True`` books them as
    dense bytes (raw leaves and raw escapes)."""
    from .codec_api import current_codec    # codec_api imports api
    # ascontiguousarray makes a 0-d array (1,); the leaf keeps its shape
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
    (codec or current_codec()).count_h2d(arr.nbytes, dense=dense)
    return torch.from_numpy(arr.copy()).to(device)


# ---------------------------------------------------------------------------
# enec-v2 framing
# ---------------------------------------------------------------------------

def frame(payload: bytes) -> bytes:
    """Wrap one record payload in a self-delimiting, CRC-checked frame."""
    return _FRAME_HDR.pack(FRAME_MAGIC, FRAME_VERSION, 0, len(payload),
                           zlib.crc32(payload)) + payload


def frame_parts(parts) -> list:
    """:func:`frame` of the payload that ``parts`` (bytes-like buffers)
    make in order, as the frame's header followed by the parts themselves:
    the same bytes, none of them copied into one."""
    crc = length = 0
    for part in parts:
        crc = zlib.crc32(part, crc)
        length += memoryview(part).nbytes
    return [_FRAME_HDR.pack(FRAME_MAGIC, FRAME_VERSION, 0, length, crc),
            *parts]


def read_frame(buf, off: int = 0, *, record=None, pack=None,
               base_offset=None):
    """Validate and return ``(payload, next_off)`` for the frame at
    ``off``: magic, version, flags, declared length within the buffer and
    the payload's CRC32; any mismatch raises :class:`WireError`."""
    def _err(msg):
        return WireError(msg, record=record, pack=pack, offset=base_offset)

    view = memoryview(buf)
    if off + FRAME_HEADER_BYTES > len(view):
        raise _err(f"frame header truncated at offset {off}: need "
                   f"{FRAME_HEADER_BYTES} bytes, have {len(view) - off}")
    magic, version, flags, length, crc = _FRAME_HDR.unpack_from(view, off)
    if magic != FRAME_MAGIC:
        raise _err(f"bad frame magic {magic:#x} at offset {off} "
                   f"(expected {FRAME_MAGIC:#x})")
    if version != FRAME_VERSION:
        raise _err(f"unsupported frame version {version} at offset {off}")
    if flags != 0:
        raise _err(f"unknown frame flags {flags:#x} at offset {off}")
    start = off + FRAME_HEADER_BYTES
    if start + length > len(view):
        raise _err(f"frame payload truncated at offset {off}: declares "
                   f"{length} bytes, only {len(view) - start} available")
    payload = view[start:start + length]
    got = zlib.crc32(payload)
    if got != crc:
        raise _err(f"frame CRC mismatch at offset {off}: stored {crc:#010x}, "
                   f"computed {got:#010x} — record is corrupt")
    return payload, start + length


def iter_frames(buf):
    """Yield ``(offset, payload)`` for every frame in a concatenated pack."""
    off, view = 0, memoryview(buf)
    while off < len(view):
        start = off
        payload, off = read_frame(view, off)
        yield start, payload


# ---------------------------------------------------------------------------
# record serialization
# ---------------------------------------------------------------------------

def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _host_bytes(t: torch.Tensor) -> memoryview:
    """A tensor's bytes on the host, as a view (no copy past the one off
    the device)."""
    return memoryview(np.ascontiguousarray(_host(t)).reshape(-1)
                      .view(np.uint8))


def to_wire(ct: CompressedTensor, *, stacked: bool = False) -> bytes:
    """Serialize one tensor, or with ``stacked=True`` one ``(L, ...)``
    stacked stream bundle (the stack length goes into the header so
    :func:`from_wire` restores the ``(L[, S], B)`` layout)."""
    return b"".join(wire_parts(ct, stacked=stacked))


def wire_parts(ct: CompressedTensor, *, stacked: bool = False) -> list:
    """:func:`to_wire`'s bytes as the buffers they are made of, in order
    (headers, and views of the streams' host copies), not joined: a writer
    takes them as they are (``checkpoint/ckpt.py``)."""
    stack = 0
    if stacked:
        if ct.mode != "enec":
            raise WireError("only enec-mode tensors can be stacked on wire")
        stack = int(ct.streams.mask.shape[0])
        if not 0 < stack <= 0xFFFF:
            raise WireError(f"stack length {stack} out of range")
    out = [struct.pack("<IBBH", MAGIC, _MODE_TAGS[ct.mode],
                       _FMT_TAGS[ct.fmt_name], stack),
           struct.pack("<I", len(ct.shape)),
           np.asarray(ct.shape, np.int64).tobytes(),
           struct.pack("<8s", ct.dtype_str.encode()[:8]),
           struct.pack("<II", ct.block_elems, ct.shards)]
    if ct.mode in ("raw", "const"):
        out.append(_host(ct.raw_bytes).astype(np.uint8).tobytes())
        return out

    p = ct.params
    out.append(struct.pack("<5i", p.b, p.n, p.m, p.L, p.l))
    s = block_codec.flatten_blocks(ct.streams)
    nblocks = s.mask.shape[0]
    high_len = _host(s.high_len).astype(np.int64)
    out += [struct.pack("<I", nblocks),
            high_len.astype(np.uint32).tobytes(),
            _host_bytes(s.mask), _host_bytes(s.low), _host_bytes(s.raw)]
    width = p.n - p.m
    if width:
        # halving layout -> straight bits on the streams' device; lanes past
        # each block's count are zeroed, so its exact bytes are a prefix
        n = ct.block_elems
        vals = bitio.unpack_fixed(s.high, n, width)
        count = (s.high_len.to(torch.int64) // width)[:, None]
        vals = vals * (torch.arange(n, device=vals.device)[None, :] < count)
        nbytes = (count[:, 0] * width + 7) // 8
        out.append(bitio.exact_from_straight(
            bitio.pack_straight(vals, width), nbytes))
    return out


def _torch_dtype(name: str):
    dt = getattr(torch, name, None) if name else None
    return dt if isinstance(dt, torch.dtype) else None


@dataclasses.dataclass
class RecordHeader:
    """A record's header, parsed and validated on the host.  For an enec
    record, ``stream_offset`` is where its streams start (``high_len``,
    then mask, low, raw and the exact high bytes, to the record's end);
    for a raw / const record, where its payload starts."""
    mode: str
    fmt_name: str
    stack: int
    shape: tuple
    dtype_str: str
    block_elems: int
    shards: int
    params: Optional[EnecParams]
    nblocks: int
    widths: Optional[dict]
    high_len: Optional[np.ndarray]   # (nblocks,) int64 bits
    stream_offset: int
    total: int

    @property
    def stream_nbytes(self) -> int:
        return self.total - self.stream_offset


def parse_header(buf, *, record=None, pack=None,
                 offset=None) -> RecordHeader:
    """Validate one record from an EXACT buffer slice (a framed payload or
    a whole v1 blob) without moving its streams: every field is checked,
    and short buffers, trailing bytes, unknown tags and impossible stream
    lengths raise :class:`WireError` with the given coordinates."""
    def _err(msg):
        return WireError(msg, record=record, pack=pack, offset=offset)

    view = memoryview(buf)
    total, off = len(view), 0
    try:
        magic, mode_tag, fmt_tag, stack = struct.unpack_from("<IBBH", view,
                                                             off)
        off += 8
        if magic != MAGIC:
            raise _err(f"bad ENEC wire magic {magic:#x}")
        if mode_tag not in _MODE_FROM_TAG:
            raise _err(f"unknown mode tag {mode_tag}")
        mode = _MODE_FROM_TAG[mode_tag]
        (ndim,) = struct.unpack_from("<I", view, off)
        off += 4
        if ndim > 16:
            raise _err(f"implausible ndim {ndim}")
        if off + 8 * ndim > total:
            raise _err(f"record truncated in the {ndim}-dim shape")
        shape = tuple(np.frombuffer(view, np.int64, ndim, off).tolist())
        off += 8 * ndim
        (dtype_raw,) = struct.unpack_from("<8s", view, off)
        off += 8
        dtype_str = bytes(dtype_raw).rstrip(b"\x00").decode()
        block_elems, shards = struct.unpack_from("<II", view, off)
        off += 8
    except WireError:
        raise
    except (struct.error, UnicodeDecodeError, TypeError) as e:
        raise _err(f"corrupt record header: {e}") from None
    dtype = _torch_dtype(dtype_str)
    if dtype is None:
        raise _err(f"corrupt record header: unknown dtype {dtype_str!r}")
    itemsize = torch.empty((), dtype=dtype).element_size()

    if mode in ("raw", "const"):
        expect = itemsize * (1 if mode == "const"
                             else int(np.prod(shape, dtype=np.int64)))
        if total - off != expect:
            raise _err(f"{mode} record carries {total - off} payload bytes, "
                       f"expected {expect} for shape {shape} dtype "
                       f"{dtype_str}")
        return RecordHeader(
            mode=mode, fmt_name=_FMT_FROM_TAG.get(fmt_tag, "bf16"),
            stack=stack, shape=shape, dtype_str=dtype_str,
            block_elems=block_elems, shards=shards, params=None, nblocks=0,
            widths=None, high_len=None, stream_offset=off, total=total)

    if fmt_tag not in _FMT_FROM_TAG:
        raise _err(f"unknown float format tag {fmt_tag}")
    fmt = FORMATS[_FMT_FROM_TAG[fmt_tag]]
    try:
        b, n, m, L, l = struct.unpack_from("<5i", view, off)
        off += 20
        (nblocks,) = struct.unpack_from("<I", view, off)
        off += 4
    except struct.error as e:
        raise _err(f"record truncated in params: {e}") from None
    p = EnecParams(b=b, n=n, m=m, L=L, l=l)
    if not (0 <= m <= n <= 32 and L >= 1 and block_elems >= 1):
        raise _err(f"implausible params {p.astuple()} "
                   f"block_elems={block_elems}")
    if shards < 1 or nblocks % (max(stack, 1) * shards):
        raise _err(f"nblocks={nblocks} not divisible by stack={stack} * "
                   f"shards={shards} — corrupt header")
    stream_offset = off
    if off + 4 * nblocks > total:
        raise _err("high_len vector truncated")
    high_len = np.frombuffer(view, np.uint32, nblocks, off).astype(np.int64)
    off += 4 * nblocks
    widths = block_codec.stream_shapes(block_elems, fmt, p)
    for what in ("mask", "low", "raw"):
        need = nblocks * widths[what]
        if off + need > total:
            raise _err(f"{what} stream truncated: need {need} bytes at "
                       f"offset {off}, record has {total - off} left")
        off += need
    max_bits = block_elems * (n - m)
    bad = np.nonzero(high_len > max_bits)[0]
    if bad.size:
        raise _err(f"block {int(bad[0])}: high_len {int(high_len[bad[0]])} "
                   f"bits exceeds the {max_bits}-bit block bound — corrupt "
                   f"record")
    need = int(((high_len + 7) // 8).sum())
    if off + need > total:
        raise _err(f"high stream truncated: need {need} bytes at offset "
                   f"{off}, record has {total - off} left")
    off += need
    if off != total:
        raise _err(f"record has {total - off} trailing bytes after the high "
                   f"stream — length mismatch (corrupt or mis-framed)")
    return RecordHeader(
        mode="enec", fmt_name=fmt.name, stack=stack, shape=shape,
        dtype_str=dtype_str, block_elems=block_elems, shards=shards,
        params=p, nblocks=nblocks, widths=widths, high_len=high_len,
        stream_offset=stream_offset, total=total)


def split_streams(hdr: RecordHeader, section) -> tuple:
    """An enec record's stream section (bytes ``[stream_offset, total)``,
    a uint8 array or tensor) -> its pieces ``(high_len, mask, low, raw,
    exact)`` as views of it, in wire order."""
    n, w = hdr.nblocks, hdr.widths
    off = 4 * n
    pieces = [section[:off]]
    for what in ("mask", "low", "raw"):
        pieces.append(section[off:off + n * w[what]].reshape(n, w[what]))
        off += n * w[what]
    pieces.append(section[off:])
    return tuple(pieces)


def enec_tensor(hdr: RecordHeader, high_len, mask, low, raw,
                exact, lead=None) -> CompressedTensor:
    """The device layout of an enec record from its streams, already on
    one device (``high_len`` int32; the rest uint8, as
    :func:`split_streams` cuts them): each block's exact high bits are
    scattered into the halving layout on that device.  ``lead`` (default:
    the record's ``(stack, shards)`` dims) shapes the streams; a rank's
    own shard rows of a record pass their own."""
    dev = mask.device
    width = hdr.params.n - hdr.params.m
    bits_dev = high_len.to(torch.int64)
    straight = bitio.straight_from_exact(
        exact, (bits_dev + 7) // 8,
        bitio.straight_nbytes(hdr.block_elems, width))
    vals = bitio.unpack_straight(straight, hdr.block_elems, width)
    count = (bits_dev // max(width, 1))[:, None]
    vals = vals * (torch.arange(hdr.block_elems, device=dev)[None, :]
                   < count)
    if lead is None:
        lead = ((hdr.stack,) if hdr.stack else ()) \
            + ((hdr.shards,) if hdr.shards > 1 else ())
    flat = mask.shape[0]
    for d in lead:
        flat //= d
    streams = BlockStreams(
        mask=mask, low=low, high=bitio.pack_fixed(vals, width),
        high_len=high_len, raw=raw)
    streams = streams.map(
        lambda a: a.reshape(lead + (flat,) + tuple(a.shape[1:])))
    ct = CompressedTensor(
        streams=streams, raw_bytes=None, fmt_name=hdr.fmt_name,
        params=hdr.params, shape=hdr.shape, dtype_str=hdr.dtype_str,
        block_elems=hdr.block_elems, shards=hdr.shards, mode="enec")
    ct._set_wire_bytes(hdr.high_len)
    return ct


def _own_shards(hdr: RecordHeader, start: int, count: int, high_len,
                mask, low, raw, exact) -> tuple:
    """Shards ``[start, start + count)`` of every layer of an enec
    record's host streams (:func:`split_streams`' pieces), and the lead
    dims they take on the device."""
    stack = hdr.stack or 1
    flat = hdr.nblocks // (stack * hdr.shards)

    def rows(a):
        a = a.reshape((stack, hdr.shards, flat) + a.shape[1:])
        return np.ascontiguousarray(a[:, start:start + count]).reshape(
            (-1,) + a.shape[3:])

    ends = np.concatenate([[0], np.cumsum((hdr.high_len + 7) // 8)])
    runs = [exact[ends[(l * hdr.shards + start) * flat]:
                  ends[(l * hdr.shards + start + count) * flat]]
            for l in range(stack)]
    lead = ((hdr.stack,) if hdr.stack else ()) + (count,)
    return (rows(high_len.view(np.uint32)), rows(mask), rows(low),
            rows(raw), np.concatenate(runs), lead)


def from_wire(buf, codec=None, *, device="cuda", record=None, pack=None,
              offset=None, stream_place=None) -> CompressedTensor:
    """Parse one record from an EXACT buffer slice (a framed payload or a
    whole v1 blob), validated by :func:`parse_header`.  Streams are
    uploaded to ``device`` through :func:`h2d`, so ``codec``'s ledger
    (default: the ambient codec's) sees exactly the compressed bytes.

    ``stream_place`` (a mesh restore's
    ``runtime.collectives.stream_placer``) maps a record's shard count to
    the ``(start, count)`` shard rows this rank holds, or ``None`` for all
    of them: a placed upload moves only those rows' bytes, and the tensor
    keeps the whole record's metadata (``shards``, the wire size).
    Raw / const payloads always upload whole."""
    dev = resolve_device(device)
    hdr = parse_header(buf, record=record, pack=pack, offset=offset)
    view = memoryview(buf)
    section = np.frombuffer(view, np.uint8, hdr.stream_nbytes,
                            hdr.stream_offset)
    if hdr.mode in ("raw", "const"):
        return CompressedTensor(
            streams=None, raw_bytes=h2d(section, dev, codec,
                                        dense=(hdr.mode == "raw")),
            fmt_name=hdr.fmt_name, params=None, shape=hdr.shape,
            dtype_str=hdr.dtype_str, block_elems=hdr.block_elems,
            shards=hdr.shards, mode=hdr.mode)
    high_len, mask, low, raw, exact = split_streams(hdr, section)
    lead = None
    own = None if stream_place is None else stream_place(hdr.shards)
    if own is not None:
        high_len, mask, low, raw, exact, lead = _own_shards(
            hdr, *own, high_len, mask, low, raw, exact)

    def up(a):
        return h2d(a, dev, codec)

    high_len_dev = up(high_len.view(np.uint32).astype(np.int32))
    exact_dev = up(exact)
    return enec_tensor(hdr, high_len_dev, up(mask), up(low), up(raw),
                       exact_dev, lead)


def wire_stack(ct: CompressedTensor) -> int:
    """Leading stream stack length of a deserialized stacked record."""
    if ct.mode != "enec":
        return 0
    lead = ct.streams.mask.ndim - (3 if ct.shards > 1 else 2)
    return int(ct.streams.mask.shape[0]) if lead == 1 else 0
