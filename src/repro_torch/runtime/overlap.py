"""Double-buffered decode-prefetch pipeline for stream-mode serving (port of
``repro/runtime/overlap.py``; the paper's §VI-C).

The serial stream-mode layer loop pays ``decode(l) + compute(l)`` a layer:
every :class:`~repro_torch.runtime.weights.StreamedWeight` decodes inside
the layer that reads it.  The pipeline issues layer l+1's decode before
layer l's compute:

    prologue:  decode layer 0
    layer i:   issue the decode of layer i+1  ─┐ on the card: a second
               run layer i on decoded i       ─┘ stream, joined by events

Each prefetch is ONE batched decode over every streamed leaf of the layer
(:func:`decode_layer`): ``buckets_per_layer`` kernel-1 launches, one per
decoder bucket, never one per leaf.  The port's planner decodes each
bucket's true block count, which is the reference's ``exact=True``.  The
bits equal the serial ``StreamedWeight.materialize`` of the same slice, and
the layer consumes them through the same canonical tiled matmul
(``weights.resolve`` with ``prefetched=``), so logits with the pipeline on
and off are bitwise equal: only the schedule moves.

**One driver.**  The reference has two, :func:`pipeline_scan` (a
``lax.scan`` with a modulo-unroll window) and :func:`pipeline_unrolled`
(a static unroll), which differ only in how XLA compiles them.  The port's
layer loop is a Python loop, so it has one driver, :func:`pipeline_unrolled`,
with the reference's contract; ``pipeline_scan`` is an alias of it.

**On the card** the prefetch runs on a side stream (:func:`side_stream`;
``runtime/captured.py`` gives each captured step its own through
:func:`use_side_stream`).  Two decoded layers are in flight, each in one of
two fixed slot buffers allocated once per schedule on the main stream
before the fork.  Layer i+1's decode waits for the event that says its
slot is free (layer i-1's compute, which read it, has finished on the main
stream); layer i's compute waits for the event that ends its own decode.
Every launch of kernel 1 decodes into a slot buffer (``Codec.execute(...,
out=)``), and the decoded weights are views of it, so no tensor that one
stream allocated is read on the other: what the side stream allocates (its
per-block parameter vectors) only the side stream uses, and the slot
buffers are released after the last join.  The caching allocator
therefore never hands a block from one stream to the other while work on
it is pending, also inside a CUDA graph capture, whose edges between the
two streams are these events.  The main stream's wait on the last decode
joins the side stream back into the capture.

**The bucket layout.**  A bucket's launch reads its members' streams as one
flat array a stream, so a layer's rows of the bucket's stacks must be
adjacent: then they are one view (``codec_api._joined``) and a prefetch
copies no compressed byte.  ``Codec.execute`` lays every encode launch out
layer by layer, which gives a tree compressed by ``assign_weight_modes``
that layout as it is.  Where a bucket's stacks are not adjacent (restored
records, each in its own storage; a stack of the launch escaped to dense
between two of them), :func:`build_schedule` copies them once into one
buffer a stream and points the handles at its views; the old streams are
released.  That copy is made outside any CUDA graph capture (the engine's
warm-up and prefills run the schedule first) and refused inside one.

**Under a serving mesh** (``runtime/collectives.py``) a rank holds only its
own shard rows of each stream, so there is no layout to keep: each
prefetch allocates one buffer a bucket in the layout above and gathers
every owner's shard rows of the layer into their rows of it
(:func:`gather_layer`: one broadcast an owner a leaf, all of the layer's
in flight together, each unpacked from its staging row into the layout),
then the bucket's one decode launch reads it as one view, with nothing
copied after the gather.  A MoE expert stack is never gathered: the rank
holds its own experts' rows as a tensor of their own
(``collectives.localize_ct``), which its decode reads as it is, or copied
into the bucket's buffer beside gathered members.

On the CPU the same schedule runs in order on one stream: that follows the
device, it is not a fallback.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.api import slice_stacked
from repro_torch.core.codec import BlockStreams, flatten_blocks
from repro_torch.core.codec_api import adjacent, current_codec
from repro_torch.core.dtypes import FORMATS
from repro_torch.kernels import build
from repro_torch.runtime import collectives
from repro_torch.runtime.weights import (StreamedWeight, is_handle, resolve,
                                         tree_leaves, tree_map_with_path)

OVERLAP_MODES = ("off", "on", "auto")

_SIDE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_side_stream", default=None)
_DEFAULT_SIDE: dict = {}     # device -> the process's side stream


def overlap_enabled(mode: str, period, n_periods: int) -> bool:
    """Should the layer loop over ``period`` (stacked ``n_periods`` deep)
    run pipelined?  "off" never; "on" / "auto" whenever a StreamedWeight
    is present (dense and fused handles decode inside the matmul kernel or
    not at all) and there is a period ahead to prefetch.  A stack of one
    period (Jamba cut to its 8-layer period) runs serially, each
    position's weights decoded as it runs: the pipeline would decode that
    period before anything runs, so it hides nothing, and would hold the
    whole period decoded at once."""
    if mode not in OVERLAP_MODES:
        raise ValueError(f"unknown overlap mode {mode!r}; "
                         f"expected one of {OVERLAP_MODES}")
    if mode == "off" or n_periods < 2:
        return False
    return any(isinstance(leaf, StreamedWeight)
               for _, leaf in tree_leaves(period))


@dataclasses.dataclass
class OverlapSchedule:
    """The static prefetch schedule of one period stack: the flatten slots
    holding streamed weights (the prefetch set), the period to rebuild
    slices from, and the decode launches a layer costs
    (``buckets_per_layer``: the distinct decoder keys of the slots)."""
    leaves: list                 # full-period flatten, handles as leaves
    slots: Tuple[int, ...]       # indices of StreamedWeight leaves
    n_periods: int
    buckets_per_layer: int
    period: Any = dataclasses.field(repr=False, default=None)


def _key(ct) -> tuple:
    """The decoder bucket of a compressed tensor (``Codec.plan_decode``)."""
    p = ct.params
    return (ct.fmt_name, (p.n, p.m, p.L), ct.block_elems)


def _lay_out(handles) -> None:
    """Copy the stacked streams of one bucket's member handles into one
    buffer a stream, layer l's rows of member j right after member j-1's,
    and point each handle's streams at its views of it.  One stream at a
    time, so the copy holds at most one stream of the bucket twice."""
    build.refuse_in_capture("the prefetch's bucket layout")
    n_layers = handles[0].ct.streams.mask.shape[0]
    nbs = [flatten_blocks(h.ct.streams).mask.shape[0] // n_layers
           for h in handles]
    for field in BlockStreams._fields:
        olds = [getattr(h.ct.streams, field) for h in handles]
        rest = tuple(olds[0].shape[-1:]) if field != "high_len" else ()
        buf = torch.empty((n_layers, sum(nbs)) + rest, dtype=olds[0].dtype,
                          device=olds[0].device)
        off = 0
        for h, old, nb in zip(handles, olds, nbs):
            part = buf[:, off:off + nb]
            part.copy_(old.reshape((n_layers, nb) + rest))
            if old.is_cuda:    # read on this stream, freed on its own
                old.record_stream(torch.cuda.current_stream(old.device))
            h.ct.streams = h.ct.streams._replace(
                **{field: part.view(old.shape)})
            off += nb
        del olds, old


def build_schedule(period, n_periods: int, codec=None) -> OverlapSchedule:
    """Flatten ``period`` (handles as leaves, sorted dict keys) and record
    the prefetch slots; the same indices address ``resolve(...,
    prefetched=)`` on a layer slice.  A bucket of several stacks whose
    streams are not yet laid out for one-view launches is laid out now
    (once: the handles keep the layout)."""
    leaves = [leaf for _, leaf in tree_leaves(period)]
    slots = tuple(i for i, leaf in enumerate(leaves)
                  if isinstance(leaf, StreamedWeight))
    buckets: dict = {}
    for s in slots:
        buckets.setdefault(_key(leaves[s].ct), []).append(leaves[s])
    for handles in buckets.values():
        # a rank's shard rows are gathered into a new layout every layer
        if any(collectives.is_placed(h.ct) for h in handles):
            continue
        if len(handles) > 1 and not all(
                adjacent([getattr(flatten_blocks(
                    slice_stacked(h.ct, 0).streams), field)
                    for h in handles])
                for field in BlockStreams._fields
                if handles[0].ct.streams.high.shape[-1] or field != "high"):
            _lay_out(handles)
    return OverlapSchedule(leaves=leaves, slots=slots, n_periods=n_periods,
                           buckets_per_layer=len(buckets), period=period)


def _layer_cts(schedule: OverlapSchedule, index: int) -> list:
    return [slice_stacked(schedule.leaves[s].ct, index)
            for s in schedule.slots]


def slot_buffers(schedule: OverlapSchedule) -> list:
    """One slot: a (nblocks, block_elems) bit tensor per decoder bucket of
    a layer, in ``Codec.plan_decode``'s bucket order, on the streams'
    device."""
    buckets: dict = {}
    for ct in _layer_cts(schedule, 0):
        if ct.mode == "enec":
            # a placed tensor decodes whole, once gathered
            nb = (flatten_blocks(ct.streams).mask.shape[0]
                  * collectives.shard_scale(ct))
            key = _key(ct)
            buckets[key] = buckets.get(key, 0) + nb
    dev = schedule.leaves[schedule.slots[0]].ct.streams.mask.device
    return [torch.empty((nb, key[2]), dtype=FORMATS[key[0]].bits_dtype,
                        device=dev)
            for key, nb in buckets.items()]


def gather_layer(cts: list, mesh, axis: str, codec=None) -> list:
    """A layer's per-layer tensors with every placed one gathered over the
    mesh ``axis``: the members of each decoder bucket that holds a placed
    one (in slot order, as ``Codec.plan_decode`` groups them) laid out in
    one new buffer a bucket, member after member, so the bucket's decode
    reads each stream array as one view.  A member this rank holds whole
    (a MoE expert stack's own experts: ``collectives.localize_ct``) is
    copied into its rows; a placed one gathers into them."""
    buckets: dict = {}
    for i, ct in enumerate(cts):
        if ct.mode == "enec":
            buckets.setdefault(_key(ct), []).append(i)
    A = mesh.shape.get(axis, 1)
    cts, outs = list(cts), [None] * len(cts)
    for members in buckets.values():
        if not any(collectives.is_placed(cts[i]) for i in members):
            continue
        for i, whole in zip(members, collectives.whole_streams(
                [cts[i] for i in members], A)):
            if collectives.is_placed(cts[i]):
                outs[i] = whole
                continue
            for a, w in zip(cts[i].streams, whole):
                w.copy_(a)
            cts[i] = dataclasses.replace(cts[i], streams=whole)
    # one call: every member's broadcasts are in flight together
    return collectives.gather_cts(cts, mesh, axis, codec, outs)


def decode_layer(schedule: OverlapSchedule, index: int, codec=None,
                 out=None) -> tuple:
    """ONE batched decode of every streamed leaf's layer ``index`` (one
    launch per bucket, into ``out`` from :func:`slot_buffers` when given):
    the dense weights in slot order, bitwise equal to
    ``StreamedWeight.materialize`` of the same slice.  Under a serving
    mesh the layer's shards are gathered first (:func:`gather_layer`)."""
    codec = codec or current_codec()
    handles = [schedule.leaves[s] for s in schedule.slots]
    cts = _layer_cts(schedule, index)
    ctx = collectives.serving_mesh()
    if ctx is not None:
        cts = gather_layer(cts, *ctx, codec)
    decs = codec.execute(codec.plan_decode(cts), out=out)
    return tuple(torch.movedim(d, 0, h.tp_axis).to(getattr(torch, h.dtype_str))
                 for h, d in zip(handles, decs))


def _resolved_slice(schedule: OverlapSchedule, index: int, decoded,
                    codec=None):
    """Layer ``index`` of the period with its streamed leaves replaced by
    the prefetched weights, resolved for the layer functions."""
    slots = set(schedule.slots)
    position = iter(range(len(schedule.leaves)))

    def take(_, leaf):
        if next(position) in slots:
            return leaf                 # replaced by resolve(prefetched=)
        return leaf.layer(index) if is_handle(leaf) else leaf[index]

    tree = tree_map_with_path(take, schedule.period)
    return resolve(tree, codec,
                   prefetched=dict(zip(schedule.slots, decoded)))


def _take(tree, index: int):
    """Layer ``index`` of every tensor of a leading-(P,) pytree."""
    return tree_map_with_path(lambda _, a: a[index], tree)


def side_stream(device) -> Optional["torch.cuda.Stream"]:
    """The stream the prefetch runs on: the innermost
    :func:`use_side_stream`'s, else one per device for the process; None
    on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stream = _SIDE.get()
    if stream is None:
        stream = _DEFAULT_SIDE.get(device)
        if stream is None:
            stream = _DEFAULT_SIDE[device] = torch.cuda.Stream(device)
    return stream


@contextlib.contextmanager
def use_side_stream(stream):
    """Run the prefetch of every pipeline inside the block on ``stream``."""
    token = _SIDE.set(stream)
    try:
        yield stream
    finally:
        _SIDE.reset(token)


def pipeline_unrolled(schedule: OverlapSchedule, apply_fn: Callable,
                      carry0, *, xs_extra=None, codec=None):
    """The pipelined layer loop: ``apply_fn(carry, resolved_slice,
    extra_slice, index) -> (carry, y)`` runs one period; ``xs_extra`` is
    an optional pytree of leading-(P,) tensors sliced alongside.  Decodes
    layer 0, then issues layer i+1's decode before running layer i.
    Returns ``(carry, [y_0, ..., y_{P-1}])``."""
    codec = codec or current_codec()
    P = schedule.n_periods
    dev = schedule.leaves[schedule.slots[0]].ct.streams.mask.device
    bufs = [slot_buffers(schedule) for _ in range(2)]
    side = side_stream(dev)
    main = torch.cuda.current_stream(dev) if side is not None else None
    ready = [None] * P          # event: layer i's decode is done
    freed = [None] * P          # event: layer i's compute has read its slot

    def issue(i):
        if side is None:
            return decode_layer(schedule, i, codec, out=bufs[i % 2])
        if i == 0:
            side.wait_stream(main)       # the fork: inputs and buffers ready
        elif i >= 2:
            side.wait_event(freed[i - 2])
        with torch.cuda.stream(side):
            dec = decode_layer(schedule, i, codec, out=bufs[i % 2])
            ready[i] = torch.cuda.Event()
            ready[i].record(side)
        return dec

    carry, ys = carry0, []
    dec = issue(0)
    for i in range(P):
        dec_next = issue(i + 1) if i + 1 < P else None
        if side is not None:
            main.wait_event(ready[i])    # the last one joins the side stream
        extra = None if xs_extra is None else _take(xs_extra, i)
        carry, y = apply_fn(carry, _resolved_slice(schedule, i, dec, codec),
                            extra, i)
        if side is not None:
            freed[i] = torch.cuda.Event()
            freed[i].record(main)
        ys.append(y)
        dec = dec_next
    return carry, ys


# the reference's lax.scan driver; the port's layer loop is a Python loop
pipeline_scan = pipeline_unrolled
