"""Compressed-bytes collectives: mesh placement and gathering of ENEC
stream bundles (port of ``repro/runtime/collectives.py``).

The sharded serving model is FSDP of compressed bytes:

  * At rest each rank holds ONLY its TP shard of every sharded stream: the
    streams' shard dim (``CompressedTensor.shards``) cut to the rank's
    rows on the mesh ``"model"`` axis (:func:`place_serving_tree`, or
    straight from a checkpoint through :func:`stream_placer` and
    ``wire.from_wire(stream_place=)``).  A placed tensor keeps the whole
    tensor's metadata; its shard dim holds ``shards / A`` rows.
  * When a layer is used, the missing shards are gathered as fixed-length
    wire payloads over the axis (:func:`gather_ct`): one broadcast from
    each shard owner (its rows of every stream array, packed) into a
    staging buffer allocated once per gather, so only compressed bytes
    cross between ranks; then one decode runs locally on
    every rank (``StreamedWeight.materialize``, ``FusedWeight.matmul`` and
    the overlap prefetch call :func:`maybe_gather_ct` first).
  * The dense math runs replicated, so sharded logits equal single-device
    logits bit for bit in every mode.

**Gathered at each use, never kept.**  The reference caches an eager
gather on its source tensor, and its served step is traced, where nothing
is cached and every step gathers.  The port runs eagerly: a kept gather
would leave every rank holding every shard after the first step and the
mesh would save no memory.  So every use gathers, and the buffer goes with
the decode that read it.  Within one step the tied embedding and head share
one gather (the model decodes the embedding once a step and uses it for
both).

**The ledger.**  Every gather performed is counted on the codec's
``d2d_allgather`` link: ``(A - 1) x stream_nbytes`` compressed bytes, the
traffic of the whole axis, and one op per stream array, as the reference
counts one gather.  The reference counts a gather inside a jit trace once
per trace; the port counts it once per execution, so a step's count is the
bytes that step moved.

The collective is :meth:`~repro_torch.launch.mesh.Mesh.broadcast` on gloo
(the CPU, and ranks that share a card) and one
``all_gather_into_tensor`` on NCCL (a card a rank; not yet run: one card
gives no NCCL world).  :func:`gather_rows` gathers every rank's flat
streams rank-major, for ``optim/grad_compress.py``.

:func:`shard_local_decode` is the no-traffic variant: each rank decodes
only its own block shard, and the pieces of every rank together are the
whole decode bit for bit (per-block decode is independent).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.api import CompressedTensor, precompute_wire_bytes
from repro_torch.core.codec import BlockStreams, flatten_blocks
from repro_torch.core.codec_api import current_codec
from repro_torch.launch.mesh import gather_whole
from repro_torch.runtime import sharding
from repro_torch.runtime.weights import (StreamedWeight, is_handle,
                                         tree_leaves, tree_map_with_path)

MODEL_AXIS = "model"


# ---------------------------------------------------------------------------
# the ambient serving mesh
# ---------------------------------------------------------------------------

_mesh_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_serving_mesh", default=None)
_rows_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_serving_rows", default=(None, "serve"))


def serving_mesh():
    """The ambient ``(mesh, axis)`` installed by :func:`use_serving_mesh`,
    or ``None``: read by :func:`maybe_gather_ct`, so handles gather without
    a mesh threaded through every signature."""
    return _mesh_ctx.get()


def serving_rows() -> tuple:
    """``(rows, expert_mode)`` of the ambient serving mesh: the axis (or
    axes) the program's rows of the batch are sharded on (``None``: every
    rank holds every row, as the serving engine does) and the expert
    layout's mode (``sharding.EXPERT_MODES``)."""
    return _rows_ctx.get()


@contextlib.contextmanager
def use_serving_mesh(mesh, axis: str = MODEL_AXIS, rows=None,
                     expert_mode: str = "serve"):
    """Install ``mesh`` as the ambient serving mesh for the block: every
    handle use inside gathers its compressed shards over ``axis`` first,
    and the MoE block exchanges its experts' activations over the mesh
    (:func:`expert_dispatch`).  ``rows``: the axis the program's rows are
    sharded on (``None``: every rank holds every row); ``expert_mode``:
    the expert layout's mode ("serve" or "serve_ep", which place the same
    in the port: ``sharding.expert_layout``)."""
    if expert_mode not in sharding.EXPERT_MODES:
        raise ValueError(f"unknown expert layout mode {expert_mode!r}; "
                         f"expected one of {sharding.EXPERT_MODES}")
    token = _mesh_ctx.set((mesh, axis))
    rows_token = _rows_ctx.set((rows, expert_mode))
    try:
        yield mesh
    finally:
        _rows_ctx.reset(rows_token)
        _mesh_ctx.reset(token)


# ---------------------------------------------------------------------------
# the expert-parallel MoE block's activation exchanges
# ---------------------------------------------------------------------------

# the activation bytes the MoE blocks' exchanges received in this process
# (process-global, as the launch counters are)
_EXCHANGED = [0]


def expert_exchange_bytes() -> int:
    """The activation bytes this rank has received in the expert-parallel
    MoE blocks' exchanges (an all-gather of a part of P bytes over A
    ranks: (A - 1) x P; an all-to-all of T bytes: (A - 1) / A x T).
    Never weight bytes."""
    return _EXCHANGED[0]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def gather_acts(t: torch.Tensor, dim: int, mesh, axis) -> torch.Tensor:
    """Every rank's ``t`` along ``dim`` over ``axis``, in coordinate
    order (``launch/mesh.py:gather_whole``: one broadcast an owner),
    counted on the exchange ledger, not on any link of the codec."""
    A = _axis_count(mesh, axis)
    if A <= 1:
        return t
    spec = [None] * t.ndim
    spec[dim] = axis
    out = gather_whole([t.contiguous()], [tuple(spec)], mesh, link=None)[0]
    _EXCHANGED[0] += (A - 1) * _nbytes(t)
    return out


def _rows_on(rows, axis: str) -> bool:
    """Are the program's rows (``serving_rows()[0]``) sharded on
    ``axis``?"""
    return axis in (rows if isinstance(rows, tuple) else (rows,))


def expert_dispatch(x_own: torch.Tensor, layout, rows=None
                    ) -> torch.Tensor:
    """The expert-parallel dispatch: ``x_own`` (B, E', C, D), the capacity
    pick of this rank's own experts from its own rows, becomes what the
    layout's products need (``sharding.ExpertLayout``).  Where the
    experts' output columns are split over "data" and the rows are
    sharded there too, every data rank's rows: an all-gather over "data"
    (B x A_d rows, data coordinate major); otherwise the rank's rows are
    every row its products need, and nothing moves.  The move made is
    recorded: on :func:`expert_exchange_bytes`, and as its broadcasts
    under a mesh
    that records its collectives (the dry-run's ``AbstractMesh``).  The
    reference's ``dispatch_a2a`` reshards ``x_ec`` onto the contracting
    dim instead; the port splits no contracting dim (``docs/PORT.md``
    convention 11), so both dispatches are this one."""
    if layout.data_axis is None or not _rows_on(rows, layout.data_axis):
        return x_own
    return gather_acts(x_own, 0, layout.mesh, layout.data_axis)


def expert_return(y: torch.Tensor, layout, rows=None) -> torch.Tensor:
    """The products' output back to the rows that routed to them: ``y``
    (B', E', C, D') holds this rank's column block of its experts' outputs
    for every row its products ran on; returns (B, E', C, D), whole
    columns for the rank's own rows.  Rows sharded on "data": each data
    rank's rows sent back to it (one all-to-all over "data"); every row
    on every rank: the column blocks all-gathered over "data"."""
    axis = layout.data_axis
    if axis is None:
        return y
    mesh, A = layout.mesh, layout.data_count
    if not _rows_on(rows, axis):
        return gather_acts(y, y.ndim - 1, mesh, axis)
    out = mesh.all_to_all(y.contiguous(), axis)
    _EXCHANGED[0] += (A - 1) * _nbytes(y) // A
    b = y.shape[0] // A
    # chunk c: this rank's rows, data rank c's column block
    return out.view(A, b, *y.shape[1:]).movedim(0, -2).reshape(
        b, *y.shape[1:-1], A * y.shape[-1])


def expert_combine(contrib: torch.Tensor, layout) -> torch.Tensor:
    """Every rank's experts' weighted outputs (B, E', C, D) for the rank's
    rows, all-gathered over the expert axis in coordinate order, which is
    ascending expert order: (B, E, C, D).  Each rank then folds them as
    one device does; no partial sum crosses between ranks."""
    if layout.expert_axis is None:
        return contrib
    return gather_acts(contrib, 1, layout.mesh, layout.expert_axis)


# ---------------------------------------------------------------------------
# which tensors shard, and how
# ---------------------------------------------------------------------------

def _axis_count(mesh, axis) -> int:
    return mesh.shape[axis] if axis in mesh.shape else 1


def _shardable(ct, A: int) -> bool:
    return (isinstance(ct, CompressedTensor) and ct.mode == "enec"
            and ct.shards > 1 and A > 1 and ct.shards % A == 0)


def is_placed(ct: CompressedTensor) -> bool:
    """Does ``ct`` hold only some of its shards (a rank's slice)?"""
    return (ct.mode == "enec" and ct.shards > 1
            and ct.streams.mask.shape[sharding.shard_dim(ct)] < ct.shards)


def shard_scale(ct: CompressedTensor) -> int:
    """The whole tensor's stream rows over the rows ``ct`` holds: ``A``
    for a rank's slice on an ``A``-rank axis, else 1."""
    if not is_placed(ct):
        return 1
    return ct.shards // ct.streams.mask.shape[sharding.shard_dim(ct)]


def stream_nbytes(ct: CompressedTensor) -> int:
    """Bytes of the whole tensor's device stream layout (>= the exact
    ``nbytes_wire``: the high stream is padded to its static bound); a
    placed tensor counts every shard, not only its own."""
    return shard_scale(ct) * sum(a.numel() * a.element_size()
                                 for a in ct.streams)


def _own_rows(shards: int, mesh, axis: str) -> tuple:
    """``(start, count)`` of this rank's rows of ``shards`` along the
    shard dim."""
    count = shards // _axis_count(mesh, axis)
    return mesh.axis_index(axis) * count, count


def place_ct(ct: CompressedTensor, mesh, axis: str = MODEL_AXIS
             ) -> CompressedTensor:
    """This rank's slice of a whole ``ct``: its own shard rows of every
    stream array, copied out so the rest can be freed; other tensors (and
    an already placed one) are returned as they are."""
    if not _shardable(ct, _axis_count(mesh, axis)) or is_placed(ct):
        return ct
    ct.nbytes_wire()            # the whole record's size, kept below
    specs = sharding.ct_pspecs(ct, mesh, axis)
    out = dataclasses.replace(ct, streams=BlockStreams(*(
        sharding.local_shard(a, spec, mesh).clone()
        for a, spec in zip(ct.streams, specs))))
    out._wire_bytes = ct._wire_bytes
    return out


def _expert_dims(path: str, shape) -> tuple:
    """``(E, D, F)`` of an expert leaf of ``shape``: (..., E, D, F) for
    ``e_gate`` / ``e_up``, (..., E, F, D) for ``e_down``."""
    e, a, b = (int(v) for v in shape[-3:])
    return (e, b, a) if path.rsplit("/", 1)[-1] == "e_down" else (e, a, b)


def _layer_shape(leaf):
    """The shape of one layer's weight of a MoE leaf (a stacked tensor or
    a stream handle), or None (an expert store's handle)."""
    if isinstance(leaf, StreamedWeight):
        return tuple(leaf.layer_shape)
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape[1:])
    return None


def _moe_blocks(tree) -> dict:
    """The MoE blocks of a serving tree: ``{parent path: {leaf name:
    (path, leaf)}}`` of each router and expert stack."""
    out: dict = {}
    for path, leaf in tree_leaves(tree):
        prefix, _, name = path.rpartition("/")
        if name == "router" or name in sharding.EXPERT_LEAVES:
            out.setdefault(prefix, {})[name] = (path, leaf)
    return out


def leaf_expert_layout(path: str, leaf, mesh, expert_mode: str = "serve"):
    """The ``sharding.expert_layout`` of one whole expert leaf of a serving
    tree on ``mesh``: a dense MoE expert stack (a tensor) or a compressed
    one (a stream handle of the expert-major layout); ``None`` for any
    other leaf."""
    if not sharding.is_expert_leaf(path):
        return None
    if isinstance(leaf, torch.Tensor):
        shape, dense = leaf.shape, True
    elif isinstance(leaf, StreamedWeight) and leaf.tp_axis == 0:
        shape, dense = leaf.layer_shape, False
    else:
        return None
    return sharding.expert_layout(mesh, *_expert_dims(path, shape),
                                  dense=dense, mode=expert_mode)


def expert_layouts(tree, mesh, expert_mode: str = "serve") -> dict:
    """``{path: ExpertLayout}`` of the expert stacks of a serving tree that
    a rank holds whole, each as :func:`leaf_expert_layout` places it.  A
    stack is whole when it holds every expert its block's router routes
    to; a rank's share (placed already) is not placed again, so placing a
    tree twice (a restore, then the launcher) is placing it once."""
    out = {}
    for leaves in _moe_blocks(tree).values():
        router = leaves.get("router")
        n = None if router is None else _layer_shape(router[1])[-1]
        for name in sharding.EXPERT_LEAVES:
            if name not in leaves:
                continue
            path, leaf = leaves[name]
            layout = leaf_expert_layout(path, leaf, mesh, expert_mode)
            if layout is not None and n in (None, layout.n_experts):
                out[path] = layout
    return out


def localize_ct(ct: CompressedTensor, layout, axis: str = MODEL_AXIS
                ) -> CompressedTensor:
    """The rank's own experts of a compressed expert stack (a layer stack
    of the expert-major layout, whole or placed on ``axis``) as a
    compressed tensor of those experts alone: its own shard rows, with
    ``shape`` (E / A, ...) and ``shards / A``.  A rank then decodes its
    own experts locally, and nothing of the stack is ever gathered.  The
    shard rows must be whole experts: ``A`` divides ``shards`` and a
    rank's rows hold exactly ``E / A`` experts (no block padding between
    them); otherwise the placement is refused."""
    A = layout.expert_count
    E = layout.n_experts
    if ct.mode != "enec" or ct.shards % A or not sharding.ct_stacked(ct) \
            or tuple(ct.shape)[0] != E:
        raise ValueError(
            f"cannot place this expert stack by experts on {A} ranks: "
            f"mode {ct.mode}, {ct.shards} stream shards, shape "
            f"{tuple(ct.shape)} (need an enec layer stack of {E} experts "
            f"whose shard count divides by {A}; serve it with --shards a "
            f"multiple of {A})")
    rows = ct.shards // A
    per_rank = rows * ct.streams.mask.shape[2] * ct.block_elems
    per_expert = math.prod(ct.shape[1:])
    if per_rank != E // A * per_expert:
        raise ValueError(
            f"the stream shards of this expert stack do not fall on expert "
            f"boundaries: a rank's {rows} of {ct.shards} shards hold "
            f"{per_rank} elements, its {E // A} experts {E // A * per_expert} "
            f"(the layer's {E * per_expert} elements pad to whole "
            f"{ct.block_elems}-element blocks per shard)")
    held = ct.streams.mask.shape[1]
    if held == ct.shards:               # whole: cut out this rank's rows
        start = layout.mesh.axis_index(axis) * rows
        streams = ct.streams.map(lambda a: a.narrow(1, start, rows).clone())
    elif held == rows:                  # placed (a mesh restore's upload)
        streams = ct.streams
    else:
        raise ValueError(f"expert stack holds {held} of {ct.shards} "
                         f"shards; a {A}-rank axis needs {rows}")
    if rows == 1:                       # an unsharded layout has no dim
        streams = streams.map(lambda a: a.squeeze(1))
    return dataclasses.replace(ct, streams=streams, shards=rows,
                               shape=(E // A, *ct.shape[1:]))


def place_expert(leaf, layout, mesh, axis: str = MODEL_AXIS):
    """This rank's share of one expert leaf under ``layout``: a dense
    stack cut to its experts and output columns (copied out, so the rest
    can be freed); a compressed one to its own experts'
    (:func:`localize_ct`), or left as it is where the layout keeps the
    stacks whole."""
    if isinstance(leaf, torch.Tensor):
        spec = layout.leaf_spec(leaf.ndim)
        if all(a is None for a in spec):
            return leaf
        return sharding.local_shard(leaf, spec, mesh).clone()
    if layout.expert_axis is None:
        return leaf
    ct = localize_ct(leaf.ct, layout, axis)
    return dataclasses.replace(leaf, ct=ct, layer_shape=tuple(ct.shape))


def serving_pspecs(tree, mesh, axis: str = MODEL_AXIS):
    """Specs of a serving tree: handles and CompressedTensors get their
    metadata's stream specs (:func:`sharding.handle_pspecs`), whole MoE
    expert stacks their ``sharding.expert_layout``'s (a compressed stack's
    stream rows on ``axis`` where the experts split there, else
    replicated), every other plain tensor replicates: the dense math runs
    whole."""
    layouts = expert_layouts(tree, mesh)

    def one(path, leaf):
        layout = layouts.get(path)
        if layout is not None and isinstance(leaf, torch.Tensor):
            return layout.leaf_spec(leaf.ndim)
        if layout is not None and layout.expert_axis is None:
            return leaf.ct.streams.map(lambda a: sharding.replicated(a.ndim))
        if is_handle(leaf):
            return sharding.handle_pspecs(leaf, mesh, axis)
        if isinstance(leaf, CompressedTensor):
            return sharding.ct_pspecs(leaf, mesh, axis)
        return sharding.replicated(leaf.ndim)

    return tree_map_with_path(one, tree)


def place_serving_tree(tree, mesh, axis: str = MODEL_AXIS):
    """The tree as this rank holds it on ``mesh`` (:func:`serving_pspecs`):
    each sharded stream cut to the rank's own shard rows, each whole MoE
    expert stack to the rank's share (:func:`place_expert`; a share placed
    already is kept), everything else replicated (kept whole)."""
    # one host copy of every high_len fills the wire-size caches
    precompute_wire_bytes([
        ct for _, leaf in tree_leaves(tree)
        if isinstance(ct := getattr(leaf, "ct", leaf), CompressedTensor)])
    layouts = expert_layouts(tree, mesh)

    def one(path, leaf):
        if path in layouts:
            return place_expert(leaf, layouts[path], mesh, axis)
        if sharding.is_expert_leaf(path):
            return leaf                 # this rank's share already
        if is_handle(leaf) and isinstance(getattr(leaf, "ct", None),
                                          CompressedTensor):
            return dataclasses.replace(leaf, ct=place_ct(leaf.ct, mesh, axis))
        if isinstance(leaf, CompressedTensor):
            return place_ct(leaf, mesh, axis)
        return leaf

    return tree_map_with_path(one, tree)


def expert_census(tree, mesh=None, expert_mode: str = "serve"):
    """What this rank holds of a serving tree's MoE expert stacks, read
    from the leaves themselves: ``layout`` (the first block's
    ``sharding.held_expert_layout``, described), ``bytes`` on its device,
    ``stream_nbytes`` (the compressed stacks' whole stream layouts: what a
    stream gather of every shard, the rule before the expert layout,
    moves ``(A - 1)`` times a use) and ``placed`` (stacks held as placed
    shard rows, which a use would gather: none once
    :func:`place_serving_tree` has placed them).  ``None`` for a tree
    without MoE blocks or with an expert store's handles."""
    blocks = _moe_blocks(tree)
    if not blocks:
        return None
    layout, held = None, {"bytes": 0, "stream_nbytes": 0, "placed": 0}
    for leaves in blocks.values():
        shapes = {n: _layer_shape(leaf) for n, (_, leaf) in leaves.items()}
        if any(v is None for v in shapes.values()):
            return None
        router = shapes["router"]
        mine = sharding.held_expert_layout(
            mesh, router[-1], router[-2], shapes["e_gate"],
            shapes["e_down"], expert_mode)
        layout = layout or mine
        for name in sharding.EXPERT_LEAVES:
            leaf = leaves[name][1]
            ct = getattr(leaf, "ct", None)
            if isinstance(ct, CompressedTensor):
                held["bytes"] += ct.nbytes_device()
                held["stream_nbytes"] += stream_nbytes(ct) * \
                    mine.expert_count
                held["placed"] += is_placed(ct)
            else:
                held["bytes"] += _nbytes(leaf)
    return {"layout": layout.describe(), **held}


def stream_placer(mesh, axis: str = MODEL_AXIS):
    """The ``wire.from_wire(stream_place=)`` hook of a mesh restore:
    ``place(shards) -> (start, count)`` of the shard rows this rank
    uploads, or ``None`` to upload every row (an unsharded record, or a
    shard count the axis does not divide)."""
    A = _axis_count(mesh, axis)

    def place(shards: int):
        if shards <= 1 or A <= 1 or shards % A:
            return None
        return _own_rows(shards, mesh, axis)

    return place


# ---------------------------------------------------------------------------
# the compressed-bytes all-gather
# ---------------------------------------------------------------------------

_ALIGN = 16


def _offsets(sizes) -> tuple:
    """16-byte aligned offsets of byte runs of ``sizes`` laid end to end,
    and their total."""
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // _ALIGN) * _ALIGN
    return offs, total


def whole_streams(cts, A: int) -> list:
    """Empty stream arrays of the whole tensors that the placed ``cts``
    are slices of (on an ``A``-rank axis; a tensor held whole keeps its
    own shapes), as views of ONE new byte buffer: each stream array's
    region holds every tensor's whole array, one after another.  For one
    layer of a decoder bucket's members that is the prefetch's bucket
    layout (``runtime/overlap.py``), which the bucket's decode reads as
    one view."""
    first = cts[0].streams
    shapes = []
    for ct in cts:
        d, scale = sharding.shard_dim(ct), A if is_placed(ct) else 1
        shapes.append([tuple(a.shape[:d]) + (a.shape[d] * scale,)
                       + tuple(a.shape[d + 1:]) for a in ct.streams])
    counts = [[torch.Size(s).numel() for s in member] for member in shapes]
    sizes = [sum(c[k] for c in counts) * a.element_size()
             for k, a in enumerate(first)]
    offs, total = _offsets(sizes)
    buf = torch.empty(total, dtype=torch.uint8, device=first.mask.device)
    regions = [buf[o:o + n].view(a.dtype)
               for o, n, a in zip(offs, sizes, first)]
    out, starts = [], [0] * len(first)
    for member, count in zip(shapes, counts):
        arrays = []
        for k, (shape, n) in enumerate(zip(member, count)):
            arrays.append(regions[k][starts[k]:starts[k] + n].view(shape))
            starts[k] += n
        out.append(BlockStreams(*arrays))
    return out


def _start_gather(streams: BlockStreams, whole: BlockStreams, d: int,
                  mesh, axis: str):
    """Start gathering every owner's rows of ``streams`` (this rank's are
    ``streams``) into ``whole`` along dim ``d``; returns the function that
    waits and unpacks.  ONE broadcast per owner: the owner packs its rows
    of the five stream arrays into its row of a staging buffer, which goes
    to every rank at once; the broadcasts run asynchronously (a rank sends
    its row while it receives the others'), and each rank then unpacks
    every owner's rows into theirs (one copy an array for a per-layer
    tensor).  On an NCCL axis one ``all_gather_into_tensor`` fills the
    staging buffer instead (gloo gathers no CUDA tensors)."""
    A = _axis_count(mesh, axis)
    sizes = [a.numel() * a.element_size() for a in streams]
    offs, seg = _offsets(sizes)
    staging = torch.empty((A, seg), dtype=torch.uint8,
                          device=streams.mask.device)
    me = mesh.axis_index(axis)

    def part(row, k):
        a = streams[k]
        return row[..., offs[k]:offs[k] + sizes[k]].view(a.dtype)

    for k, a in enumerate(streams):
        part(staging[me], k).view(a.shape).copy_(a)
    if mesh.axis_backend(axis) == "nccl":
        works = [mesh.all_gather_rows(staging, axis)]
    else:
        # bytes are bytes: every backend broadcasts uint8
        works = [mesh.broadcast(staging[owner], owner, axis, async_op=True)
                 for owner in range(A)]

    def finish():
        for work in works:
            work.wait()
        for k, (a, w) in enumerate(zip(streams, whole)):
            if not sizes[k]:
                continue
            if d == 0:           # owner c's rows are rows [c*n, (c+1)*n)
                w.view(A, -1).copy_(part(staging, k))
                continue
            n = a.shape[d]
            for owner in range(A):
                w.narrow(d, owner * n, n).copy_(
                    part(staging[owner], k).view(a.shape))

    return finish


def gather_rows(streams: BlockStreams, mesh, axis: str = MODEL_AXIS
                ) -> BlockStreams:
    """Every rank's flat ``streams`` along ``axis``, rank-major: rank
    ``i``'s blocks are rows ``[i * B, (i + 1) * B)`` of each array (one
    broadcast an owner, or one ``all_gather_into_tensor`` on an NCCL
    axis); counted on no link."""
    A = _axis_count(mesh, axis)
    if A == 1:
        return streams
    whole = streams.map(lambda a: a.new_empty((A * a.shape[0],
                                               *a.shape[1:])))
    _start_gather(streams, whole, 0, mesh, axis)()
    return whole


def gather_cts(cts, mesh, axis: str = MODEL_AXIS, codec=None,
               outs=None) -> list:
    """The compression-aware all-gather of many tensors: the whole stream
    arrays of each placed tensor on every rank of ``axis``, ready for one
    local decode; every broadcast is issued before the first is waited on.
    Only compressed bytes move: ``(A - 1) x stream_nbytes(ct)`` a tensor
    over the axis, counted on ``d2d_allgather`` (never the dense size).
    ``outs`` (whole-tensor stream arrays, e.g. rows of the prefetch's
    bucket layout, or None) receive the gathers; by default
    :func:`whole_streams` allocates them.

    A tensor passes through, counting nothing, where it does not shard:
    raw / const / unsharded tensors, an axis of one rank, a shard count the
    axis does not divide, and a tensor that is whole on this rank already
    (an unplaced tree)."""
    A = _axis_count(mesh, axis)
    codec = codec or current_codec()
    out, pending = [], []
    for ct, whole in zip(cts, outs or [None] * len(cts)):
        if not _shardable(ct, A) or not is_placed(ct):
            out.append(ct)
            continue
        d = sharding.shard_dim(ct)
        if ct.streams.mask.shape[d] * A != ct.shards:
            raise ValueError(f"placed tensor holds "
                             f"{ct.streams.mask.shape[d]} of {ct.shards} "
                             f"shards; a {A}-rank axis needs "
                             f"{ct.shards // A}")
        codec.count_link("d2d_allgather", stream_nbytes(ct) * (A - 1),
                         ops=len(ct.streams))
        whole = whole if whole is not None else whole_streams([ct], A)[0]
        pending.append(_start_gather(ct.streams, whole, d, mesh, axis))
        res = dataclasses.replace(ct, streams=whole)
        res._wire_bytes = ct._wire_bytes
        out.append(res)
    for finish in pending:
        finish()
    return out


def gather_ct(ct: CompressedTensor, mesh, axis: str = MODEL_AXIS,
              codec=None, out: Optional[BlockStreams] = None
              ) -> CompressedTensor:
    """:func:`gather_cts` of one tensor (into ``out`` when given)."""
    return gather_cts([ct], mesh, axis, codec, [out])[0]


def maybe_gather_ct(ct, codec=None):
    """:func:`gather_ct` under the ambient serving mesh; identity without
    one.  The hook every use of a compressed handle calls, so the
    single-device path is untouched."""
    ctx = serving_mesh()
    if ctx is None or not isinstance(ct, CompressedTensor):
        return ct
    mesh, axis = ctx
    return gather_ct(ct, mesh, axis, codec)


def tree_gather_nbytes(tree, mesh, axis: str = MODEL_AXIS) -> int:
    """``stream_nbytes`` summed over the placed tensors of a tree (every
    layer of a stack): what one use of every handle gathers from all
    ranks, so a step that uses each once moves ``(A - 1)`` times this."""
    A = _axis_count(mesh, axis)
    return sum(stream_nbytes(ct) for _, leaf in tree_leaves(tree)
               if _shardable(ct := getattr(leaf, "ct", leaf), A)
               and is_placed(ct))


# ---------------------------------------------------------------------------
# shard-local decode (no traffic between ranks)
# ---------------------------------------------------------------------------

def shard_local_decode(ct: CompressedTensor, mesh, axis: str = MODEL_AXIS,
                       codec=None) -> torch.Tensor:
    """Decode only this rank's block shard of a per-layer enec tensor
    (placed, or whole: then its own rows are cut out), in one decode
    launch: returns the rank's piece of the flattened tensor, elements
    ``[start, stop)`` of ``decompress_array(ct).reshape(-1)``.  The pieces
    of the ranks of ``axis`` in coordinate order are the whole decode bit
    for bit (per-block decode is independent)."""
    if ct.mode != "enec":
        raise ValueError(f"shard_local_decode needs an enec tensor, got "
                         f"mode {ct.mode!r}")
    if ct.shards <= 1:
        raise ValueError("tensor is unsharded: use codec.decompress_array")
    if sharding.ct_stacked(ct):
        raise ValueError("shard_local_decode takes per-layer tensors; "
                         "slice the layer stack first (slice_stacked)")
    A = _axis_count(mesh, axis)
    if A <= 1 or ct.shards % A:
        raise ValueError(f"shards={ct.shards} not divisible over mesh axis "
                         f"{axis!r} of size {A}")
    streams = ct.streams
    start, count = _own_rows(ct.shards, mesh, axis)
    if not is_placed(ct):
        streams = streams.map(lambda a: a.narrow(0, start, count))
    codec = codec or current_codec()
    bits = codec._decode(flatten_blocks(streams), ct.fmt, ct.params,
                         ct.block_elems)
    per_shard = streams.mask.shape[1] * ct.block_elems
    numel = torch.Size(ct.shape).numel()
    lo = start * per_shard
    piece = bits.reshape(-1)[:max(0, min(numel - lo, bits.numel()))]
    return piece.view(ct.fmt.float_dtype)
