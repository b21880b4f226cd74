"""Device meshes over ``torch.distributed`` ranks (port of
``repro/launch/mesh.py``).

A :class:`Mesh` is the world of ranks laid out row-major over named axes,
as ``jax.make_mesh`` lays out devices: ``.shape`` is an ordered dict such
as ``{"data": 2, "model": 2}``, so the sharding rules of
``runtime/sharding.py`` read it as they read a JAX mesh.  Each rank knows
its coordinate on every axis and holds one process group per axis of more
than one rank: the ranks that share every other coordinate.

The world comes from the launcher's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), as ``python -m
torch.distributed.run`` sets it (:func:`init_process_group`).  The backend
is chosen by one rule and printed: NCCL when every rank of a host has a
card of its own, else gloo (the CPU, and ranks that share a card: NCCL
refuses two ranks on one device).  Rank r runs on ``cuda:(LOCAL_RANK %
device_count)``.

:func:`gather_whole` rebuilds whole dense tensors from the ranks' shards
(the training mesh's parameter gather), and :meth:`Mesh.gather_all` /
:meth:`Mesh.barrier` / :meth:`Mesh.world_max` are the small collectives
of the training loop, all built on :meth:`Mesh.broadcast`.

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.serve --smoke --device cpu --tp 4
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.codec_api import current_codec


class Mesh:
    """This rank's view of a mesh of ``math.prod(shape)`` ranks.

    ``shape`` maps axis name to size in axis order; ``coords`` this rank's
    index on each axis; ``device`` the device its tensors live on.  The
    collectives the port needs go through :meth:`broadcast`, one call per
    shard owner, on the backend the world was set up with."""

    def __init__(self, shape, axes, *, rank: int = 0, groups=None,
                 device="cpu"):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ "
                             f"in length")
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.rank = int(rank)
        self.coords = dict(zip(axes, (int(c) for c in
                                      _unravel(self.rank, shape))))
        self.groups = dict(groups or {})   # axis -> (ranks, process group)
        self.device = torch.device(device)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def axis_ranks(self, axis: str) -> tuple:
        """Global ranks along ``axis`` through this rank, by coordinate."""
        if axis not in self.shape or self.shape[axis] == 1:
            return (self.rank,)
        return self.groups[axis][0]

    def broadcast(self, tensor: torch.Tensor, owner: int, axis: str,
                  async_op: bool = False):
        """``tensor`` from the rank at coordinate ``owner`` of ``axis`` to
        every rank along it, in place (contiguous tensors only); with
        ``async_op`` the work to wait on."""
        ranks, group = self.groups[axis]
        return dist.broadcast(tensor, src=ranks[owner], group=group,
                              async_op=async_op)

    def axis_backend(self, axis: str) -> str:
        """The backend of ``axis``'s process group ("gloo" / "nccl")."""
        return dist.get_backend(self.groups[axis][1])

    def all_gather_rows(self, staging: torch.Tensor, axis: str):
        """Fill ``staging`` (A rows, this rank's row already in place)
        with every rank's row of ``axis`` by one asynchronous
        ``all_gather_into_tensor``; returns the work to wait on."""
        me = self.axis_index(axis)
        return dist.all_gather_into_tensor(
            staging.view(-1), staging[me].clone(),
            group=self.groups[axis][1], async_op=True)

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Chunk ``c`` of ``t``'s dim 0 (``A`` equal chunks) to the rank at
        coordinate ``c`` of ``axis``: returns the chunks every rank sent
        this one, in coordinate order (one ``all_to_all_single``)."""
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(),
                               group=self.groups[axis][1])
        return out

    def gather_all(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each), stacked in rank
        order: ``(size, *t.shape)``; counted on no link."""
        return gather_whole([t[None]], [(self.axis_names,)], self,
                            link=None)[0]

    def world_max(self, value: float) -> float:
        """The largest of every rank's ``value``: one decision the whole
        world agrees on."""
        t = torch.tensor(float(value), dtype=torch.float64,
                         device=self.device)
        return float(self.gather_all(t).max())

    def barrier(self) -> None:
        """No rank leaves before every rank has arrived (a gather of one
        byte over every axis)."""
        self.gather_all(torch.zeros((), dtype=torch.uint8,
                                    device=self.device))


class _Done:
    """The finished work of a recorded collective."""

    def wait(self):
        return None


class AbstractMesh(Mesh):
    """Rank ``rank``'s view of a mesh with no process group and no world:
    every collective that :class:`Mesh` would start is recorded in
    :attr:`records` as ``(kind, result_bytes, group_size)``
    (``launch/collective_stats.py``) instead of run, and its result is
    left as it is (the dry-run's ``meta`` tensors hold no data).  It
    stands for a mesh of a card a rank, so the stream gather takes the
    NCCL branch: one all-gather an axis."""

    def __init__(self, shape, axes, *, rank: int = 0, device="meta"):
        super().__init__(shape, axes, rank=rank, device=device)
        self.records: list = []

    def record(self, kind: str, nbytes: int, axis: str) -> None:
        self.records.append((kind, int(nbytes), self.shape.get(axis, 1)))

    def axis_ranks(self, axis: str) -> tuple:
        if self.shape.get(axis, 1) == 1:
            return (self.rank,)
        sizes = tuple(self.shape.values())
        a = self.axis_names.index(axis)
        coord = [self.coords[n] for n in self.axis_names]
        out = []
        for c in range(sizes[a]):
            coord[a] = c
            out.append(_ravel(coord, sizes))
        return tuple(out)

    def broadcast(self, tensor: torch.Tensor, owner: int, axis: str,
                  async_op: bool = False):
        self.record("broadcast", tensor.numel() * tensor.element_size(),
                    axis)
        return _Done() if async_op else None

    def axis_backend(self, axis: str) -> str:
        return "nccl"

    def all_gather_rows(self, staging: torch.Tensor, axis: str):
        self.record("all-gather", staging.numel() * staging.element_size(),
                    axis)
        return _Done()

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        self.record("all-to-all", t.numel() * t.element_size(), axis)
        return torch.empty_like(t)


def _gather_plan(spec, mesh) -> list:
    """``(dim, axis)`` gathers that rebuild a tensor sharded by ``spec``:
    each sharded dim over its axes of more than one rank, the minor axis of
    a tuple first (``sharding.local_shard`` splits a dim major to
    minor)."""
    plan = []
    for d, names in enumerate(spec):
        if names is None:
            continue
        names = names if isinstance(names, tuple) else (names,)
        plan += [(d, n) for n in reversed(names) if mesh.shape.get(n, 1) > 1]
    return plan


def _start_dense_gather(t: torch.Tensor, d: int, mesh: Mesh, axis: str):
    """Start gathering every owner's ``t`` along ``axis`` into dim ``d``
    (one asynchronous broadcast an owner into its row of a staging buffer,
    as bytes: every backend broadcasts uint8); returns the function that
    waits and returns the whole."""
    A, me = mesh.shape[axis], mesh.axis_index(axis)
    staging = torch.empty((A, *t.shape), dtype=t.dtype, device=t.device)
    staging[me].copy_(t)
    rows = staging.view(A, -1).view(torch.uint8)
    works = [mesh.broadcast(rows[c], c, axis, async_op=True)
             for c in range(A)]

    def finish() -> torch.Tensor:
        for work in works:
            work.wait()
        return staging.movedim(0, d).reshape(
            *t.shape[:d], A * t.shape[d], *t.shape[d + 1:])

    return finish


def gather_whole(tensors, specs, mesh: Mesh, *, codec=None,
                 link: Optional[str] = "d2d_allgather") -> list:
    """The whole dense tensors whose shards ``tensors`` are on this rank,
    each cut by its spec in ``specs`` (``runtime/sharding.py``'s specs;
    a tensor sharded on no axis of more than one rank comes back as it
    is).  Each sharded dim is gathered over its axes by one broadcast an
    owner; every broadcast of a round (the i-th gather of every tensor) is
    issued before the first is waited on.  Each gather is counted on
    ``link`` of ``codec`` (the ambient codec by default; ``None``: not
    counted) as dense bytes: ``(A - 1) x`` the bytes it gathered, the
    traffic of its axis, as ``runtime/collectives.py`` counts a stream
    gather, one op each."""
    out = list(tensors)
    plans = [_gather_plan(spec, mesh) for spec in specs]
    if link is not None:
        codec = codec or current_codec()
    for step in range(max(map(len, plans), default=0)):
        pending = []
        for i, plan in enumerate(plans):
            if step < len(plan):
                d, axis = plan[step]
                pending.append((i, axis, _start_dense_gather(out[i], d, mesh,
                                                             axis)))
        for i, axis, finish in pending:
            out[i] = finish()
            if link is not None:
                codec.count_link(link, (mesh.shape[axis] - 1) * out[i].numel()
                                 * out[i].element_size(), dense=True)
    return out


def _unravel(rank: int, shape) -> list:
    out = []
    for size in reversed(shape):
        out.append(rank % size)
        rank //= size
    return out[::-1]


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def choose_backend(device, local_world: int, device_count: int) -> str:
    """NCCL when each rank of this host has a card of its own, else gloo
    (every CPU world, and ranks that share a card)."""
    if torch.device(device).type == "cuda" and local_world <= device_count:
        return "nccl"
    return "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` for a CUDA
    world, the CPU for a CPU one."""
    dev = torch.device(device)
    if dev.type != "cuda" or world_size() == 1:
        return dev
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_process_group(device="cuda") -> Optional[str]:
    """Join the world the launcher's environment describes (once per
    process); returns its backend, or None for a world of one rank, which
    needs no process group."""
    if dist.is_initialized():
        return dist.get_backend()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return None
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev, local_world, count)
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world)
    if dist.get_rank() == 0:
        print(f"[mesh] world of {world} ranks on {dev.type} "
              f"({count} cards, {local_world} ranks on this host): "
              f"backend {backend}", flush=True)
    return backend


def make_mesh(shape, axes, device="cuda") -> Mesh:
    """The world as a mesh of ``shape`` over ``axes`` (row-major ranks);
    the world's size must be ``math.prod(shape)``.  Every rank calls this
    with the same arguments: it makes every axis group on every rank in the
    same order (``dist.new_group`` is collective)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world = world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    if world > 1:
        init_process_group(device)
    rank = dist.get_rank() if world > 1 else 0
    groups = {}
    for a, axis in enumerate(axes):
        if shape[a] == 1:
            continue
        others = [range(s) for i, s in enumerate(shape) if i != a]
        for rest in itertools.product(*others):
            ranks = []
            for c in range(shape[a]):
                coord = list(rest)
                coord.insert(a, c)
                ranks.append(_ravel(coord, shape))
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = (tuple(ranks), group)
    return Mesh(shape, axes, rank=rank, groups=groups,
                device=rank_device(device))


def _ravel(coord, shape) -> int:
    r = 0
    for c, s in zip(coord, shape):
        r = r * s + c
    return r


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod.  Raises
    unless the world has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def largest_model_axis(n: int, cap=None) -> int:
    """Largest divisor of ``n`` not exceeding ``cap`` (default ``n``): the
    widest tensor-parallel axis a ``(data, model)`` factorisation of ``n``
    ranks supports."""
    cap = n if cap is None else max(1, min(int(cap), n))
    for m in range(cap, 0, -1):
        if n % m == 0:
            return m
    return 1


def host_mesh_shape(n: int, *, model=None, max_model=None) -> dict:
    """The axes :func:`make_host_mesh` lays ``n`` ranks out on: the 1-D
    ``("data",)`` mesh by default; ``model`` an int (dividing ``n``) or
    ``"max"`` (the largest divisor, capped by ``max_model``) for a 2-D
    ``(data, model)`` one."""
    if model is None and max_model is None:
        return {"data": n}
    if model in (None, "max"):
        model = largest_model_axis(n, max_model)
    model = int(model)
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide the {n} "
                         f"ranks of the world")
    return {"data": n // model, "model": model}


def make_host_mesh(*, model=None, max_model=None, device="cuda") -> Mesh:
    """The whole world as an examples/tests mesh (:func:`host_mesh_shape`
    over the world size): four ranks with ``model=2`` give a (2, 2)
    ``(data, model)`` mesh."""
    shape = host_mesh_shape(world_size(), model=model, max_model=max_model)
    return make_mesh(tuple(shape.values()), tuple(shape), device)
