"""Sharding rules: DP / TP / EP / SP / pod-DP placement specs (port of
``repro/runtime/sharding.py``).

Logical layout (single pod 16x16, multi-pod 2x16x16):
  * batch            -> ("pod", "data") when divisible (pure DP across pods)
  * vocab / heads / ffn / experts / d_inner -> "model"  (TP / EP)
  * decode KV-cache sequence -> "model" (+ "pod" for long-context cells)
  * params replicated across "pod"

A spec is a plain tuple with one entry per tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names; it equals
``tuple(PartitionSpec(...))`` of the reference.  The rules read only
``mesh.shape`` (a dict of axis sizes), so a :class:`~repro_torch.launch.
mesh.Mesh` or any object with such a ``shape`` works.  Axes are dropped
when a dim does not divide by the mesh axis (replicate).

The reference's ``to_named`` (specs to ``NamedSharding``) has no
counterpart: a rank holds its own slice of a tensor, cut by
:func:`local_shard`.

**The K/V ring's sequence** (:func:`kv_layout`) goes where
:func:`cache_pspecs` puts it, under one rule of the port's own: a rank's
slice must be a whole number of ``DECODE_CHUNK`` (1024) positions, that
is ``S % (A x DECODE_CHUNK) == 0`` for the product ``A`` of the sequence
axes; otherwise the ring is replicated, as :func:`_maybe` replicates a dim
that does not divide.  The decode attention's sums run chunk by chunk in
order (``models/layers.py:rank_decode_attention``), and a chunk cut
between two ranks could not give one device's bits.

**The recurrent states and the encoder memory** go where
:func:`cache_pspecs` puts them too (``docs/PORT.md`` convention 13):
Mamba's ``h`` (periods, B, d_inner, d_state) and ``conv`` (periods, B,
K - 1, d_inner) each put their LAST dim on "model" where it divides
(:func:`state_layout`: ``h`` by ``d_state``, not by its channels, as the
reference's code does it; ``conv`` by its channels), each decided alone;
whisper's ``mem_k`` / ``mem_v`` put their sequence where ``k`` / ``v``
put theirs, under the same whole-chunk rule (:func:`kv_layout` of the
memory's length, never pinned: a memory that cannot be sharded stays
whole).  An sLSTM's ``h`` (periods, B, D) puts its D on "model" where
it divides, as the reference's rule for every leaf named ``h`` does, and
its ``c`` / ``n`` / ``m`` and the mLSTM states stay on the batch
(``docs/PORT.md`` convention 14; :func:`state_layout` of ``d_slstm``).
:func:`port_cache_pspecs` is :func:`cache_pspecs` under these rules.

**MoE expert stacks** (:func:`expert_layout`) go where
:func:`param_pspec` puts them for serving: E on "model" where it divides,
so each rank holds, decodes and multiplies only its own experts; and, for
dense stacks, each expert matrix's OUTPUT dim on "data" (F of ``e_gate`` /
``e_up``, D of ``e_down``).  The reference splits ``e_down``'s F there,
and under ``serve_ep`` every contracting dim, which its psum reassociates;
the port's canonical tiled matmul keeps each output's k order whole, so
a column slice of a product is that product's columns bit for bit and
both modes place the same bytes (``docs/PORT.md`` convention 11).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.api import CompressedTensor
from repro_torch.launch.mesh import gather_whole
from repro_torch.runtime.weights import (DenseWeight, is_handle,
                                         tree_map_with_path)


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= _axis_size(mesh, n)
        return out
    return mesh.shape[name] if name in mesh.shape else 1


def _fits(dim: int, mesh, name) -> bool:
    size = _axis_size(mesh, name)
    return size > 1 and dim % size == 0


def _present(mesh, name):
    """Drop axis names that don't exist in this mesh; collapse tuples."""
    if name is None:
        return None
    if isinstance(name, (tuple, list)):
        kept = tuple(n for n in name if n in mesh.shape)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return name if name in mesh.shape else None


def _maybe(dim: int, mesh, name):
    """axis name if present and divisible, else None (replicate)."""
    name = _present(mesh, name)
    return name if name is not None and _fits(dim, mesh, name) else None


def batch_axis(mesh, b: int):
    """Largest of ("pod","data") / "data" / None that divides the batch."""
    full = _present(mesh, ("pod", "data"))
    if full is not None and _fits(b, mesh, full):
        return full
    if _fits(b, mesh, "data"):
        return "data"
    return None


def replicated(rank: int) -> tuple:
    return (None,) * rank


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_pspec(path: str, shape, mesh, mode: str = "train") -> tuple:
    """TP(+EP) rules by leaf name; leading stack dims stay unsharded.

    mode="train" also FSDP-shards the non-TP matrix dim over "data";
    mode="serve" keeps weights TP-only, except MoE expert stacks (E on
    model x F on data); mode="serve_ep" shards the expert stacks'
    contracting dim on data."""
    rank = len(shape)
    lead = (None,) * (rank - 2)
    name = path.rsplit("/", 1)[-1]
    fsdp = "data" if mode == "train" else None

    def last2(a, b):
        return (*lead, a, b)

    def m(dim, ax):
        return _maybe(dim, mesh, ax)

    # stream arrays reached as bare path leaves replicate: handles and
    # CompressedTensors are leaves of param_pspecs, placed by their own
    # layout metadata (handle_pspecs / ct_pspecs)
    if "/streams/" in path or "/ct/" in path:
        return replicated(rank)
    if name == "embed":
        return (m(shape[0], "model"), m(shape[1], fsdp))
    if name == "head":
        return (m(shape[0], fsdp), m(shape[1], "model"))
    if rank == 1 or "norm" in name or name in ("conv_b", "dt_bias", "d_skip",
                                               "a_log"):
        return replicated(rank)
    if name in ("e_gate", "e_up", "e_down"):
        if mode == "serve_ep" or name == "e_down":
            return (*(None,) * (rank - 3), m(shape[-3], "model"),
                    m(shape[-2], "data"), None)
        return (*(None,) * (rank - 3), m(shape[-3], "model"), None,
                m(shape[-1], "data"))
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "x_proj",
                "dt_proj", "w_in", "r_in", "wi", "wf", "wo_gate", "router"):
        return last2(m(shape[-2], fsdp), m(shape[-1], "model"))
    if name in ("wo", "w_down", "out_proj"):
        return last2(m(shape[-2], "model"), m(shape[-1], fsdp))
    if name == "conv_w":
        return last2(None, m(shape[-1], "model"))
    return replicated(rank)


def ct_stacked(ct: CompressedTensor) -> bool:
    """Does the stream layout carry a leading layer-stack dim?"""
    base = 3 if ct.shards > 1 else 2
    return ct.streams.mask.ndim == base + 1


def shard_dim(ct: CompressedTensor) -> int:
    """The TP-shard dim of an enec tensor's stream arrays: 1 under a layer
    stack, else 0."""
    return 1 if ct_stacked(ct) else 0


def _stream_leaf_rule(ct: CompressedTensor, mesh, axis="model"):
    """Spec rule for one CompressedTensor's stream arrays, from the
    tensor's own layout: the TP-shard dim goes on ``axis`` when
    ``ct.shards`` divides by the mesh axis; const / raw payloads and
    unsharded streams replicate.  A rank's own slice of a placed tensor
    (the shard dim cut to ``shards / A``) gets the spec of the whole."""
    ax = None
    d = 0
    if ct.mode == "enec" and ct.shards > 1:
        d = shard_dim(ct)
        ax = _maybe(ct.shards, mesh, axis)

    def rule(a: torch.Tensor) -> tuple:
        names = [None] * a.ndim
        if ax is not None and a.ndim > d and a.shape[d] in (
                ct.shards, ct.shards // _axis_size(mesh, ax)):
            names[d] = ax
        return tuple(names)

    return rule


def ct_pspecs(ct: CompressedTensor, mesh, axis="model"):
    """The specs of one bare :class:`CompressedTensor`, in the leaf order
    of the reference's pytree: a :class:`BlockStreams` of specs for an enec
    tensor, the ``raw_bytes`` payload's spec for const / raw."""
    rule = _stream_leaf_rule(ct, mesh, axis)
    if ct.mode == "enec":
        return ct.streams.map(rule)
    return rule(ct.raw_bytes)


def handle_pspecs(handle, mesh, axis="model"):
    """The specs of one serving weight handle, from its metadata: stream /
    fused handles shard their streams' TP dim on ``axis``; a dense handle
    replicates (the dense math runs replicated, so sharded logits equal the
    single-device ones bit for bit); a handle holding no tensor (an expert
    store's) has none."""
    ct = getattr(handle, "ct", None)
    if ct is not None:
        return ct_pspecs(ct, mesh, axis)
    if isinstance(handle, DenseWeight):
        return replicated(handle.w.ndim)
    return None


def param_pspecs(params, mesh, mode: str = "train"):
    """Whole-tree specs: weight handles and CompressedTensors get their
    metadata's stream specs; plain tensors the name / shape rules of
    :func:`param_pspec`."""
    def one(path, leaf):
        if is_handle(leaf):
            return handle_pspecs(leaf, mesh)
        if isinstance(leaf, CompressedTensor):
            return ct_pspecs(leaf, mesh)
        return param_pspec(path, tuple(leaf.shape), mesh, mode)

    return tree_map_with_path(one, params)


# ---------------------------------------------------------------------------
# batches, caches, outputs
# ---------------------------------------------------------------------------

def batch_pspecs(specs: dict, mesh, global_batch: int) -> dict:
    ba = batch_axis(mesh, global_batch)
    out = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = cache_pspecs(v, mesh, global_batch)
        else:
            out[k] = (ba, *((None,) * (len(v.shape) - 1)))
    return out


def _seq_axes_wanted(ba):
    """The axes the reference puts a K/V sequence on: "model" beside a
    sharded batch, else ("pod", "model") (the long-context path)."""
    return "model" if ba is not None else ("pod", "model")


def _cache_spec(name: str, shape: tuple, mesh, ba) -> tuple:
    if name == "lengths":
        return (ba,)
    if name in ("k", "v", "mem_k", "mem_v"):
        # (periods, B, S, KV, hd)
        seq_axes = _maybe(shape[2], mesh, _seq_axes_wanted(ba))
        return (None, ba, seq_axes, None, None)
    if name in ("h", "conv"):        # mamba state / conv window
        ch = _maybe(shape[-1], mesh, "model")
        return (None, ba, *((None,) * (len(shape) - 3)), ch)
    if name in ("c", "n", "m"):      # mlstm / slstm states
        return (None, ba, *((None,) * (len(shape) - 2)))
    return replicated(len(shape))


def cache_pspecs(cache, mesh, b: int):
    """KV caches: batch on data(+pod) when divisible, else the sequence dim
    on ("pod","model") (the long-context path).  SSM states: batch, else
    channel on model."""
    ba = batch_axis(mesh, b)
    return tree_map_with_path(
        lambda path, leaf: _cache_spec(path.rsplit("/", 1)[-1],
                                       tuple(leaf.shape), mesh, ba), cache)


# ---------------------------------------------------------------------------
# the K/V ring's sequence on a serving mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class KVLayout:
    """How one rank of ``mesh`` holds the sequence of a K/V ring of
    ``length`` positions: its block of ``length / count`` positions from
    ``offset`` when ``axes`` (major to minor) is not empty, else the whole
    ring, ``why`` saying why."""
    mesh: object
    axes: tuple
    length: int
    why: str = ""

    @property
    def sharded(self) -> bool:
        return bool(self.axes)

    @property
    def count(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes)

    @property
    def index(self) -> int:
        """This rank's block, major to minor (as :func:`local_shard`)."""
        index = 0
        for a in self.axes:
            index = index * self.mesh.shape[a] + self.mesh.coords.get(a, 0)
        return index

    @property
    def local_length(self) -> int:
        return self.length // self.count

    @property
    def offset(self) -> int:
        return self.index * self.local_length

    def spec(self):
        """The sequence dim's entry of a spec (None: replicated)."""
        if not self.axes:
            return None
        return self.axes if len(self.axes) > 1 else self.axes[0]

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` along ``dim`` in position order, over the
        sequence axes (``launch/mesh.py:gather_whole``: one broadcast an
        owner, counted as dense bytes on ``d2d_allgather``)."""
        spec = [None] * t.ndim
        spec[dim] = self.spec()
        return gather_whole([t], [tuple(spec)], self.mesh)[0]

    def describe(self) -> str:
        if not self.sharded:
            return f"whole ({self.length} positions on every rank: " \
                   f"{self.why})"
        return (f"sequence-sharded over {'x'.join(self.axes)} "
                f"({self.count} ranks x {self.local_length} positions; "
                f"this rank from {self.offset})")


def kv_layout(mesh, length: int, batch=None, pin: bool = False) -> KVLayout:
    """The K/V ring's sequence layout on ``mesh``: the axes
    :func:`cache_pspecs` gives it (beside a batch of ``batch`` rows sharded
    by its rule; ``None``: every rank holds every row, as the serving
    engine does), kept only where a rank's slice is a whole number of
    ``DECODE_CHUNK`` positions, ``length % (A x DECODE_CHUNK) == 0``;
    otherwise the ring is whole on every rank.  ``pin``
    (``cfg.decode_score_shard``, the reference's flash-decoding pin) on a
    ring that rule keeps whole raises: there are no sharded scores to
    pin.  A mesh with no sequence axis of more than one rank holds the
    ring whole, and the pin has nothing to act on there, as on one
    device."""
    from repro_torch.models.layers import DECODE_CHUNK
    ba = None if batch is None else batch_axis(mesh, batch)
    wanted = _seq_axes_wanted(ba)
    name = _present(mesh, wanted)
    A = _axis_size(mesh, name)
    if A <= 1:
        return KVLayout(mesh, (), length, f"no sequence axis {wanted} of "
                        f"more than one rank")
    if length % (A * DECODE_CHUNK):
        why = (f"{length} positions % ({A} ranks x DECODE_CHUNK "
               f"{DECODE_CHUNK}) != 0: a rank's slice must be whole "
               f"{DECODE_CHUNK}-position chunks")
        if pin:
            raise ValueError(f"decode_score_shard pins the decode scores "
                             f"sequence-sharded, but this K/V ring cannot "
                             f"be sharded: {why}")
        return KVLayout(mesh, (), length, why)
    return KVLayout(mesh, name if isinstance(name, tuple) else (name,),
                    length)


@dataclasses.dataclass(frozen=True, eq=False)
class StateLayout:
    """How one rank of ``mesh`` holds a program's recurrent decode states.
    A Mamba block's (``d_inner`` > 0): its block of ``h``'s ``d_state``
    (``h`` is (B, d_inner, d_state)) when ``h_axis`` is set, and its block
    of ``conv``'s ``d_inner`` channels (``conv`` is (B, K - 1, d_inner))
    when ``conv_axis`` is set.  An sLSTM block's (``d_slstm`` > 0, its
    width D): its block of ``h``'s D (``h`` is (B, D)) when
    ``slstm_axis`` is set; its ``c`` / ``n`` / ``m`` are whole on every
    rank.  A leaf whose axis is None is whole on every rank, ``why``
    saying why.  ``rows`` is the batch's axis (None: every rank holds
    every row)."""
    mesh: object
    d_inner: int
    d_state: int
    h_axis: object = None
    conv_axis: object = None
    rows: object = None
    why: str = ""
    d_slstm: int = 0
    slstm_axis: object = None

    @property
    def sharded(self) -> bool:
        return any(a is not None for a in (self.h_axis, self.conv_axis,
                                           self.slstm_axis))

    @property
    def kind(self) -> str:
        """The blocks it holds states of: "Mamba", "sLSTM" or both."""
        return " and ".join(k for k, n in (("Mamba", self.d_inner),
                                           ("sLSTM", self.d_slstm)) if n)

    def _block(self, axis, n: int) -> tuple:
        """``(lo, hi)`` of this rank's block of ``n`` along ``axis``."""
        if axis is None:
            return 0, n
        step = n // _axis_size(self.mesh, axis)
        lo = self.mesh.coords.get(axis, 0) * step
        return lo, lo + step

    @property
    def state_block(self) -> tuple:
        """This rank's ``(s0, s1)`` of ``d_state``."""
        return self._block(self.h_axis, self.d_state)

    @property
    def channel_block(self) -> tuple:
        """This rank's ``(c0, c1)`` of ``d_inner``."""
        return self._block(self.conv_axis, self.d_inner)

    @property
    def slstm_block(self) -> tuple:
        """This rank's ``(d0, d1)`` of an sLSTM ``h``'s D."""
        return self._block(self.slstm_axis, self.d_slstm)

    def gather(self, t: torch.Tensor, dim: int, axis) -> torch.Tensor:
        """Every rank's ``t`` along ``dim`` in block order over ``axis``
        (``launch/mesh.py:gather_whole``: one broadcast an owner, counted
        as dense bytes on ``d2d_allgather``)."""
        spec = [None] * t.ndim
        spec[dim] = axis
        return gather_whole([t.contiguous()], [tuple(spec)], self.mesh)[0]

    def step_gather_bytes(self, rows: int, mamba: int = 1,
                          slstm: int = 1) -> int:
        """Dense bytes a decode step of ``mamba`` Mamba layers and
        ``slstm`` sLSTM layers gathers on a rank of ``rows`` rows
        (``gather_whole`` counts ``(A - 1) x`` the whole): for a Mamba
        layer the bf16 conv output ``x`` (rows, d_inner) where ``conv`` is
        sharded and the f32 read-out products (rows, d_inner, d_state)
        where ``h`` is; for an sLSTM layer its bf16 ``h`` (rows, D) where
        ``h`` is sharded."""
        one = 0
        if self.conv_axis is not None:
            one += (_axis_size(self.mesh, self.conv_axis) - 1) * rows \
                * self.d_inner * 2
        if self.h_axis is not None:
            one += (_axis_size(self.mesh, self.h_axis) - 1) * rows \
                * self.d_inner * self.d_state * 4
        out = mamba * one
        if self.slstm_axis is not None:
            out += slstm * (_axis_size(self.mesh, self.slstm_axis) - 1) \
                * rows * self.d_slstm * 2
        return out

    @property
    def gathered(self) -> str:
        """What a decode step gathers, in words."""
        return " and ".join(w for w, n in (
            ("the conv output and the read-out's products", self.d_inner),
            ("the bf16 sLSTM h", self.d_slstm)) if n)

    def describe(self) -> str:
        def one(name, axis, n, dim, block):
            if axis is None:
                return f"{name} whole"
            lo, hi = block
            return (f"{name} {dim} {lo}:{hi} of {n} over {axis} "
                    f"({_axis_size(self.mesh, axis)} ranks)")
        parts = []
        if self.d_inner:
            parts += [one("h", self.h_axis, self.d_state, "d_state",
                          self.state_block),
                      one("conv", self.conv_axis, self.d_inner, "channels",
                          self.channel_block)]
        if self.d_slstm:
            parts += [one("h", self.slstm_axis, self.d_slstm, "D",
                          self.slstm_block), "c / n / m whole"]
        rows = "" if self.rows is None else f"; rows on {self.rows}"
        why = f" ({self.why})" if self.why else ""
        return ", ".join(parts) + rows + why


def state_layout(mesh, d_inner: int, d_state: int, batch=None,
                 d_slstm: int = 0) -> StateLayout:
    """A program's recurrent decode states' layout on ``mesh``, as
    :func:`cache_pspecs` places them: a Mamba state's (``d_inner`` > 0)
    ``h`` (B, d_inner, d_state) and ``conv`` (B, K - 1, d_inner) and an
    sLSTM state's (``d_slstm`` > 0) ``h`` (B, D) each put their last dim
    on "model" where it divides (the reference's ``_maybe(shape[-1],
    mesh, "model")``), each decided alone; the sLSTM's ``c`` / ``n`` /
    ``m`` stay whole; the rows beside them on the batch's axis for
    ``batch`` rows (``None``: every rank holds every row, as the serving
    engine does)."""
    rows = None if batch is None else batch_axis(mesh, batch)
    leaves = []
    if d_inner:
        leaves += [("h", d_state, "d_state"), ("conv", d_inner, "channels")]
    if d_slstm:
        leaves.append(("sLSTM h", d_slstm, "D"))
    axes = {name: _maybe(n, mesh, "model") for name, n, _ in leaves}
    A = _axis_size(mesh, _present(mesh, "model"))
    why = []
    if A > 1:
        why += [f"{name}: {dim} {n} % {A} model ranks != 0"
                for name, n, dim in leaves if axes[name] is None]
    else:
        why.append("no model axis of more than one rank")
    return StateLayout(mesh, d_inner, d_state, axes.get("h"),
                       axes.get("conv"), rows, "; ".join(why), d_slstm,
                       axes.get("sLSTM h"))


def memory_layout(mesh, length: int, batch=None) -> KVLayout:
    """The encoder memory's sequence layout (whisper's ``mem_k`` /
    ``mem_v`` of ``length`` positions): :func:`kv_layout`'s axes and
    whole-chunk rule, never pinned (``cfg.decode_score_shard`` pins the
    self-attention ring): a memory that cannot be sharded stays whole."""
    return kv_layout(mesh, length, batch=batch, pin=False)


def port_cache_pspecs(cache, mesh, b: int, layout: KVLayout):
    """:func:`cache_pspecs` under the port's rules: the K/V rings'
    sequence as ``layout`` holds it; a Mamba state's ``h`` and ``conv``
    by :func:`state_layout` (their last dims on "model" where they
    divide); an sLSTM's ``h`` its D on "model" where it divides (its
    ``c`` / ``n`` / ``m`` and the mLSTM states on the batch only); the
    encoder memory by :func:`memory_layout` of its length."""
    ba = batch_axis(mesh, b)

    def spec_for(path, leaf) -> tuple:
        name = path.rsplit("/", 1)[-1]
        shape = tuple(leaf.shape)
        spec = _cache_spec(name, shape, mesh, ba)
        if len(spec) < 2:
            return spec
        rest = [None] * (len(spec) - 2)
        if name in ("k", "v"):
            rest[0] = layout.spec()
        elif name in ("mem_k", "mem_v"):
            rest[0] = memory_layout(mesh, shape[2], batch=b).spec()
        elif name in ("h", "conv"):     # Mamba's, and an sLSTM's h
            rest[-1] = spec[-1]
        return (spec[0], spec[1], *rest)

    return tree_map_with_path(spec_for, cache)


# ---------------------------------------------------------------------------
# MoE expert stacks on a serving mesh
# ---------------------------------------------------------------------------

EXPERT_LEAVES = ("e_gate", "e_up", "e_down")
EXPERT_MODES = ("serve", "serve_ep")


def is_expert_leaf(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in EXPERT_LEAVES


@dataclasses.dataclass(frozen=True, eq=False)
class ExpertLayout:
    """What one rank of ``mesh`` holds of a MoE layer's expert stacks
    (``n_experts`` experts of ``e_gate`` / ``e_up`` (D, F) and ``e_down``
    (F, D)): its block of ``local_experts`` experts from ``offset`` when
    ``expert_axis`` is set, else every expert; and, when ``data_axis`` is
    set, its block of each matrix's OUTPUT columns (F of ``e_gate`` /
    ``e_up``, D of ``e_down``: ``docs/PORT.md`` convention 11), else whole
    matrices.  ``why`` says why an axis was not used."""
    mesh: object
    n_experts: int
    d_model: int
    d_ff: int
    expert_axis: object = None
    data_axis: object = None
    mode: str = "serve"
    why: str = ""

    @property
    def expert_count(self) -> int:
        return _axis_size(self.mesh, self.expert_axis)

    @property
    def data_count(self) -> int:
        return _axis_size(self.mesh, self.data_axis)

    @property
    def local_experts(self) -> int:
        return self.n_experts // self.expert_count

    @property
    def offset(self) -> int:
        """This rank's first expert."""
        if self.expert_axis is None:
            return 0
        return self.mesh.coords.get(self.expert_axis, 0) * self.local_experts

    def leaf_spec(self, ndim: int) -> tuple:
        """The spec of an expert leaf of ``ndim`` dims (leading layer-stack
        dims unsharded): E on the expert axis, the output dim (the last of
        every expert matrix) on the data axis."""
        lead = (None,) * (ndim - 3)
        return (*lead, self.expert_axis, None, self.data_axis)

    def nbytes(self, n_layers: int, itemsize: int = 2) -> int:
        """Bytes of this rank's share of ``n_layers`` layers' three expert
        stacks."""
        return (n_layers * self.local_experts * 3 * self.d_model * self.d_ff
                // self.data_count * itemsize)

    def exchange_bytes(self, rows: int, capacity: int, acc_size: int,
                       rows_sharded: bool = False) -> int:
        """Activation bytes this rank receives in one MoE block of ``rows``
        rows (the rank's own rows when ``rows_sharded``: its block of the
        batch on "data") at capacity ``capacity``, combining in
        ``acc_size``-byte floats: the dispatch of the own experts' bf16
        ``x_ec`` from every data rank's rows and the return of each data
        rank's rows of the f32 ``y`` (an all-to-all), where the rows are
        sharded and the columns split; else the all-gather of ``y``'s
        columns; the bf16 ``h`` all-gathered over the data axis along F;
        the combine's all-gather of every rank's experts' weighted outputs
        over the expert axis, in the combine's dtype."""
        A_d, A_m = self.data_count, self.expert_count
        e, d, f = self.local_experts, self.d_model, self.d_ff
        out = 0
        if A_d > 1:
            every = rows * A_d if rows_sharded else rows
            out += (A_d - 1) * e * every * capacity * f // A_d * 2
            out += (A_d - 1) * rows * e * capacity * d // A_d * 4
            if rows_sharded:
                out += (A_d - 1) * rows * e * capacity * d * 2
        if A_m > 1:
            out += (A_m - 1) * rows * e * capacity * d * acc_size
        return out

    def describe(self) -> str:
        if self.expert_axis is None:
            experts = f"all {self.n_experts} experts on every rank"
        else:
            experts = (f"{self.local_experts} of {self.n_experts} experts "
                       f"from {self.offset} over {self.expert_axis} "
                       f"({self.expert_count} ranks)")
        cols = ("whole matrices" if self.data_axis is None else
                f"1/{self.data_count} of each matrix's output columns over "
                f"{self.data_axis}")
        why = f" ({self.why})" if self.why else ""
        return f"{experts}, {cols}{why} [{self.mode}]"


def expert_layout(mesh, n_experts: int, d_model: int, d_ff: int, *,
                  dense: bool = True, mode: str = "serve") -> ExpertLayout:
    """The expert stacks' layout on a serving ``mesh``, as
    :func:`param_pspec` places them in ``mode="serve"`` (the default) or
    ``"serve_ep"``, under the port's rules (``docs/PORT.md`` convention
    11): E on "model" where it divides (the reference's :func:`_maybe`),
    else every expert on every rank; on "data", for ``dense`` stacks only,
    each matrix's output dim (F of ``e_gate`` / ``e_up``, D of
    ``e_down``) where both divide, else whole.  The reference splits a
    contracting dim on "data" (``e_down``'s F; every expert matrix's under
    ``serve_ep``); the port keeps each output's k order whole, so both
    modes place the same: a rank holds the same bytes either way.  A
    compressed stack (``dense=False``) is placed by its stream rows on
    "model" only (:func:`~repro_torch.runtime.collectives.localize_ct`)."""
    if mode not in EXPERT_MODES:
        raise ValueError(f"unknown expert layout mode {mode!r}; expected "
                         f"one of {EXPERT_MODES}")
    why = []
    experts = _maybe(n_experts, mesh, "model")
    if experts is None and _axis_size(mesh, _present(mesh, "model")) > 1:
        why.append(f"{n_experts} experts % {mesh.shape['model']} model "
                   f"ranks != 0: the stacks stay whole on every rank")
    data = None
    if _axis_size(mesh, _present(mesh, "data")) > 1:
        if not dense:
            why.append("compressed stacks keep whole matrices on data")
        elif _maybe(d_ff, mesh, "data") and _maybe(d_model, mesh, "data"):
            data = "data"
        else:
            why.append(f"d_ff {d_ff} or d_model {d_model} % "
                       f"{mesh.shape['data']} data ranks != 0: whole "
                       f"matrices")
    return ExpertLayout(mesh, n_experts, d_model, d_ff, experts, data, mode,
                        "; ".join(why))


def held_expert_layout(mesh, n_experts: int, d_model: int, gate_shape,
                       down_shape, mode: str = "serve") -> ExpertLayout:
    """The layout of the expert stacks a rank holds, read from one layer's
    ``e_gate`` (E', D, F') and ``e_down`` (E', F, D') shapes: E' of
    ``n_experts`` (its block on "model", or all of them), F' and D' whole
    or both its block on "data".  Raises on a share no layout gives."""
    d_ff = int(down_shape[-2])
    held_e, held_f, held_d = (int(gate_shape[-3]), int(gate_shape[-1]),
                              int(down_shape[-1]))
    expert_axis = data_axis = None
    if held_e != n_experts:
        expert_axis = _present(mesh, "model")
        if expert_axis is None or held_e * _axis_size(
                mesh, expert_axis) != n_experts:
            raise ValueError(f"a rank holds {held_e} of {n_experts} "
                             f"experts: no expert layout of mesh "
                             f"{dict(mesh.shape)} gives that")
    if (held_f, held_d) != (d_ff, d_model):
        data_axis = _present(mesh, "data")
        A = _axis_size(mesh, data_axis)
        if data_axis is None or (held_f * A, held_d * A) != (d_ff, d_model):
            raise ValueError(f"a rank holds ({held_f}, {held_d}) of the "
                             f"expert matrices' output dims ({d_ff}, "
                             f"{d_model}): no expert layout of mesh "
                             f"{dict(mesh.shape)} gives that")
    return ExpertLayout(mesh, n_experts, d_model, d_ff, expert_axis,
                        data_axis, mode)


def logits_pspec(mesh, b: int, vocab: int) -> tuple:
    return (batch_axis(mesh, b), _maybe(vocab, mesh, "model"))


# ---------------------------------------------------------------------------
# a rank's slice
# ---------------------------------------------------------------------------

def spec_leaves(tree, path: str = ""):
    """(path, spec) pairs of a spec tree, named as ``core.api.tree_leaves``
    names the tree's leaves: dicts (sorted keys), lists and NamedTuples
    (by field) are walked; a plain tuple is one spec; ``None`` (a handle
    without tensors) yields nothing."""
    if tree is None:
        return
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        yield path, tree
        return
    if hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from spec_leaves(v, f"{path}/{k}" if path else k)
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from spec_leaves(tree[k], f"{path}/{k}" if path else str(k))
        return
    for i, v in enumerate(tree):
        yield from spec_leaves(v, f"{path}/{i}" if path else str(i))


def local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` under ``spec`` (a view):
    every sharded dim cut to the rank's block along its axes (a tuple of
    axes splits the dim major-to-minor, as a JAX mesh does)."""
    for d, names in enumerate(spec):
        if names is None:
            continue
        names = names if isinstance(names, tuple) else (names,)
        index, count = 0, 1
        for n in names:
            size = mesh.shape.get(n, 1)
            index = index * size + mesh.coords.get(n, 0)
            count *= size
        if t.shape[d] % count:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"over {names} ({count} ranks)")
        step = t.shape[d] // count
        t = t.narrow(d, index * step, step)
    return t


__all__ = ["batch_axis", "param_pspec", "param_pspecs", "ct_pspecs",
           "handle_pspecs", "batch_pspecs", "cache_pspecs", "logits_pspec",
           "KVLayout", "kv_layout", "port_cache_pspecs", "StateLayout",
           "state_layout", "memory_layout",
           "ExpertLayout", "expert_layout", "held_expert_layout",
           "is_expert_leaf", "local_shard", "spec_leaves", "shard_dim", "ct_stacked"]
