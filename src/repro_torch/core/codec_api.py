"""The codec object with its plan/execute split (port of
``repro/core/codec_api.py``).

:class:`Codec` compresses layer stacks and fused-matmul tile streams and
decompresses tensors through an explicit schedule:

* :meth:`Codec.plan_encode` takes statistics of every input on its device,
  brings them to the host in ONE transfer, searches each stack's
  parameters, lays out its blocks, and groups the stacks into
  :class:`EncodeBucket` s keyed on ``(fmt, (n, m, L), block_elems)``; the
  linear-map parameter ``b`` travels as a per-block vector, so stacks with
  different searched ``b`` share a bucket.
* :meth:`Codec.plan_decode` groups compressed tensors the same way
  (:class:`DecodeBucket`; ``(b, l)`` per block).
* :meth:`Codec.execute` launches EXACTLY ``len(plan.buckets)`` encoder or
  decoder calls (``kernels.ops``: the CUDA kernel for CUDA tensors, the
  plain version for CPU ones), plus, for an encode plan, ONE transfer of
  every stack's ``high_len`` for the never-worse escape.

Both planners take a tree (nested dicts, lists and tuples, walked in the
reference's flatten order: sorted dict keys) and ``execute`` returns the
same structure; :meth:`Codec.compress_tree` / :meth:`Codec.decompress_tree`
are that round trip.  A ``None`` leaf stays ``None``.

The reference pads each bucket's block count to a power of two to bound
XLA's compile cache.  The CUDA kernels take any block count and the port
has no compile cache, so a bucket encodes or decodes its true block count:
``block_bucket == nblocks`` always.  That is what the reference's
``plan_decode(exact=True)`` does for the prefetch of ``runtime/overlap.py``,
so the port's planner needs no such switch.

Each codec owns its counters: encode / decode dispatches
(:meth:`encode_cache_stats`, :meth:`decode_cache_stats`) and the per-link
transfer ledger (:meth:`count_link`, :meth:`transfer_stats`).
:func:`use_codec` makes one codec ambient for a block of code
(:func:`current_codec`), so the handles' decodes, the checkpoint manager
and the wire module all count on the codec that a launcher built.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import codec as block_codec
from . import params as params_mod
from . import stats as stats_mod
from .api import (SUPPORTED_FLOAT_DTYPES, CompressedTensor, const_tensor,
                  matmul_tiles, raw_tensor, slice_stacked, tree_leaves,
                  tree_map_with_path)
from .api import untile_matmul_weight as _untile
from .codec import BlockStreams
from .dtypes import DTYPE_NAMES, FloatFormat, format_for
from .params import DEFAULT_BLOCK_ELEMS, EnecParams, expected_ratio

# The kernel routes of the port's codec (the reference names its encode and
# decode backends "reference" / "pallas").  The route is not a setting: a
# CPU tensor runs the plain version, a CUDA tensor the kernel.
BACKENDS = ("plain", "cuda")

# Transfer-ledger links; every byte a codec moves is attributed to one,
# split compressed / dense:
#   h2d            host->device uploads (wire deserialization, raw leaves)
#   d2d_allgather  rank<->rank stream gathers over a mesh axis
#                  (``runtime/collectives.py:gather_ct``)
#   d2d_psum       rank<->rank gradient collectives (none yet: the training
#                  half of the mesh)
#   disk           checkpoint pack-file record reads
LINKS = ("h2d", "d2d_allgather", "d2d_psum", "disk")


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Immutable policy of one :class:`Codec`.

    block_elems
        Default ENEC block size (paper §VI-D: 16384 == one 128x128 tile).
    shared_params
        ``None`` searches parameters per stack from its exponent
        histogram; a fixed :class:`EnecParams` encodes every stack under
        it, widened to the stack's exact exponent range.
    """
    block_elems: int = DEFAULT_BLOCK_ELEMS
    shared_params: Optional[EnecParams] = None

    def __post_init__(self):
        if self.block_elems < 1:
            raise ValueError("block_elems must be >= 1")


@dataclasses.dataclass(frozen=True)
class EncodeBucket:
    """One encoder launch: every member stack shares ``key``."""
    fmt_name: str
    params_key: tuple        # (n, m, L)
    block_elems: int
    block_bucket: int        # blocks the launch encodes (== nblocks)
    nblocks: int
    n_tensors: int
    predicted_wire_bytes: int = 0   # from each member's expected ratio

    @property
    def key(self) -> tuple:
        return (self.fmt_name, self.params_key, self.block_elems)


@dataclasses.dataclass(frozen=True)
class DecodeBucket:
    """One decoder launch; mirror of :class:`EncodeBucket`."""
    fmt_name: str
    params_key: tuple
    block_elems: int
    block_bucket: int
    nblocks: int
    n_tensors: int

    @property
    def key(self) -> tuple:
        return (self.fmt_name, self.params_key, self.block_elems)


@dataclasses.dataclass
class EncodePlan:
    """Inspectable encode schedule over the leaves of a tree:
    ``len(buckets)`` launches; ``n_fallback`` inputs skip the encoder
    (unsupported dtype, empty, or a constant layer)."""
    config: CodecConfig
    buckets: Tuple[EncodeBucket, ...]
    n_inputs: int
    n_fallback: int
    stacked: bool
    shards: int
    block_elems: int = DEFAULT_BLOCK_ELEMS
    _groups: list = dataclasses.field(repr=False, default_factory=list)
    _fallbacks: dict = dataclasses.field(repr=False, default_factory=dict)
    _leaves: list = dataclasses.field(repr=False, default_factory=list)
    _tree: Any = dataclasses.field(repr=False, default=None)

    @property
    def dispatch_count(self) -> int:
        return len(self.buckets)

    @property
    def predicted_wire_bytes(self) -> int:
        return sum(b.predicted_wire_bytes for b in self.buckets)


@dataclasses.dataclass
class DecodePlan:
    """Inspectable decode schedule; ``n_passthrough`` entries (const / raw
    tensors, non-tensors, ``None``) restore without a launch."""
    config: CodecConfig
    buckets: Tuple[DecodeBucket, ...]
    n_inputs: int
    n_passthrough: int
    _groups: list = dataclasses.field(repr=False, default_factory=list)
    _passthrough: dict = dataclasses.field(repr=False, default_factory=dict)
    _leaves: list = dataclasses.field(repr=False, default_factory=list)
    _tree: Any = dataclasses.field(repr=False, default=None)

    @property
    def dispatch_count(self) -> int:
        return len(self.buckets)


def _stack_dim(ct: CompressedTensor) -> Optional[int]:
    """Leading layer count of a stacked tensor, else ``None``."""
    base = 3 if ct.shards > 1 else 2
    return ct.streams.mask.shape[0] if ct.streams.mask.ndim == base + 1 \
        else None


def _stacked_from_bits(ct: CompressedTensor, n_layers: int,
                       bits: torch.Tensor) -> torch.Tensor:
    """(L*B, N) decoded bit containers -> the dense ``(L,) + ct.shape``."""
    per = int(np.prod(ct.shape))
    flat = bits.reshape(n_layers, -1)[:, :per]
    return flat.view(ct.fmt.float_dtype).reshape((n_layers,) + ct.shape)


def adjacent(ts: Sequence[torch.Tensor]) -> bool:
    """Are ``ts`` (non-empty, contiguous) consecutive rows of one storage,
    each starting where the one before it ends?"""
    ptr, off = ts[0].untyped_storage().data_ptr(), ts[0].storage_offset()
    for t in ts:
        if t.numel() == 0 or not t.is_contiguous() \
                or t.untyped_storage().data_ptr() != ptr \
                or t.storage_offset() != off:
            return False
        off += t.numel()
    return True


def _joined(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``ts`` stacked along their first dim: a view when they are
    :func:`adjacent` (a bucket laid out by ``runtime/overlap.py``), else a
    copy."""
    if len(ts) == 1:
        return ts[0]
    if not adjacent(ts):
        return torch.cat(ts)
    shape = (sum(t.shape[0] for t in ts),) + tuple(ts[0].shape[1:])
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    return ts[0].as_strided(shape, strides, ts[0].storage_offset())


def _layer_groups(members) -> list:
    """An encode launch's member stacks, grouped by layer count in member
    order.  The launch lays each group out layer by layer: layer l of every
    member of the group, then layer l+1.  So the stacks of one bucket are
    adjacent rows of each layer, and a decode of one layer of all of them
    (the prefetch of ``runtime/overlap.py``) reads one view of the streams,
    with nothing copied.  A member's stack is a view of the launch's
    output, the same bytes in any layout."""
    groups: Dict[int, list] = {}
    for m in members:
        groups.setdefault(m["n_layers"], []).append(m)
    return list(groups.values())


def _laid_out(members, part) -> torch.Tensor:
    """Every member's ``part(m)`` (its ``(L * b, ...)`` rows, layer-major)
    in one new tensor, in the launch's layout (:func:`_layer_groups`)."""
    first = part(members[0])
    rest = tuple(first.shape[1:])
    out = first.new_empty((sum(m["blocks"].shape[0] for m in members),)
                          + rest)
    off = 0
    for group in _layer_groups(members):
        n_layers = group[0]["n_layers"]
        width = sum(m["per_layer_blocks"] for m in group)
        rows = out[off:off + n_layers * width].view((n_layers, width) + rest)
        col = 0
        for m in group:
            plb = m["per_layer_blocks"]
            rows[:, col:col + plb].copy_(
                part(m).reshape((n_layers, plb) + rest))
            col += plb
        off += n_layers * width
    return out


def _per_block(members, like, value, nblocks_of) -> torch.Tensor:
    """(B,) int32 vector of ``value(m)`` over each member's blocks."""
    return torch.cat([torch.full((nblocks_of(m),), value(m),
                                 dtype=torch.int32, device=like.device)
                      for m in members])


def _rebuild(tree, leaves: Sequence[Any]):
    """``tree``'s structure with its leaves replaced, in flatten order, by
    ``leaves``."""
    it = iter(leaves)
    return tree_map_with_path(lambda _, __: next(it), tree)


class Codec:
    """One ENEC codec: config, dispatch counters and transfer ledger."""

    def __init__(self, config: Optional[CodecConfig] = None, **overrides):
        if config is None:
            config = CodecConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self._encode_stats = {"dispatches": 0, "blocks": 0,
                              "planned_buckets": 0}
        self._decode_stats = {"dispatches": 0, "blocks": 0}
        self._transfer = {"h2d_bytes": 0, "h2d_arrays": 0}
        self._links = {link: {"compressed_bytes": 0, "dense_bytes": 0,
                              "ops": 0} for link in LINKS}

    def __repr__(self):
        return f"Codec(block_elems={self.config.block_elems})"

    def configure(self, config: CodecConfig) -> "Codec":
        """Swap the config in place; returns ``self``.  The port keeps no
        compile cache, so nothing is invalidated; plans built under the
        old config no longer execute on this codec."""
        self.config = config
        return self

    # -- counters ---------------------------------------------------------

    def encode_cache_stats(self) -> dict:
        """``dispatches``: encoder launches; ``blocks``: blocks encoded;
        ``planned_buckets``: buckets of every plan built."""
        return dict(self._encode_stats)

    def decode_cache_stats(self) -> dict:
        """``dispatches``: decoder launches; ``blocks``: blocks decoded."""
        return dict(self._decode_stats)

    def reset_decode_cache_stats(self) -> None:
        for k in self._decode_stats:
            self._decode_stats[k] = 0

    def transfer_stats(self) -> dict:
        """``h2d_bytes`` / ``h2d_arrays`` plus the per-link ledger."""
        out = dict(self._transfer)
        out["links"] = self.link_stats()
        return out

    def link_stats(self) -> dict:
        """``{link: {compressed_bytes, dense_bytes, ops}}``."""
        return {link: dict(v) for link, v in self._links.items()}

    def reset_transfer_stats(self) -> None:
        for k in self._transfer:
            self._transfer[k] = 0
        for entry in self._links.values():
            for k in entry:
                entry[k] = 0

    def count_link(self, link: str, nbytes: int, *, dense: bool = False,
                   ops: int = 1) -> None:
        """Attribute ``nbytes`` moved over ``link``; ``dense=True`` marks
        payloads that are not ENEC streams (raw leaves, raw escapes)."""
        if link not in self._links:
            raise ValueError(f"unknown transfer link {link!r}; "
                             f"expected one of {LINKS}")
        entry = self._links[link]
        entry["dense_bytes" if dense else "compressed_bytes"] += int(nbytes)
        entry["ops"] += int(ops)
        if link == "h2d":
            self._transfer["h2d_bytes"] += int(nbytes)
            self._transfer["h2d_arrays"] += int(ops)

    def count_h2d(self, nbytes: int, arrays: int = 1, *,
                  dense: bool = False) -> None:
        """A host-to-device upload (``core.wire.h2d`` calls this)."""
        self.count_link("h2d", nbytes, dense=dense, ops=arrays)

    # -- the two launches -------------------------------------------------

    def _encode(self, blocks: torch.Tensor, fmt: FloatFormat, p: EnecParams,
                b_vec: torch.Tensor) -> BlockStreams:
        from repro_torch.kernels import ops    # kernels import core
        self._encode_stats["dispatches"] += 1
        self._encode_stats["blocks"] += blocks.shape[0]
        return ops.encode_blocks(blocks, fmt, p, b_vec)

    def _decode(self, flat: BlockStreams, fmt: FloatFormat, p: EnecParams,
                block_elems: int, b_vec=None, l_vec=None,
                out=None) -> torch.Tensor:
        from repro_torch.kernels import ops
        self._decode_stats["dispatches"] += 1
        self._decode_stats["blocks"] += flat.mask.shape[0]
        return ops.decode_blocks(flat, block_elems, fmt, p, b_vec, l_vec,
                                 out=out)

    # -- plan_encode ------------------------------------------------------

    def plan_encode(self, tree, *, stacked: bool = False,
                    p: Optional[EnecParams] = None,
                    block_elems: Optional[int] = None,
                    shards: int = 1) -> EncodePlan:
        """Encode schedule for every tensor leaf of ``tree`` (a list of
        tensors, or nested dicts and lists).  ``stacked=True`` treats each
        as an ``(L, ...)`` layer stack (escapes resolve to ``None``);
        ``stacked=False`` compresses each as one tensor (escapes become
        const / raw tensors; :meth:`compress_tree`).  Statistics of all
        inputs reach the host in one transfer; nothing is encoded until
        :meth:`execute`."""
        if p is None:
            p = self.config.shared_params
        if block_elems is None:
            block_elems = self.config.block_elems
        leaves = [leaf for _, leaf in tree_leaves(tree)]
        fallbacks: dict = {}     # slot -> ("dense" | "const", first bits)
        prepared = []
        for slot, x in enumerate(leaves):
            if x is None:
                fallbacks[slot] = ("none", None)
                continue
            if not isinstance(x, torch.Tensor):
                x = leaves[slot] = torch.as_tensor(x)
            xs = x if stacked else x.reshape((1,) + tuple(x.shape))
            if xs.ndim < 1 or xs.dtype not in SUPPORTED_FLOAT_DTYPES \
                    or xs.numel() == 0:
                fallbacks[slot] = ("dense", None)
                continue
            fmt = format_for(xs.dtype)
            bits2d = xs.reshape(xs.shape[0], -1).view(fmt.bits_dtype)
            prepared.append((slot, fmt, bits2d, tuple(xs.shape[1:]),
                             DTYPE_NAMES[xs.dtype],
                             stats_mod.stack_stats_device(bits2d, fmt)))
        host_stats = stats_mod.fetch_stats([pr[-1] for pr in prepared])

        groups: Dict[tuple, list] = {}
        for (slot, fmt, bits2d, layer_shape, dtype_str, _), st in zip(
                prepared, host_stats):
            if st.is_const.any():
                fallbacks[slot] = ("const", st.first)
                continue
            pi = (params_mod.search(st.hist, fmt, block_elems=block_elems)
                  if p is None else p)
            pi = params_mod.widen_for_range(pi, *st.bounds())
            blocks, per_layer_blocks = block_codec.stacked_blocks(
                bits2d, block_elems, shards, pad_value=pi.b << fmt.mant_bits)
            key = (fmt.name, (pi.n, pi.m, pi.L), block_elems)
            groups.setdefault(key, []).append(dict(
                slot=slot, fmt=fmt, p=pi, blocks=blocks,
                n_layers=bits2d.shape[0], layer_shape=layer_shape,
                dtype_str=dtype_str, per_layer_blocks=per_layer_blocks,
                raw_bytes=bits2d.numel() * fmt.total_bits // 8))

        buckets = []
        for key, members in groups.items():
            nblocks = sum(m["blocks"].shape[0] for m in members)
            buckets.append(EncodeBucket(
                fmt_name=key[0], params_key=key[1], block_elems=key[2],
                block_bucket=nblocks, nblocks=nblocks,
                n_tensors=len(members),
                predicted_wire_bytes=sum(
                    int(m["raw_bytes"] / expected_ratio(m["p"], m["fmt"]))
                    for m in members)))
        self._encode_stats["planned_buckets"] += len(buckets)
        return EncodePlan(
            config=self.config, buckets=tuple(buckets),
            n_inputs=len(leaves), n_fallback=len(fallbacks),
            stacked=stacked, shards=shards, block_elems=block_elems,
            _groups=list(groups.values()), _fallbacks=fallbacks,
            _leaves=leaves, _tree=tree)

    # -- plan_decode ------------------------------------------------------

    def plan_decode(self, tree) -> DecodePlan:
        """Decode schedule for every :class:`CompressedTensor` of ``tree``
        (a list, or nested dicts and lists; other leaves pass through,
        ``None`` holes stay ``None`` and, as in the reference's pytree
        flatten, are not counted as passthrough).  Tensors sharing ``(fmt,
        (n, m, L), block_elems)`` form one :class:`DecodeBucket` == one
        launch."""
        leaves = [leaf for _, leaf in tree_leaves(tree)]
        passthrough: dict = {}    # slot -> "ct" (const / raw) | "identity"
        groups: Dict[tuple, list] = {}
        for slot, leaf in enumerate(leaves):
            if leaf is None:
                continue
            if not isinstance(leaf, CompressedTensor):
                passthrough[slot] = "identity"
                continue
            if leaf.mode != "enec":
                passthrough[slot] = "ct"
                continue
            p = leaf.params
            key = (leaf.fmt_name, (p.n, p.m, p.L), leaf.block_elems)
            groups.setdefault(key, []).append(dict(
                slot=slot, ct=leaf, stack=_stack_dim(leaf),
                flat=block_codec.flatten_blocks(leaf.streams)))
        buckets = []
        for key, members in groups.items():
            nblocks = sum(m["flat"].mask.shape[0] for m in members)
            buckets.append(DecodeBucket(
                fmt_name=key[0], params_key=key[1], block_elems=key[2],
                block_bucket=nblocks, nblocks=nblocks,
                n_tensors=len(members)))
        return DecodePlan(
            config=self.config, buckets=tuple(buckets),
            n_inputs=len(leaves), n_passthrough=len(passthrough),
            _groups=list(groups.values()),
            _passthrough=passthrough, _leaves=leaves, _tree=tree)

    # -- execute ----------------------------------------------------------

    def execute(self, plan, out=None):
        """Run a plan: exactly ``len(plan.buckets)`` launches.  Returns the
        planned tree with each leaf replaced by its result.  ``out`` (decode plans only): one (nblocks,
        block_elems) bit tensor per bucket, in bucket order, that the
        bucket decodes into; each result is then a view of it."""
        if isinstance(plan, EncodePlan):
            if plan.config != self.config:
                raise ValueError("plan was built under a different "
                                 "CodecConfig; re-plan with this codec")
            return self._execute_encode(plan)
        if isinstance(plan, DecodePlan):
            if plan.config != self.config:
                raise ValueError("plan was built under a different "
                                 "CodecConfig; re-plan with this codec")
            return self._execute_decode(plan, out)
        raise TypeError(f"not a plan: {type(plan).__name__}")

    @staticmethod
    def encode_launches(plan: EncodePlan):
        """The encoder call :meth:`execute` makes for each bucket of
        ``plan``, in bucket order, as its arguments ``(blocks, fmt, p,
        b_vec)``: every member stack's blocks and the per-block ``b`` of
        each, in the launch's layout (:func:`_layer_groups`)."""
        for members in plan._groups:
            def b_of(m):
                return torch.full((m["blocks"].shape[0],), m["p"].b,
                                  dtype=torch.int32,
                                  device=m["blocks"].device)
            if len(members) == 1:
                blocks, b_vec = members[0]["blocks"], b_of(members[0])
            else:
                blocks = _laid_out(members, lambda m: m["blocks"])
                b_vec = _laid_out(members, b_of)
            yield blocks, members[0]["fmt"], members[0]["p"], b_vec

    def _execute_encode(self, plan: EncodePlan):
        results: List[Optional[CompressedTensor]] = [None] * plan.n_inputs
        shards = plan.shards
        for members, args in zip(plan._groups, self.encode_launches(plan)):
            streams = self._encode(*args)
            offset = 0
            for group in _layer_groups(members):
                n_layers = group[0]["n_layers"]
                width = sum(m["per_layer_blocks"] for m in group)
                rows = streams.map(lambda a: a[offset:offset + n_layers
                                               * width].reshape(
                    (n_layers, width) + a.shape[1:]))
                offset += n_layers * width
                col = 0
                for m in group:
                    plb = m["per_layer_blocks"]
                    lead = ((n_layers, shards, plb // shards) if shards > 1
                            else (n_layers, plb))
                    s = rows.map(lambda a: a[:, col:col + plb].reshape(
                        lead + a.shape[2:]))
                    col += plb
                    results[m["slot"]] = CompressedTensor(
                        streams=s, raw_bytes=None, fmt_name=m["fmt"].name,
                        params=m["p"], shape=m["layer_shape"],
                        dtype_str=m["dtype_str"],
                        block_elems=m["blocks"].shape[1], shards=shards,
                        mode="enec")

        # never-worse escape: ONE transfer of every stack's high_len, which
        # also fills the nbytes_wire caches
        pending = [(slot, ct) for slot, ct in enumerate(results)
                   if ct is not None]
        if pending:
            host = torch.cat([ct.streams.high_len.reshape(-1)
                              for _, ct in pending]).cpu().numpy()
            off = 0
            for slot, ct in pending:
                n = ct.streams.high_len.numel()
                wire = ct._set_wire_bytes(host[off:off + n])
                off += n
                if wire >= ct.streams.mask.shape[0] * ct.nbytes_raw():
                    results[slot] = None
        if not plan.stacked:
            results = self._finish_per_leaf(plan, results)
        return _rebuild(plan._tree, results)

    def _finish_per_leaf(self, plan: EncodePlan, results):
        """Per-tensor semantics: unwrap the L=1 stacks and resolve escapes
        to const / raw tensors instead of ``None``."""
        out = []
        for slot, ct in enumerate(results):
            if ct is not None:
                wire_bytes = ct._wire_bytes
                ct = slice_stacked(ct, 0)
                ct._wire_bytes = wire_bytes
                out.append(ct)
                continue
            x = plan._leaves[slot]
            kind, first = plan._fallbacks.get(slot, ("dense", None))
            if kind == "none":
                out.append(None)
            elif kind == "const":
                out.append(const_tensor(int(first[0]), x, format_for(x.dtype),
                                        plan.block_elems, plan.shards))
            else:
                out.append(raw_tensor(x, plan.shards))
        return out

    def _execute_decode(self, plan: DecodePlan, out=None):
        results: List[Any] = [None] * plan.n_inputs
        for slot, kind in plan._passthrough.items():
            leaf = plan._leaves[slot]
            results[slot] = self.decompress_array(leaf) if kind == "ct" \
                else leaf
        for k, members in enumerate(plan._groups):
            flat = BlockStreams(*(_joined(f) for f in
                                  zip(*[m["flat"] for m in members])))
            nblocks_of = lambda m: m["flat"].mask.shape[0]   # noqa: E731
            b_vec = _per_block(members, flat.mask,
                               lambda m: m["ct"].params.b, nblocks_of)
            l_vec = _per_block(members, flat.mask,
                               lambda m: m["ct"].params.l, nblocks_of)
            ct0 = members[0]["ct"]
            bits = self._decode(flat, ct0.fmt, ct0.params, ct0.block_elems,
                                b_vec, l_vec,
                                out=None if out is None else out[k])
            offset = 0
            for m in members:
                nb = nblocks_of(m)
                bits_m = bits[offset:offset + nb]
                offset += nb
                ct = m["ct"]
                results[m["slot"]] = (
                    block_codec.from_blocks(bits_m, ct.shape, ct.fmt)
                    if m["stack"] is None
                    else _stacked_from_bits(ct, m["stack"], bits_m))
        return _rebuild(plan._tree, results)

    # -- conveniences over plan/execute -----------------------------------

    def compress_stacked_many(self, stacks: Sequence[torch.Tensor],
                              p: Optional[EnecParams] = None,
                              block_elems: Optional[int] = None,
                              shards: int = 1
                              ) -> List[Optional[CompressedTensor]]:
        """Compress ``(L, ...)`` layer stacks in O(#buckets) launches;
        ``None`` entries must stay dense (unsupported dtype, a constant
        layer, or incompressible)."""
        return self.execute(self.plan_encode(
            stacks, stacked=True, p=p, block_elems=block_elems,
            shards=shards))

    def compress_stacked(self, x: torch.Tensor,
                         p: Optional[EnecParams] = None,
                         block_elems: Optional[int] = None,
                         shards: int = 1) -> Optional[CompressedTensor]:
        """Compress one ``(L, ...)`` layer stack in one encode launch;
        ``None`` when the stack must stay dense."""
        return self.compress_stacked_many([x], p, block_elems, shards)[0]

    def compress_tree(self, tree, shared_params: Optional[EnecParams] = None,
                      block_elems: Optional[int] = None, shards: int = 1):
        """Compress every tensor leaf of ``tree`` as one tensor, in
        O(#buckets) encode launches; float leaves get per-tensor searched
        params (or ``shared_params`` / the config's)."""
        return self.execute(self.plan_encode(
            tree, stacked=False, p=shared_params, block_elems=block_elems,
            shards=shards))

    def decompress_tree(self, ctree):
        """Inverse of :meth:`compress_tree` in O(#buckets) launches."""
        return self.execute(self.plan_decode(ctree))

    def compress_array(self, x: torch.Tensor,
                       p: Optional[EnecParams] = None,
                       block_elems: Optional[int] = None,
                       shards: int = 1) -> CompressedTensor:
        """Compress one tensor; escapes become const / raw tensors."""
        return self.execute(self.plan_encode(
            [x], stacked=False, p=p, block_elems=block_elems,
            shards=shards))[0]

    def tile_weights_for_fusion_many(self, ws: Sequence[torch.Tensor],
                                     p: Optional[EnecParams] = None,
                                     shards: int = 1
                                     ) -> List[Optional[CompressedTensor]]:
        """Compress (L, K, N) / (K, N) matmul weights tile-wise for the
        fused kernel.  ``shards > 1`` splits each layer's n-major tile axis
        into contiguous ranges; the tile count must divide by ``shards``
        (pad blocks would corrupt the kernel's flat tile order)."""
        tiles = [matmul_tiles(w) for w in ws]
        if shards > 1:
            for w, t in zip(ws, tiles):
                blocks = t.shape[-1] // DEFAULT_BLOCK_ELEMS
                if blocks % shards:
                    raise ValueError(
                        f"fused tile stream of {tuple(w.shape)} has "
                        f"{blocks} tile blocks — not divisible into "
                        f"{shards} shards")
        return self.compress_stacked_many(
            tiles, p=p, block_elems=DEFAULT_BLOCK_ELEMS, shards=shards)

    def tile_weights_for_fusion(self, w: torch.Tensor,
                                p: Optional[EnecParams] = None
                                ) -> CompressedTensor:
        """Compress one (L, K, N) / (K, N) weight tile-wise for the fused
        kernel (a (K, N) weight gives the streams of one layer); raises on
        the incompressible or constant escape."""
        ct = self.tile_weights_for_fusion_many([w], p)[0]
        if ct is None:
            raise ValueError(
                "weight is incompressible or constant: serve it dense")
        if w.ndim == 2:
            ct = dataclasses.replace(ct, streams=ct.streams.map(
                lambda a: a[0]))
        return ct

    def decompress_array(self, ct: CompressedTensor) -> torch.Tensor:
        """Exact inverse of compression for one (per-layer or L=1) tensor:
        one decoder launch over all of its blocks (none for const / raw)."""
        dtype = getattr(torch, ct.dtype_str)
        if ct.mode == "const":
            return ct.raw_bytes.view(dtype)[0].expand(ct.shape)
        if ct.mode == "raw":
            return ct.raw_bytes.view(dtype).reshape(ct.shape)
        bits = self._decode(block_codec.flatten_blocks(ct.streams), ct.fmt,
                            ct.params, ct.block_elems)
        return block_codec.from_blocks(bits, ct.shape, ct.fmt)

    def decompress_stacked(self, ct: CompressedTensor) -> torch.Tensor:
        """Inverse of :meth:`compress_stacked`: one launch -> (L, ...)."""
        return self.decompress_stacked_many([ct])[0]

    def decompress_stacked_many(self, cts: Sequence[Any]) -> List[Any]:
        """Decompress many tensors in O(#buckets) launches; const / raw /
        ``None`` entries pass through."""
        return self.execute(self.plan_decode(cts))

    def untile_matmul_weight(self, ct: CompressedTensor, k: int,
                             n: int) -> torch.Tensor:
        """Dense (k, n) weight of ONE layer slice of a tile-wise tensor."""
        return _untile(self.decompress_array(ct), k, n)


# ---------------------------------------------------------------------------
# the ambient codec: process default + context override
# ---------------------------------------------------------------------------

_DEFAULT: Optional[Codec] = None
_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_codec", default=None)


def default_codec() -> Codec:
    """The process-default codec."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Codec()
    return _DEFAULT


def set_default_codec(codec: Codec) -> Codec:
    """Replace the process-default codec; returns the previous one."""
    global _DEFAULT
    prev = default_codec()
    _DEFAULT = codec
    return prev


def current_codec() -> Codec:
    """The innermost :func:`use_codec` codec, else :func:`default_codec`."""
    return _AMBIENT.get() or default_codec()


@contextlib.contextmanager
def use_codec(codec: Codec):
    """Make ``codec`` the ambient codec inside the block."""
    token = _AMBIENT.set(codec)
    try:
        yield codec
    finally:
        _AMBIENT.reset(token)


__all__ = ["BACKENDS", "LINKS", "CodecConfig", "Codec", "EncodeBucket", "DecodeBucket",
           "EncodePlan", "DecodePlan", "default_codec", "set_default_codec",
           "current_codec", "use_codec"]
