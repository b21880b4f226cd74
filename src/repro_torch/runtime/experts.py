"""Compressed MoE expert streaming with a byte-budgeted LRU decode cache
(port of ``repro/runtime/experts.py``).

An MoE step touches ``k`` of ``E`` experts per token; the rest are dead
weight on the card.  The store keeps every expert as a per-expert
compressed wire record in host memory and decodes routed experts on
demand:

  :class:`ExpertStore`  per-(leaf, layer, expert) wire records and a
                        byte-budgeted LRU cache of decoded experts on the
                        store's device, with hit / miss / eviction /
                        resident-byte counters
  :class:`ExpertRef`    the weight handle (kind "expert") that stands in
                        for an ``(L, E, ...)`` expert stack in the params
                        tree; nothing of it lives on the device
  :func:`routed_expert_weights`
                        the fetch ``models/moe.py:moe_block`` calls with
                        the step's routed expert ids

Records are the reference's byte for byte: each ``(L, E, ...)`` stack is
ONE stacked encode over its ``L*E`` expert slices (one searched parameter
set a leaf), sliced per expert (``core.api.slice_stacked``) into
independent wire records.  The records stay wire bytes, so a checkpoint
re-emits them verbatim; on a CUDA store they sit in pinned host memory
and their headers are parsed once, at a record's first miss.

Where the reference differs, and why the port does not follow it: the
reference fetches through an ordered ``io_callback`` and decodes misses
with a numpy port of the codec (``core/host_decode.py``), because device
work launched from inside the callback would deadlock the jitted step.
Eager PyTorch has no such deadlock, so here ``moe_block`` brings the
routed ids to the host (one sync per MoE layer) and the misses decode on
the store's device through its :class:`~repro_torch.core.codec_api.Codec`:
each missed record's streams are copied to the device (one copy from
pinned memory, counted on the codec's ``h2d`` ledger), its exact high
bits scattered into the device layout, and then ``plan_decode`` +
``execute`` decode all of a fetch's misses in one ENEC-decode launch per
bucket (at most one per distinct leaf geometry and parameter set): the
reference's O(#buckets) contract (``last_fetch``, ``fetch_buckets``).

Eviction is the reference's: all of a fetch's experts are inserted or
touched first and the LRU is trimmed to the byte budget afterwards, so
the step's working set is intact while it computes (``budget_bytes=0``
keeps nothing past the step).  A decoded expert is cached as its view of
the launch's output, so a fetch holds its decoded bytes once; when the
trim evicts an expert, the cached experts of the same launch are copied
into storage of their own, so the evicted one's bytes are freed once the
step lets go of them, and ``resident_bytes`` (each cached expert's dense
bytes) is what the cache holds on the device between steps.

The miss-decode time (``decode_s``) is taken with CUDA events around each
fetch's staging and decode on a CUDA store, read once the step has
finished (the fetch adds no sync of its own), and on the host's clock on
a CPU store.

A fetch needs the routed ids on the host in the middle of the step, so a
step with a store cannot be one CUDA graph: the fetch refuses to run
inside a capture (``build.refuse_in_capture``) and the engine runs such
steps eagerly (``runtime/engine.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import wire as enec_wire
from repro_torch.core.api import slice_stacked
from repro_torch.core.codec_api import current_codec
from repro_torch.kernels import build
from repro_torch.runtime.weights import WeightHandle, is_handle

# the MoE expert-stack leaves of models/moe.py, shaped (L, E, D, F) in the
# layer-stacked params tree
EXPERT_LEAF_NAMES = frozenset({"e_gate", "e_up", "e_down"})
# a CUDA store's records are packed into pinned arenas of this size (the
# pinned allocator rounds each allocation up to a power of two, so one
# allocation a record would pin up to twice its bytes)
PINNED_ARENA_BYTES = 1 << 30


class ExpertStoreError(RuntimeError):
    """An expert record is missing or inconsistent."""


def is_expert_leaf(name: str, leaf) -> bool:
    """Is this params-tree leaf an ``(L, E, ...)`` MoE expert stack?"""
    short = name.rsplit("/", 1)[-1]
    return short in EXPERT_LEAF_NAMES and getattr(leaf, "ndim", 0) == 4


def _expert_block_elems(codec, n_elems: int) -> int:
    """Encode block size for per-expert records: each record is its own
    L=1 layer of the stacked encode, and layers pad to whole blocks, so an
    expert smaller than the codec's block takes the largest 128-multiple
    divisor of its size instead (no padding); larger experts keep the
    codec's block size."""
    be = int(codec.config.block_elems)
    if n_elems >= be:
        return be
    for cand in range(n_elems - n_elems % 128, 0, -128):
        if n_elems % cand == 0:
            return cand
    return be


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def encode_expert_leaf(name: str, leaf: torch.Tensor, codec=None):
    """Compress one ``(L, E, ...)`` expert stack into per-expert wire
    records: ONE stacked encode over the ``L*E`` expert slices on the
    leaf's device, then one sliced wire record per expert.  Returns
    ``(meta, [(layer, expert, body_bytes), ...])``, or ``None`` when the
    stack escapes compression (const / incompressible: the caller keeps
    the dense leaf)."""
    codec = codec or current_codec()
    n_layers, n_experts = int(leaf.shape[0]), int(leaf.shape[1])
    expert_shape = tuple(int(s) for s in leaf.shape[2:])
    n_elems = int(np.prod(expert_shape, dtype=np.int64))
    ct = codec.compress_stacked_many(
        [leaf.reshape((n_layers * n_experts,) + expert_shape)],
        block_elems=_expert_block_elems(codec, n_elems))[0]
    if ct is None:
        return None
    meta = {"n_layers": n_layers, "n_experts": n_experts,
            "expert_shape": expert_shape, "dtype": _dtype_name(leaf.dtype)}
    records = [(l, j, enec_wire.to_wire(slice_stacked(ct, l * n_experts + j)))
               for l in range(n_layers) for j in range(n_experts)]
    return meta, records


class ExpertStore:
    """Per-expert compressed records in host memory and the LRU cache of
    decoded experts on ``device``.

    Not a dataclass on purpose: equality and hash are identity, so
    :class:`ExpertRef` handles of one store compare equal.
    """

    def __init__(self, *, budget_bytes=None, codec=None, device="cuda"):
        self.codec = codec or current_codec()
        self.device = resolve_device(device)
        self.budget_bytes = budget_bytes     # None = unbounded residency
        self._records = {}       # (name, layer, expert) -> host bytes
        self._headers = {}       # (name, layer, expert) -> RecordHeader
        self._meta = {}          # name -> layout dict
        self._lru = OrderedDict()   # (name, layer, expert) -> tensor
        self._arena = None          # pinned arena being filled, its offset
        self._arena_off = 0
        self._lock = threading.Lock()
        self.last_fetch = {"records": 0, "buckets": 0}
        self.reset_stats()

    def reset_stats(self):
        self._c = {"hits": 0, "misses": 0, "evictions": 0, "fetches": 0,
                   "fetch_records": 0, "fetch_buckets": 0}
        self._resident_bytes = sum(_nbytes(a) for a in self._lru.values())
        self._decode_s = 0.0
        self._decode_events = []    # CUDA (start, end) not yet in _decode_s

    # -- population ------------------------------------------------------

    def add_leaf(self, name: str, leaf: torch.Tensor, *, codec=None) -> bool:
        """Encode one dense ``(L, E, ...)`` stack into the store.  False
        when the stack escapes compression (the leaf stays dense)."""
        enc = encode_expert_leaf(name, leaf, codec or self.codec)
        if enc is None:
            return False
        meta, records = enc
        self.add_meta(name, **meta)
        for l, j, body in records:
            self.add_record(name, l, j, body)
        return True

    def add_meta(self, name: str, *, n_layers: int, n_experts: int,
                 expert_shape, dtype: str):
        meta = {"n_layers": int(n_layers), "n_experts": int(n_experts),
                "expert_shape": tuple(int(s) for s in expert_shape),
                "dtype": str(dtype)}
        prev = self._meta.setdefault(name, meta)
        if prev != meta:
            raise ExpertStoreError(f"{name}: conflicting layouts "
                                   f"{prev} vs {meta}")

    def add_record(self, name: str, layer: int, expert: int, body: bytes):
        """Keep one record's wire bytes (in pinned memory for a CUDA
        store, so a miss copies them to the card without staging)."""
        key = (name, int(layer), int(expert))
        host = self._host_buffer(len(body))
        host.numpy()[:] = np.frombuffer(body, np.uint8)
        self._records[key] = host
        self._headers.pop(key, None)

    def _host_buffer(self, n: int) -> torch.Tensor:
        """``n`` bytes of host memory for a record: pinned, carved from an
        arena on a CUDA store (64-byte aligned), plain on a CPU store."""
        if self.device.type != "cuda":
            return torch.empty(n, dtype=torch.uint8)
        if self._arena is None or self._arena_off + n > self._arena.numel():
            self._arena = torch.empty(max(PINNED_ARENA_BYTES, n),
                                      dtype=torch.uint8, pin_memory=True)
            self._arena_off = 0
        host = self._arena[self._arena_off:self._arena_off + n]
        self._arena_off += -(-n // 64) * 64
        return host

    # -- introspection ---------------------------------------------------

    def names(self):
        return sorted(self._meta)

    def meta(self, name: str) -> dict:
        return dict(self._meta[name])

    def complete(self, name: str) -> bool:
        m = self._meta.get(name)
        if m is None:
            return False
        return all((name, l, j) in self._records
                   for l in range(m["n_layers"])
                   for j in range(m["n_experts"]))

    def missing(self, name: str):
        m = self._meta[name]
        return [(l, j) for l in range(m["n_layers"])
                for j in range(m["n_experts"])
                if (name, l, j) not in self._records]

    def records_for(self, name: str):
        """``[(layer, expert, body_bytes), ...]``: the checkpoint save path
        re-emits these verbatim (no re-encode)."""
        m = self._meta[name]
        out = []
        for l in range(m["n_layers"]):
            for j in range(m["n_experts"]):
                try:
                    host = self._records[(name, l, j)]
                except KeyError:
                    raise ExpertStoreError(
                        f"{name}: missing record for layer {l} "
                        f"expert {j}") from None
                out.append((l, j, host.numpy().tobytes()))
        return out

    def expert_nbytes(self, name: str) -> int:
        m = self._meta[name]
        itemsize = torch.empty((), dtype=getattr(torch, m["dtype"])) \
            .element_size()
        return int(np.prod(m["expert_shape"], dtype=np.int64)) * itemsize

    def total_expert_bytes(self) -> int:
        """Dense bytes of every expert in the store (the budget that keeps
        all of them resident)."""
        return sum(self.expert_nbytes(n)
                   * self._meta[n]["n_layers"] * self._meta[n]["n_experts"]
                   for n in self._meta)

    def ref(self, name: str) -> "ExpertRef":
        m = self._meta[name]
        return ExpertRef(name=name, store=self, n_layers=m["n_layers"],
                         n_experts=m["n_experts"],
                         expert_shape=m["expert_shape"], dtype_str=m["dtype"])

    # -- decode ----------------------------------------------------------

    def _stage(self, key):
        """One record's CompressedTensor on the store's device: its stream
        section copied in one transfer (counted on the codec's h2d
        ledger), the exact high bits scattered into the device layout."""
        try:
            host = self._records[key]
        except KeyError:
            raise ExpertStoreError(
                f"no record for leaf {key[0]!r} layer {key[1]} "
                f"expert {key[2]}") from None
        hdr = self._headers.get(key)
        if hdr is None:
            hdr = self._headers[key] = enec_wire.parse_header(
                host.numpy(), record=f"{key[0]}[{key[1]},{key[2]}]")
        if hdr.mode != "enec":
            raise ExpertStoreError(
                f"{key[0]}[{key[1]},{key[2]}]: a {hdr.mode} record; expert "
                f"records are enec (encode_expert_leaf writes no other)")
        section = host[hdr.stream_offset:]
        self.codec.count_h2d(section.numel())
        section = section.to(self.device, non_blocking=True)
        high_len, mask, low, raw, exact = enec_wire.split_streams(
            hdr, section)
        return enec_wire.enec_tensor(hdr, high_len.view(torch.int32), mask,
                                     low, raw, exact)

    def _decode(self, keys) -> tuple:
        """Decode ``keys``' records in one plan: ``(tensors, buckets)``."""
        plan = self.codec.plan_decode([self._stage(k) for k in keys])
        return self.codec.execute(plan), len(plan.buckets)

    # -- fetch -----------------------------------------------------------

    def fetch_step(self, names, layer: int, routed):
        """One routing step's fetch: the ``routed`` expert ids of ``layer``
        for every leaf in ``names``.  Returns one list of ``n_experts``
        entries a leaf: the decoded ``expert_shape`` tensor on the store's
        device for a routed expert, ``None`` for the others.  All misses
        across the leaves decode in one plan (one launch per bucket); hits
        are LRU-touched; the LRU is trimmed to the budget only after the
        step's experts are assembled."""
        build.refuse_in_capture("an expert store's fetch")
        layer = int(layer)
        routed = sorted({int(r) for r in np.asarray(routed).ravel()})
        with self._lock:
            keys = [(n, layer, j) for n in names for j in routed]
            missing = []
            for k in keys:
                if k in self._lru:
                    self._lru.move_to_end(k)
                    self._c["hits"] += 1
                else:
                    missing.append(k)
                    self._c["misses"] += 1
            if missing:
                with self._decode_timer():
                    decs, n_buckets = self._decode(missing)
                self._c["fetches"] += 1
                self._c["fetch_records"] += len(missing)
                self._c["fetch_buckets"] += n_buckets
                self.last_fetch = {"records": len(missing),
                                   "buckets": n_buckets}
                for k, dec in zip(missing, decs):
                    self._lru[k] = dec
                    self._resident_bytes += _nbytes(dec)
            outs = []
            for n in names:
                full = [None] * self._meta[n]["n_experts"]
                for j in routed:
                    full[j] = self._lru[(n, layer, j)]
                outs.append(full)
            self._trim()
            return tuple(outs)

    @contextlib.contextmanager
    def _decode_timer(self):
        """Time a fetch's staging and decode: CUDA events on a CUDA store
        (read by :meth:`decode_seconds` after the step), else the host's
        clock."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._decode_events.append((start, end))
            return
        t0 = time.perf_counter()
        yield
        self._decode_s += time.perf_counter() - t0

    def _trim(self):
        evicted = set()     # the storages of the evicted experts
        while (self.budget_bytes is not None and self._lru
               and self._resident_bytes > self.budget_bytes):
            _, a = self._lru.popitem(last=False)
            self._resident_bytes -= _nbytes(a)
            self._c["evictions"] += 1
            evicted.add(a.untyped_storage().data_ptr())
        # a cached expert decoded in the same launch as an evicted one is a
        # view of that launch's output: copy it out, so the output's bytes
        # are freed once the step lets go of them
        shared = [k for k, a in self._lru.items()
                  if a.untyped_storage().data_ptr() in evicted]
        for k in shared:
            self._lru[k] = self._lru[k].clone()

    # -- whole-leaf materialization (tests, training-restore parity) -----

    def materialize_leaf(self, name: str) -> torch.Tensor:
        """Decode EVERY expert of ``name`` into the dense ``(L, E, ...)``
        stack on the store's device (one plan; bypasses the LRU)."""
        m = self._meta[name]
        keys = [(name, l, j) for l, j, _ in self.records_for(name)]
        decs, _ = self._decode(keys)
        return torch.stack(decs).reshape(
            (m["n_layers"], m["n_experts"]) + m["expert_shape"])

    # -- observability ---------------------------------------------------

    def _collect_decode_events(self):
        for start, end in self._decode_events:
            end.synchronize()
            self._decode_s += start.elapsed_time(end) / 1e3
        self._decode_events.clear()

    def stats(self) -> dict:
        with self._lock:
            self._collect_decode_events()
            out = dict(self._c)
            out.update(
                records=len(self._records),
                record_bytes=sum(h.numel() for h in self._records.values()),
                resident_experts=len(self._lru),
                resident_bytes=self._resident_bytes,
                budget_bytes=self.budget_bytes,
                decode_s=round(self._decode_s, 6),
                leaves=len(self._meta))
            return out

    def decode_seconds(self) -> float:
        """Cumulative cache-miss decode time: the copies, the scatter and
        the decode launches (device time on a CUDA store, waiting for the
        fetches' end events; the engine takes its delta over each step,
        after the step's tokens reached the host)."""
        with self._lock:
            self._collect_decode_events()
            return self._decode_s


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(eq=False)
class ExpertRef(WeightHandle):
    """Weight handle (kind "expert") standing in for one ``(L, E, ...)``
    expert stack.  ``layer`` is ``None`` for the whole stack and the layer
    index after the model's layer loop took :meth:`layer`; the routed fetch
    happens in ``moe_block``, where the routing ids exist, so ``resolve``
    passes the handle through."""
    name: str
    store: ExpertStore
    n_layers: int
    n_experts: int
    expert_shape: tuple
    dtype_str: str
    layer_index: Optional[int] = None

    def layer(self, i: int) -> "ExpertRef":
        return dataclasses.replace(self, layer_index=int(i))

    def materialize(self, codec=None) -> torch.Tensor:
        """The dense stack of the handle's layers: ``(L, E, ...)``
        unsliced, one layer's ``(E, ...)`` after :meth:`layer`."""
        full = self.store.materialize_leaf(self.name)
        return full if self.layer_index is None else full[self.layer_index]

    def matmul(self, x):
        raise TypeError(f"{self.name}: an expert stack is not a matmul "
                        f"weight; moe_block fetches its experts")

    def raw_nbytes(self) -> int:
        return (self.n_layers * self.n_experts
                * self.store.expert_nbytes(self.name))


def routed_expert_weights(refs, topk_i: torch.Tensor):
    """Fetch one routing step's experts through the store.

    ``refs`` are the layer-sliced :class:`ExpertRef` handles of one MoE
    block and ``topk_i`` the ``(B, T, k)`` routed expert ids.  The ids come
    to the host here (the step's one sync for this layer).  Returns
    ``(routed, stacks)``: the routed ids ascending and, per ref, a list of
    ``n_experts`` entries, the decoded expert or ``None``."""
    store = refs[0].store
    for r in refs:
        if r.store is not store:
            raise ExpertStoreError(
                "all expert refs of one MoE block must share a store")
        if r.layer_index is None:
            raise ExpertStoreError(f"{r.name}: fetch needs a layer slice")
    build.refuse_in_capture("an expert store's fetch")
    routed = torch.unique(topk_i).tolist()
    stacks = store.fetch_step(tuple(r.name for r in refs),
                              refs[0].layer_index, routed)
    return sorted(routed), stacks


def install_expert_store(params, *, budget_bytes=None, codec=None,
                         store=None, min_bytes: int = 0, device=None):
    """Replace every dense ``(L, E, ...)`` expert stack in ``params`` with
    an :class:`ExpertRef` backed by a (new or given) :class:`ExpertStore`
    (a new one on ``device``, default the first expert leaf's device).

    Runs BEFORE ``assign_weight_modes`` (which passes existing handles
    through), so expert streaming composes with every weight mode.  Leaves
    smaller than ``min_bytes`` or escaping compression stay dense.  Returns
    ``(tree, store)``; ``store`` is None when nothing converted."""
    from repro_torch.runtime.streaming import tree_map_with_path
    est = store

    def convert(name, leaf):
        nonlocal est
        if (not is_handle(leaf) and is_expert_leaf(name, leaf)
                and leaf.numel() * leaf.element_size() >= min_bytes):
            if est is None:
                est = ExpertStore(budget_bytes=budget_bytes, codec=codec,
                                  device=device or leaf.device)
            if est.add_leaf(name, leaf):
                return est.ref(name)
        return leaf

    tree = tree_map_with_path(convert, params)
    converted = est is not None and bool(est.names())
    return tree, est if converted else None
