"""ENEC-compressed checkpointing in the enec-v2 container (port of the
strict subset of ``repro/checkpoint/ckpt.py``; packs and manifests are the
reference's byte for byte).

Layout (one directory per step):
    <root>/step_000001230/
        manifest.json          tree structure + per-record (pack, offset,
                               length) index, shapes, dtypes, ENEC stats
        pack-00000.bin ...     per-shard pack files: concatenated framed
                               wire records (length + CRC32 per record)
    <root>/LATEST              atomic pointer file (rename-committed)

* atomic: packs, the manifest and the directory entries are written into a
  ``.tmp-`` directory and fsynced, then renamed; ``LATEST`` is updated last;
* async: ``save(blocking=False)`` compresses on the caller's thread, then
  writes on a background thread; ``wait()`` (and the next ``save``)
  re-raises its failure;
* parallel: records are serialized by a pool of ``writers`` threads and
  streamed round-robin (``index % n_packs``) to the pack files;
* verified: every record is framed (length + CRC32); ``load`` rejects a
  truncated or flipped record with :class:`CheckpointError` naming the
  record, its pack and its byte offset;
* retried: every pack and manifest read and every pack write goes through
  the manager's :class:`~repro_torch.runtime.retry.RetryPolicy` and the
  fault-injection hooks of ``runtime/faults.py``;
* degraded: under ``policy="degraded"`` a record that still fails (a bad
  frame, exhausted retries, a decode fault) is quarantined on a
  :class:`RestoreReport` and restored from the newest earlier step with an
  intact copy, while the other records keep the batched decode;
  ``policy="strict"`` (the default) raises on the first bad record;
* keep-last-k retention (counting only steps whose manifest parses, so a
  step that may hold the only intact copy of a record is never deleted)
  and stale-tmp GC.

``serving_layout="stream"|"fused"`` stores each policy-eligible weight in
its serving stream layout (the bundles ``assign_weight_modes`` builds), so
:meth:`CheckpointManager.load_for_serving` deserializes those records
straight into ``StreamedWeight`` / ``FusedWeight`` handles: only
compressed bytes cross host to device (the codec's ``h2d`` ledger), and the
dense weight never exists on the host.

``expert_records=True`` (with a serving layout) saves each ``(L, E,
...)`` MoE expert stack as ``L*E`` per-expert wire records named
``{leaf}::x{layer:04d}.{expert:04d}`` (manifest handle ``kind:
"expert"``); a tree holding ``ExpertRef`` handles re-emits its store's
records verbatim.  ``load`` reassembles the dense stacks;
``load_for_serving`` puts the records straight into an
:class:`~repro_torch.runtime.experts.ExpertStore`, with no upload and no
decode of a cold expert.

Trees are walked in the reference's flatten order (sorted dict keys), so
record names, indices and the pack round-robin match it.  Not ported yet
(ROADMAP Queue 1 item 12): placement on a mesh, which raises a clear error.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import wire as enec_wire
from repro_torch.core.api import (SUPPORTED_FLOAT_DTYPES, CompressedTensor,
                                  slice_stacked)
from repro_torch.core.codec_api import Codec, current_codec
from repro_torch.runtime import experts as rt_experts
from repro_torch.runtime import faults as rt_faults
from repro_torch.runtime import streaming as rt_streaming
from repro_torch.runtime.retry import RetryPolicy
from repro_torch.runtime.weights import (DenseWeight, finish_materialize,
                                         handle_from_spec, handle_spec,
                                         is_handle)

MANIFEST_FORMAT = "enec-v2"
RESTORE_POLICIES = ("strict", "degraded")

# tree roots that hold optimizer state: never stored in a serving layout
_NON_SERVING_ROOTS = frozenset({"opt", "opt_state", "optimizer"})


class CheckpointError(RuntimeError):
    """A checkpoint could not be saved or restored."""


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _leaf_nbytes(shape, dtype_str: str) -> int:
    itemsize = torch.empty((), dtype=getattr(torch, dtype_str)).element_size()
    return int(np.prod(shape, dtype=np.int64)) * itemsize


def _own_raw(item):
    """A payload item, its raw escape (a view of the leaf) copied."""
    if item[0] == "ct" and item[1].mode == "raw":
        ct = item[1]
        return ("ct", dataclasses.replace(ct, raw_bytes=ct.raw_bytes.clone()))
    return item


def _host_array(t: torch.Tensor) -> np.ndarray:
    """Host copy of a non-compressed leaf (bf16 travels as its int16
    bits: numpy has no bf16); a copy on the CPU too, so that an async save
    never reads a buffer its caller goes on to update."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _fsync_path(path) -> None:
    """fsync a file or directory (the rename commit is durable only once
    the parent's entries are)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@dataclasses.dataclass
class _ExpertPart:
    """One per-expert record queued for the batched decode of a ``load``:
    its manifest handle spec (parent, layer, expert) and its compressed
    tensor on the device.  The decode pass reassembles every part of a
    parent into the dense ``(L, E, ...)`` stack."""
    spec: dict
    ct: CompressedTensor


@dataclasses.dataclass
class QuarantinedRecord:
    """One record a restore could not use: its coordinates (name, pack,
    byte offset, length), why it was rejected, and, once the fallback
    succeeded, where the replacement came from."""
    name: str
    pack: str
    offset: int
    length: int
    cause: str
    fallback: str = ""

    def describe(self) -> str:
        line = (f"{self.name} [{self.pack} @ {self.offset}, "
                f"{self.length}B]: {self.cause}")
        if self.fallback:
            line += f" -> {self.fallback}"
        return line


@dataclasses.dataclass
class RestoreReport:
    """What a restore survived: the quarantined records with cause and
    fallback, and the manager's retry counters.  Every ``load`` and
    ``load_for_serving`` leaves its report on
    ``CheckpointManager.last_restore_report``; an empty quarantine list
    means the restore was clean."""
    step: int
    policy: str
    quarantined: list = dataclasses.field(default_factory=list)
    retry: dict = dataclasses.field(default_factory=dict)

    @property
    def degraded(self) -> bool:
        return bool(self.quarantined)

    def summary(self) -> str:
        head = (f"RestoreReport(step={self.step}, policy={self.policy}, "
                f"quarantined={len(self.quarantined)}, retry={self.retry})")
        return "\n".join([head] + ["  " + q.describe()
                                   for q in self.quarantined])


def _where(e: dict, packs) -> str:
    """The record's coordinates for an error message."""
    parts = [f"record={e['name']}"]
    if packs is not None and "pack" in e:
        parts += [f"pack={packs[e['pack']]}", f"offset={e['offset']}"]
    return " [" + ", ".join(parts) + "]"


@dataclasses.dataclass
class CheckpointManager:
    root: Path
    keep_last: int = 3
    compress: bool = True
    writers: int = 4                       # pack shards == writer threads
    serving_layout: Optional[str] = None   # None | "stream" | "fused"
    serving_min_bytes: int = rt_streaming.MIN_STREAM_BYTES
    serving_shards: int = 1
    expert_records: bool = False           # per-expert MoE records
    codec: Optional[Codec] = None          # default: ambient codec at init
    retry: Optional[RetryPolicy] = None    # default: RetryPolicy()
    device: Any = "cuda"                   # where restored tensors live
    _thread: Optional[threading.Thread] = None
    _exc: Optional[BaseException] = None

    def __post_init__(self):
        self.root = Path(self.root)
        self.device = resolve_device(self.device)
        if self.serving_layout not in (None, "stream", "fused"):
            raise ValueError(
                f"serving_layout must be None, 'stream' or 'fused', "
                f"got {self.serving_layout!r}")
        self.root.mkdir(parents=True, exist_ok=True)
        self.last_decode_plan = None   # DecodePlan of the latest load
        self.last_dense_records = []   # records the latest load moved dense
        self.last_expert_store = None  # ExpertStore of the latest serving load
        self.last_restore_report = None   # RestoreReport of the latest load
        if self.retry is None:
            self.retry = RetryPolicy()
        if self.codec is None:
            # captured once: every save and load of this manager encodes,
            # decodes and counts its transfers on ONE codec
            self.codec = current_codec()

    # -- save ------------------------------------------------------------

    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        """Compress ``tree`` on its device now; write it blocking or on a
        background thread."""
        self.wait()    # also re-raises a previous async failure
        names, leaves = _tree_paths(tree)
        payload, dense_specs = self._prepare(names, leaves)
        if blocking:
            self._save_host(step, names, payload, dense_specs)
            return
        # the caller may update the tree in place once this returns (the
        # optimizer's moments are): a raw escape, a view of its leaf, gets
        # bytes of its own before the thread reads them
        payload = [_own_raw(item) for item in payload]
        self._thread = threading.Thread(
            target=self._save_guarded,
            args=(step, names, payload, dense_specs), daemon=True)
        self._thread.start()

    def _save_guarded(self, step, names, payload, dense_specs):
        try:
            self._save_host(step, names, payload, dense_specs)
        except BaseException as e:  # noqa: BLE001 — surfaced via wait()
            self._exc = e

    def wait(self):
        """Join the in-flight async save and re-raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise CheckpointError(
                f"async checkpoint save failed: {exc}") from exc

    def _prepare(self, names, leaves):
        """Per-leaf record plan:
             ("np",  host_array, dtype)     raw host bytes (non-float)
             ("ct",  CompressedTensor)      plain enec/raw/const record
             ("hct", ct, spec, raw_bytes)   stacked serving-layout record
             ("xct", meta, records)         per-expert record group (MoE)
        """
        payload: list = [None] * len(leaves)
        float_slots, serve_jobs = [], []
        dense_specs: dict = {}   # slot -> handle spec for fallback leaves
        for i, (name, leaf) in enumerate(zip(names, leaves)):
            if is_handle(leaf):
                if isinstance(leaf, rt_experts.ExpertRef):
                    # the store holds the exact per-expert wire records:
                    # re-emitted verbatim, no re-encode
                    payload[i] = ("xct", leaf.store.meta(leaf.name),
                                  leaf.store.records_for(leaf.name))
                    continue
                if isinstance(leaf, DenseWeight):
                    leaf = leaves[i] = leaf.w   # re-wrapped on restore
                    dense_specs[i] = {"kind": "dense"}
                else:
                    spec = handle_spec(leaf)
                    raw = _leaf_nbytes(
                        (leaf.ct.streams.mask.shape[0],)
                        + tuple(spec.get("layer_shape")
                                or (spec["k"], spec["n"])), spec["dtype"])
                    payload[i] = ("hct", leaf.ct, spec, raw)
                    continue
            if not (self.compress and leaf.dtype in SUPPORTED_FLOAT_DTYPES):
                payload[i] = ("np", _host_array(leaf),
                              _dtype_name(leaf.dtype))
                continue
            if self.serving_layout is not None and i not in dense_specs \
                    and name.split("/", 1)[0] not in _NON_SERVING_ROOTS:
                if (self.expert_records
                        and rt_experts.is_expert_leaf(name, leaf)
                        and leaf.numel() * leaf.element_size()
                        >= self.serving_min_bytes):
                    enc = rt_experts.encode_expert_leaf(name, leaf,
                                                        self.codec)
                    if enc is not None:
                        payload[i] = ("xct",) + enc
                        continue
                    # const / incompressible: a monolithic record
                job = rt_streaming.serving_job(name, leaf,
                                               self.serving_layout,
                                               self.serving_min_bytes)
                if job is not None:
                    job["slot"] = i
                    serve_jobs.append(job)
                    continue
            float_slots.append(i)

        # serving-layout leaves: the exact stream bundles the policy builds,
        # one batched encode per shard width
        by_shards: dict = {}
        for job in serve_jobs:
            job_shards = (rt_streaming.fused_shards(
                job["k"], job["n"], self.serving_shards)
                if job["kind"] == "fused" else self.serving_shards)
            by_shards.setdefault(job_shards, []).append(job)
        for job_shards, jobs in sorted(by_shards.items()):
            cts = self.codec.compress_stacked_many(
                [job["arr"] for job in jobs], shards=job_shards)
            for job, ct in zip(jobs, cts):
                i = job["slot"]
                handle = rt_streaming.build_serving_handle(job, ct)
                if is_handle(handle) and not isinstance(handle, DenseWeight):
                    payload[i] = ("hct", handle.ct, handle_spec(handle),
                                  job["leaf"].numel()
                                  * job["leaf"].element_size())
                else:
                    # const / incompressible: a plain record, re-wrapped as
                    # DenseWeight by the restore policy
                    if job["matmul_pos"]:
                        dense_specs[i] = {"kind": "dense"}
                    float_slots.append(i)

        # every other float leaf is an L=1 stack of the batched pipeline:
        # per-leaf searched params, one launch per bucket
        float_slots.sort()
        cts = self.codec.compress_stacked_many(
            [leaves[i][None] for i in float_slots])
        for i, ct in zip(float_slots, cts):
            payload[i] = ("ct", self.codec.compress_array(leaves[i])
                          if ct is None else slice_stacked(ct, 0))
        return payload, dense_specs

    def _build_record(self, index, name, item, dense_specs):
        """List of (manifest entry sans pack/offset, framed blob, raw
        bytes): one for an ordinary leaf, one per expert for an ``xct``
        record group."""
        tag = item[0]
        if tag == "xct":
            _, meta, records = item
            eshape = [int(s) for s in meta["expert_shape"]]
            per_raw = _leaf_nbytes(eshape, meta["dtype"])
            out = []
            for l, j, body in records:
                entry = {"name": f"{name}::x{l:04d}.{j:04d}",
                         "index": index, "shape": eshape,
                         "dtype": meta["dtype"], "mode": "enec",
                         "handle": {"kind": "expert", "parent": name,
                                    "layer": int(l), "expert": int(j),
                                    "n_layers": int(meta["n_layers"]),
                                    "n_experts": int(meta["n_experts"]),
                                    "expert_shape": eshape,
                                    "dtype": meta["dtype"]},
                         "bytes": len(body)}
                out.append((entry, enec_wire.frame(body), per_raw))
            return out
        if tag == "np":
            _, leaf, dtype = item
            entry = {"name": name, "index": index, "shape": list(leaf.shape),
                     "dtype": dtype, "mode": "npraw"}
            blob = b"RAW0" + leaf.tobytes()
            raw = leaf.nbytes
        elif tag == "ct":
            ct = item[1]
            entry = {"name": name, "index": index, "shape": list(ct.shape),
                     "dtype": ct.dtype_str, "mode": ct.mode}
            if ct.params is not None:
                entry["params"] = list(ct.params.astuple())
            blob = enec_wire.to_wire(ct)
            raw = ct.nbytes_raw()
        else:   # "hct": stacked serving-layout record
            _, ct, spec, raw = item
            entry = {"name": name, "index": index,
                     "shape": list(ct.shape), "dtype": ct.dtype_str,
                     "mode": ct.mode, "handle": spec,
                     "stack": int(ct.streams.mask.shape[0]),
                     "params": list(ct.params.astuple())}
            blob = enec_wire.to_wire(ct, stacked=True)
        spec = dense_specs.get(index)
        if spec is not None and "handle" not in entry:
            entry["handle"] = spec
        entry["bytes"] = len(blob)
        return [(entry, enec_wire.frame(blob), raw)]

    def _save_host(self, step: int, names, payload, dense_specs) -> None:
        t0 = time.time()
        final = self.root / f"step_{step:012d}"
        tmp = self.root / f".tmp-step_{step:012d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        n_packs = max(1, min(self.writers, len(payload) or 1))
        manifest = {"format": MANIFEST_FORMAT, "step": step,
                    "packs": [f"pack-{i:05d}.bin" for i in range(n_packs)],
                    "leaves": []}
        if self.serving_layout is not None:
            manifest["serving_layout"] = {
                "mode": self.serving_layout,
                "min_bytes": self.serving_min_bytes,
                "shards": self.serving_shards}
        raw_total = comp_total = 0
        offsets = [0] * n_packs
        # records are built by the pool and streamed round-robin to the
        # packs through a bounded window: a few frames in host memory at a
        # time, never the whole checkpoint
        files = [open(tmp / name, "wb") for name in manifest["packs"]]
        workers = max(self.writers, 1)
        pending: deque = deque()

        def drain_one():
            nonlocal raw_total, comp_total
            i, fut = pending.popleft()
            pack = i % n_packs
            for entry, framed, raw in fut.result():
                entry["pack"] = pack
                entry["offset"] = offsets[pack]
                entry["length"] = len(framed)

                def write_framed(f=files[pack], pos=offsets[pack],
                                 fr=framed, name=manifest["packs"][pack]):
                    # seek to the record's offset on every attempt, so a
                    # retried write after a partial one lays it down once
                    rt_faults.check_write(name)
                    f.seek(pos)
                    f.write(fr)

                self.retry.call(write_framed)
                offsets[pack] += len(framed)
                raw_total += raw
                comp_total += entry["bytes"]
                manifest["leaves"].append(entry)

        try:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                for i, (n, it) in enumerate(zip(names, payload)):
                    pending.append((i, ex.submit(
                        self._build_record, i, n, it, dense_specs)))
                    if len(pending) >= 2 * workers:
                        drain_one()
                while pending:
                    drain_one()
            for f in files:
                f.flush()
                os.fsync(f.fileno())
        finally:
            for f in files:
                f.close()

        manifest["raw_bytes"] = raw_total
        manifest["compressed_bytes"] = comp_total
        manifest["ratio"] = raw_total / max(comp_total, 1)
        manifest["save_s"] = round(time.time() - t0, 3)
        with open(tmp / "manifest.json", "w") as f:
            f.write(json.dumps(manifest, indent=1))
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                       # atomic commit
        _fsync_path(self.root)
        latest_tmp = self.root / ".LATEST.tmp"
        with open(latest_tmp, "w") as f:
            f.write(final.name)
            f.flush()
            os.fsync(f.fileno())
        latest_tmp.rename(self.root / "LATEST")
        _fsync_path(self.root)
        self._gc()

    def _gc(self):
        # retention counts only steps whose manifest parses
        steps = sorted(p for p in self.root.glob("step_*") if p.is_dir())
        intact = [p for p in steps if self._try_manifest(p) is not None]
        for old in intact[: max(0, len(intact) - self.keep_last)]:
            shutil.rmtree(old, ignore_errors=True)
        for stale in self.root.glob(".tmp-step_*"):
            shutil.rmtree(stale, ignore_errors=True)

    # -- locating a step ----------------------------------------------------

    def latest_step(self) -> Optional[int]:
        """Step named by ``LATEST``, or None when it is missing or garbage."""
        try:
            text = (self.root / "LATEST").read_text()
        except OSError:
            return None
        try:
            return int(text.strip().split("_")[-1])
        except ValueError:
            return None

    def manifest(self, step: Optional[int] = None) -> dict:
        """The manifest of ``step`` (default: latest), no record read."""
        return self._step_dir(step)[1]

    def _try_manifest(self, cdir) -> Optional[dict]:
        path = cdir / "manifest.json"
        try:
            raw = self.retry.call(lambda: rt_faults.read_file(path))
            return json.loads(raw.decode())
        except (OSError, ValueError):
            return None

    def _step_candidates(self) -> list:
        out = []
        s = self.latest_step()
        if s is not None:
            out.append(s)
        for p in sorted(self.root.glob("step_*"), reverse=True):
            if not p.is_dir():
                continue
            try:
                c = int(p.name.split("_")[-1])
            except ValueError:
                continue
            if c not in out:
                out.append(c)
        return out

    def _step_dir(self, step: Optional[int]) -> tuple:
        """``(cdir, manifest)``; an explicit step must be intact, ``None``
        falls back from ``LATEST`` to the newest step that parses."""
        if step is not None:
            cdir = self.root / f"step_{step:012d}"
            path = cdir / "manifest.json"
            if not path.exists():
                raise CheckpointError(f"{cdir} has no manifest.json")
            try:
                raw = self.retry.call(lambda: rt_faults.read_file(path))
                return cdir, json.loads(raw.decode())
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                raise CheckpointError(f"{path} is corrupt: {e}") from e
        candidates = self._step_candidates()
        if not candidates:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        causes = []
        for c in candidates:
            try:
                return self._step_dir(c)
            except CheckpointError as e:
                causes.append(str(e))
        raise CheckpointError("no step with an intact manifest under "
                              f"{self.root}: " + "; ".join(causes))

    # -- reading records ----------------------------------------------------

    @staticmethod
    def _require_records(names, by_name, cdir, what="records", groups=None):
        missing = [n for n in names
                   if n not in by_name and not (groups and n in groups)]
        if missing:
            raise CheckpointError(
                f"checkpoint {cdir.name} lacks {what} for {missing[:5]}"
                + ("…" if len(missing) > 5 else "")
                + f" [record={missing[0]}]")

    @staticmethod
    def _expert_groups(manifest) -> dict:
        """parent leaf name -> its per-expert record entries."""
        groups: dict = {}
        for e in manifest["leaves"]:
            spec = e.get("handle")
            if spec is not None and spec.get("kind") == "expert":
                groups.setdefault(spec["parent"], []).append(e)
        return groups

    @staticmethod
    def _expand_entries(names, by_name, groups):
        """Record entries to read for ``names``, expert groups inlined."""
        out = []
        for n in names:
            if n in by_name:
                out.append(by_name[n])
            else:
                out.extend(groups[n])
        return out

    @staticmethod
    def _check_leaf(e, shape, like, packs, dtype=None):
        if tuple(shape) != tuple(like.shape):
            raise CheckpointError(
                f"{e['name']}: ckpt {tuple(shape)} vs model "
                f"{tuple(like.shape)}" + _where(e, packs))
        if dtype is not None and dtype != _dtype_name(like.dtype):
            raise CheckpointError(
                f"{e['name']}: ckpt dtype {dtype} vs model "
                f"{_dtype_name(like.dtype)}" + _where(e, packs))

    def _quarantine(self, report, e, manifest, cause) -> QuarantinedRecord:
        """Record one failed record on ``report`` with its coordinates."""
        packs = manifest.get("packs")
        pack = (packs[e["pack"]] if packs is not None and "pack" in e
                else f"t_{e.get('index', 0):05d}.enec")
        q = QuarantinedRecord(
            name=e["name"], pack=pack, offset=int(e.get("offset", 0)),
            length=int(e.get("length", e.get("bytes", -1))), cause=cause)
        report.quarantined.append(q)
        return q

    def _iter_records(self, cdir, manifest, entries, report=None):
        """Yield ``(entry, payload)`` for ``entries``, validated (frame
        length + CRC for enec-v2 packs, declared size for v1 files), in
        pack/offset order; only the requested records are read.  Every
        read goes through the retry policy and the fault hooks.  Without
        a ``report`` (strict) the first record that still fails raises;
        with one it is quarantined and skipped, and the caller arranges
        its fallback."""
        fmt = manifest.get("format", "enec-v1")
        if fmt == "enec-v1":
            for e in entries:
                path = cdir / f"t_{e['index']:05d}.enec"
                try:
                    blob = self.retry.call(
                        lambda p=path: rt_faults.read_file(p))
                    if "bytes" in e and len(blob) != e["bytes"]:
                        raise CheckpointError(
                            f"{path.name}: {len(blob)} bytes on disk, "
                            f"manifest declares {e['bytes']} — truncated or "
                            f"corrupt [record={e['name']}, pack={path.name}, "
                            f"offset=0]")
                except OSError as err:
                    if report is None:
                        raise CheckpointError(
                            f"{path.name} ({e['name']}): {err}") from err
                    self._quarantine(report, e, manifest, str(err))
                    continue
                except CheckpointError as err:
                    if report is None:
                        raise
                    self._quarantine(report, e, manifest, str(err))
                    continue
                self.codec.count_link("disk", len(blob),
                                      dense=e.get("mode") == "npraw")
                yield e, blob
            return
        if fmt != MANIFEST_FORMAT:
            raise CheckpointError(f"unknown checkpoint format {fmt!r}")
        by_pack: dict = {}
        for e in entries:
            by_pack.setdefault(e["pack"], []).append(e)
        for pack, es in sorted(by_pack.items()):
            path = cdir / manifest["packs"][pack]
            for e in sorted(es, key=lambda e: e["offset"]):
                try:
                    buf = self.retry.call(
                        lambda e=e: rt_faults.read_range(path, e["offset"],
                                                         e["length"]))
                    payload, end = enec_wire.read_frame(
                        buf, record=e["name"], pack=path.name,
                        base_offset=e["offset"])
                    if end != len(buf):
                        raise enec_wire.WireError(
                            f"frame length {end} != indexed {len(buf)}")
                except (OSError, enec_wire.WireError) as err:
                    if isinstance(err, enec_wire.WireError):
                        err.with_context(record=e["name"], pack=path.name,
                                         offset=e["offset"])
                    if report is None:
                        raise CheckpointError(
                            f"{path.name} @ {e['offset']} ({e['name']}): "
                            f"{err}") from err
                    self._quarantine(report, e, manifest, str(err))
                    continue
                self.codec.count_link("disk", len(payload),
                                      dense=e.get("mode") == "npraw")
                yield e, payload

    def _decode_npraw(self, e, blob, packs) -> torch.Tensor:
        blob = bytes(blob)
        if blob[:4] != b"RAW0":
            raise CheckpointError(f"corrupt raw blob for {e['name']}"
                                  + _where(e, packs))
        bf16 = e["dtype"] == "bfloat16"
        arr = np.frombuffer(blob[4:], np.int16 if bf16
                            else np.dtype(e["dtype"]))
        if arr.size != int(np.prod(e["shape"], dtype=np.int64)):
            raise CheckpointError(
                f"{e['name']}: raw payload holds {arr.size} elements, "
                f"manifest declares shape {e['shape']}" + _where(e, packs))
        t = enec_wire.h2d(arr.reshape(e["shape"]), self.device, self.codec,
                          dense=True)
        self.last_dense_records.append(e["name"])
        return t.view(torch.bfloat16) if bf16 else t

    def _record_ct(self, e, blob, packs) -> CompressedTensor:
        """Deserialize one compressed record; its streams move to the
        device here (counted on this manager's codec), nothing is
        decoded."""
        pack = packs[e["pack"]] if packs is not None and "pack" in e \
            else None
        try:
            ct = enec_wire.from_wire(blob, codec=self.codec,
                                     device=self.device, record=e["name"],
                                     pack=pack, offset=e.get("offset"))
        except enec_wire.WireError as err:
            err.with_context(record=e["name"], pack=pack,
                             offset=e.get("offset"))
            raise CheckpointError(f"{e['name']}: {err}") from err
        if ct.mode == "raw":
            self.last_dense_records.append(e["name"])
        return ct

    def _queue_record(self, e, blob, pending, vals, like, packs):
        """An ``npraw`` record becomes a device tensor now; a compressed
        one is queued for the batched decode (serving-layout records as
        handles, plain ones as CompressedTensors)."""
        if e["mode"] == "npraw":
            val = self._decode_npraw(e, blob, packs)
            self._check_leaf(e, val.shape, like, packs)
            vals[e["name"]] = val.to(like.dtype)
            return
        ct = self._record_ct(e, blob, packs)
        spec = e.get("handle")
        if spec is not None and spec.get("kind") == "expert":
            # one slice of a per-expert record group, reassembled into
            # its dense parent stack after the batched decode
            pending.append((e, like, _ExpertPart(spec, ct)))
            return
        obj = (handle_from_spec(spec, ct)
               if spec is not None and e.get("stack") else ct)
        pending.append((e, like, obj))

    def _decode_pending(self, pending, vals, packs):
        """Decode every queued record in ONE batched pass: O(#buckets)
        decoder launches; the plan's summary is kept on
        ``last_decode_plan``."""
        plan = self.codec.plan_decode(
            [obj.ct if is_handle(obj) or isinstance(obj, _ExpertPart)
             else obj for _, _, obj in pending])
        decs = self.codec.execute(plan)
        # keep only the summary: the execution state pins the streams
        self.last_decode_plan = dataclasses.replace(
            plan, _groups=[], _passthrough={}, _leaves=[], _tree=None)
        parents: dict = {}
        for (e, like, obj), dec in zip(pending, decs):
            if isinstance(obj, _ExpertPart):
                g = parents.setdefault(obj.spec["parent"],
                                       {"like": like, "spec": obj.spec,
                                        "decs": {}})
                g["decs"][(int(obj.spec["layer"]),
                           int(obj.spec["expert"]))] = dec
                continue
            val = finish_materialize(obj, dec) if is_handle(obj) else dec
            self._check_leaf(e, val.shape, like, packs)
            # a const record decodes to a broadcast view: give it storage
            vals[e["name"]] = val.to(like.dtype).contiguous()
        for parent, g in parents.items():
            sp = g["spec"]
            nl, ne = int(sp["n_layers"]), int(sp["n_experts"])
            eshape = tuple(int(s) for s in sp["expert_shape"])
            self._check_leaf({"name": parent}, (nl, ne) + eshape, g["like"],
                             None)
            buf = torch.empty((nl, ne) + eshape,
                              dtype=getattr(torch, sp["dtype"]),
                              device=self.device)
            for l in range(nl):
                for j in range(ne):
                    dec = g["decs"].get((l, j))
                    if dec is None:
                        raise CheckpointError(
                            f"{parent}: expert record grid incomplete — "
                            f"missing layer {l} expert {j}")
                    buf[l, j] = dec
            vals[parent] = buf.to(g["like"].dtype)

    def _apply_decode_faults(self, pending, manifest, by_name, report):
        """The decode fault hook: records an active "decode" fault matches
        leave the batched plan before it is built, quarantined (degraded)
        or fatal (strict), so the others still decode in one pass.  No-op
        without an active injector."""
        if rt_faults.active() is None:
            return pending
        out = []
        for item in pending:
            name = item[0]["name"]
            try:
                rt_faults.check_decode(name)
            except rt_faults.InjectedFault as err:
                if report is None:
                    raise CheckpointError(
                        f"decode failed for {name}: {err}") from err
                self._quarantine(report, by_name.get(name, {"name": name}),
                                 manifest, f"decode failed: {err}")
                continue
            out.append(item)
        return out

    def _intact_steps(self, before: Optional[int] = None) -> list:
        """``(step, cdir, manifest)`` of every committed step whose
        manifest parses, newest first; ``before`` excludes that step and
        every newer one (a fallback never reads forward in time)."""
        out = []
        for p in sorted(self.root.glob("step_*"), reverse=True):
            if not p.is_dir():
                continue
            try:
                s = int(p.name.split("_")[-1])
            except ValueError:
                continue
            if before is not None and s >= before:
                continue
            man = self._try_manifest(p)
            if man is not None:
                out.append((s, p, man))
        return out

    def _fallback_restore(self, report, manifest, like_by_name, vals,
                          pending, process=None):
        """Restore each quarantined record from the newest earlier step
        holding an intact copy: read, validated, shape-checked and
        decode-fault-checked like a first-class record.  ``process``
        stages a recovered record (the serving restore's adopt-or-queue);
        by default it is queued for the batched decode.  A record with no
        intact source anywhere raises: a degraded restore never makes up
        weights."""
        steps = self._intact_steps(before=manifest.get("step"))
        for q in report.quarantined:
            if q.fallback or q.name not in like_by_name:
                continue
            like = like_by_name[q.name]
            for s, fcdir, fman in steps:
                fe = next((e for e in fman["leaves"]
                           if e["name"] == q.name), None)
                if fe is None:
                    continue
                n_pend = len(pending)
                try:
                    got = False
                    for e2, payload in self._iter_records(fcdir, fman,
                                                          [fe]):
                        if process is not None:
                            process(e2, payload, like, fman, pending, vals)
                        else:
                            self._queue_record(e2, payload, pending, vals,
                                               like, fman.get("packs"))
                        got = True
                    if not got:
                        raise CheckpointError(
                            f"{q.name}: record unreadable at step {s}")
                    new = pending[n_pend:]
                    if new:
                        pending[n_pend:] = self._apply_decode_faults(
                            new, fman, {q.name: fe}, None)
                except (OSError, CheckpointError, enec_wire.WireError):
                    # this step cannot supply the record: undo its staging
                    # and look further back
                    del pending[n_pend:]
                    vals.pop(q.name, None)
                    continue
                kind = ((fe.get("handle") or {}).get("kind")
                        or fe.get("mode", "?"))
                q.fallback = f"step {s} ({kind} record)"
                break
            if not q.fallback:
                raise CheckpointError(
                    "restore failed — no intact source for quarantined "
                    "record(s):\n" + report.summary())

    @staticmethod
    def _begin_report(policy, manifest, mesh=None) -> RestoreReport:
        if policy not in RESTORE_POLICIES:
            raise ValueError(f"unknown restore policy {policy!r}; "
                             f"expected one of {RESTORE_POLICIES}")
        if mesh is not None:
            raise CheckpointError("restoring onto a mesh is not ported yet "
                                  "(ROADMAP Queue 1, item 12)")
        return RestoreReport(step=int(manifest.get("step", -1)),
                             policy=policy)

    def _finish_report(self, report) -> None:
        report.retry = self.retry.stats()
        self.last_restore_report = report

    def load(self, like_tree, step: Optional[int] = None, *,
             policy: str = "strict"):
        """Restore the dense tree shaped like ``like_tree`` (tensors, or
        ``meta`` tensors for shape and dtype) onto the manager's device.
        Returns ``(tree, manifest)``.

        ``policy="strict"`` (default) raises on the first bad record;
        ``policy="degraded"`` quarantines a record that fails I/O,
        validation or decode and restores it from the newest earlier step
        with an intact copy (``last_restore_report`` lists each one with
        its cause and fallback).  A record with no intact source anywhere
        still raises: degraded trades freshness, never correctness."""
        self.last_dense_records = []
        cdir, manifest = self._step_dir(step)
        report = self._begin_report(policy, manifest)
        rep = report if policy == "degraded" else None
        names, leaves = _tree_paths(like_tree)
        by_name = {e["name"]: e for e in manifest["leaves"]}
        groups = self._expert_groups(manifest)
        self._require_records(names, by_name, cdir, groups=groups)
        like_by_name = dict(zip(names, leaves))
        for parent in groups:
            if parent in like_by_name:
                # sub-records validate (and fall back) against their parent
                for e in groups[parent]:
                    like_by_name[e["name"]] = like_by_name[parent]
        packs = manifest.get("packs")
        vals: dict = {}
        pending: list = []
        for e, payload in self._iter_records(
                cdir, manifest, self._expand_entries(names, by_name, groups),
                report=rep):
            try:
                self._queue_record(e, payload, pending, vals,
                                   like_by_name[e["name"]], packs)
            except CheckpointError as err:
                if rep is None:
                    raise
                self._quarantine(rep, e, manifest, str(err))
        pending = self._apply_decode_faults(pending, manifest, by_name, rep)
        if rep is not None and rep.quarantined:
            self._fallback_restore(rep, manifest, like_by_name, vals,
                                   pending)
        self._decode_pending(pending, vals, packs)
        self._finish_report(report)
        tree = rt_streaming.tree_map_with_path(lambda p, _: vals.pop(p),
                                               like_tree)
        return tree, manifest

    # -- restore straight into serving handles ----------------------------

    @staticmethod
    def _spec_serves_mode(spec: dict, mode: str,
                          degraded: bool = False) -> bool:
        """Can a stored serving-layout record be adopted as-is under
        ``mode``?  ``degraded`` relaxes the answer for a quarantined
        record's fallback copy: every compressed handle kind runs the
        canonical contraction with the same bits, so a damaged fused
        record may adopt an earlier step's stream record and the other
        way round (slower, never different).  The main pass keeps the
        strict answer."""
        kind = spec.get("kind")
        if mode == "fused":
            return kind == "fused" or (
                kind == "stream"
                and (degraded
                     or spec.get("execution", "materialize")
                     == "materialize"))
        if mode == "stream":
            return kind == "stream" or (degraded and kind == "fused")
        return False

    def load_for_serving(self, like_params, *, mode: str = "fused",
                         step: Optional[int] = None, prefix: str = "",
                         min_bytes: int = rt_streaming.MIN_STREAM_BYTES,
                         shards: int = rt_streaming.STREAM_SHARDS,
                         policy: str = "strict", mesh=None,
                         expert_store=None):
        """Restore ONLY the weight records into a serving handle tree.

        ``like_params`` gives the structure, shapes and dtypes (``meta``
        tensors are fine: nothing is allocated from it); ``prefix``
        namespaces the record names ("params" for a checkpoint saved as
        ``{"params": ...}``).  Records stored in a layout that serves
        ``mode`` deserialize straight into handles, moving only compressed
        bytes to the device; everything else is decoded in one batched
        pass and handed to ``assign_weight_modes``, which passes the
        adopted handles through.

        ``policy="degraded"`` serves through damage: a record that fails
        I/O, validation or decode is quarantined and restored from the
        newest earlier step with an intact copy, adopted as a handle when
        its layout serves ``mode`` (any compressed kind, for a fallback)
        and decoded otherwise; the rest restores batched as before, and
        the logits do not change.  ``last_restore_report`` lists each
        quarantined record's cause and fallback.

        Per-expert records (``expert_records=True`` saves) go straight into
        an :class:`~repro_torch.runtime.experts.ExpertStore`
        (``expert_store``, or a new unbounded one on the manager's device,
        kept on ``last_expert_store``) as wire bytes: no cold expert is
        uploaded or decoded.  The tree gets an ``ExpertRef`` for each
        stack.  Returns ``(tree, manifest)``."""
        if mode not in rt_streaming.WEIGHT_MODES:
            raise ValueError(f"unknown weight mode {mode!r}")
        self.last_dense_records = []
        cdir, manifest = self._step_dir(step)
        report = self._begin_report(policy, manifest, mesh)
        rep = report if policy == "degraded" else None
        names, leaves = _tree_paths(like_params)
        full = [f"{prefix}/{n}" if prefix else n for n in names]
        by_name = {e["name"]: e for e in manifest["leaves"]}
        groups = {p: es for p, es in self._expert_groups(manifest).items()
                  if p in set(full)}
        est = expert_store
        if est is None and groups:
            est = rt_experts.ExpertStore(codec=self.codec,
                                         device=self.device)
        self.last_expert_store = est if groups else None
        self._require_records(full, by_name, cdir, what="weight records",
                              groups=groups)
        like_by_name = dict(zip(full, leaves))
        for parent, es in groups.items():
            for e in es:
                like_by_name[e["name"]] = like_by_name[parent]
        vals: dict = {}
        pending: list = []

        def serve_record(e, payload, like, man, pending, vals):
            """Adopt a serving-layout record as a handle, else queue it for
            the batched decode: the main pass's path and the fallback's,
            so a recovered record takes the path it would have taken
            undamaged."""
            name, spec, packs = e["name"], e.get("handle"), man.get("packs")
            if spec is not None and spec.get("kind") == "expert":
                # the compressed bytes go straight into the store: cold
                # experts stay wire records until routing asks for them
                est.add_meta(spec["parent"], n_layers=spec["n_layers"],
                             n_experts=spec["n_experts"],
                             expert_shape=spec["expert_shape"],
                             dtype=spec["dtype"])
                est.add_record(spec["parent"], spec["layer"],
                               spec["expert"], bytes(payload))
                return
            # a record quarantined already is an earlier step's copy
            is_fallback = rep is not None and any(
                q.name == name for q in rep.quarantined)
            if spec and spec["kind"] != "dense" and e.get("stack") \
                    and self._spec_serves_mode(spec, mode,
                                               degraded=is_fallback):
                if spec["kind"] == "stream":
                    leaf_shape = (tuple(spec["layer_shape"])
                                  if spec.get("flat") else
                                  (int(e["stack"]),)
                                  + tuple(spec["layer_shape"]))
                else:
                    leaf_shape = (int(e["stack"]), int(spec["k"]),
                                  int(spec["n"]))
                self._check_leaf(e, leaf_shape, like, packs,
                                 dtype=spec["dtype"])
                ct = self._record_ct(e, payload, packs)
                # adopt only at the shard width the policy would pick (a
                # fallback at whatever width it has: every width gives the
                # same bits); otherwise decode and let the policy re-lay
                # it out
                req_shards = (rt_streaming.fused_shards(
                    int(spec["k"]), int(spec["n"]), shards)
                    if spec["kind"] == "fused" else shards)
                if ct.shards == req_shards or is_fallback:
                    vals[name] = handle_from_spec(spec, ct)
                else:
                    pending.append((e, like, handle_from_spec(spec, ct)))
                return
            self._queue_record(e, payload, pending, vals, like, packs)

        for e, payload in self._iter_records(
                cdir, manifest, self._expand_entries(full, by_name, groups),
                report=rep):
            try:
                serve_record(e, payload, like_by_name[e["name"]], manifest,
                             pending, vals)
            except CheckpointError as err:
                if rep is None:
                    raise
                self._quarantine(rep, e, manifest, str(err))
        pending = self._apply_decode_faults(pending, manifest, by_name, rep)
        if rep is not None and rep.quarantined:
            self._fallback_restore(rep, manifest, like_by_name, vals,
                                   pending, process=serve_record)
        self._decode_pending(pending, vals, manifest.get("packs"))
        for parent in groups:
            m = est.meta(parent)
            self._check_leaf({"name": parent},
                             (m["n_layers"], m["n_experts"])
                             + tuple(m["expert_shape"]),
                             like_by_name[parent], None, dtype=m["dtype"])
            miss = est.missing(parent)
            if miss:
                raise CheckpointError(
                    f"{parent}: expert record grid incomplete — missing "
                    f"{miss[:5]}" + ("…" if len(miss) > 5 else ""))
            vals[parent] = est.ref(parent)
        self._finish_report(report)
        tree = rt_streaming.tree_map_with_path(
            lambda p, _: vals.pop(f"{prefix}/{p}" if prefix else p),
            like_params)
        tree = rt_streaming.assign_weight_modes(
            tree, mode=mode, min_bytes=min_bytes, shards=shards,
            codec=self.codec)
        return tree, manifest


def _tree_paths(tree):
    """Leaf names and leaves in the reference's flatten order (sorted dict
    keys), weight handles as leaves."""
    pairs = list(rt_streaming.tree_leaves(tree))
    return [n for n, _ in pairs], [leaf for _, leaf in pairs]
