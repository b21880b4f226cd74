"""Dry-run of the port's programs on the production mesh, on ``meta``
tensors: the counterpart of ``repro/launch/dryrun.py``'s ``lower_cell`` /
``run_cell`` / ``main``.

For every (architecture x input-shape) cell this module runs, on ``meta``
tensors (no device, nothing allocated, no kernel built), the program that
rank 0 of the port runs on the production mesh (16x16 single-pod, 2x16x16
multi-pod; ``launch/mesh.py:AbstractMesh``, whose collectives are recorded,
not run):

  train   ``runtime/steps.py:build_train_step(..., mesh=)`` on the rank's
          shards of the parameters and AdamW moments (``elastic.
          train_pspecs``): the dense parameter gather, forward and backward
          over the rank's rows of the batch (each period rematerialised:
          :func:`run_cell` sets ``remat`` on every train cell, as the
          reference's dry-run does, under the config's policy or the
          ``remat_dots`` variant's), the rank-ordered gradient sum over
          the batch's axes (("pod", "data") on the multi-pod mesh, where
          the parameters are replicated across "pod") and AdamW on the
          shards;
  prefill ``build_prefill_step`` / ``build_decode_step(..., mesh=)`` under
  decode  the serving mesh (``runtime/collectives.py``): the rank holds its
          own stream shards and gathers the others' at each use; the dense
          math runs whole over the rank's block of the batch
          (``sharding.batch_pspecs``), and the rank holds its block of the
          cache of ``registry.input_specs`` (``sharding.
          port_cache_pspecs``: the K/V rings' sequence, and whisper's
          encoder memory's, on "model", or ("pod", "model") beside an
          unsharded batch, where ``sharding.kv_layout``'s rule allows;
          Mamba's ``h`` by d_state and ``conv`` by channels on "model"
          where they divide, and an sLSTM's ``h`` by D, ``sharding.
          state_layout``; the sLSTM's ``c`` / ``n`` / ``m`` and the
          mLSTM states on the batch only).  A decode step's attention
          gathers over the sequence axes: the scores, or under the
          ``flash_decode`` variant (``cfg.decode_score_shard``) the
          softmax's stats and per-chunk partials only (``models/
          layers.py:rank_decode_attention``), the cross attention over
          a sharded memory likewise; a Mamba step gathers its conv
          output and its read-out's products (``models/ssm.py:
          rank_mamba_step``), an sLSTM step its bf16 ``h`` (``models/
          xlstm.py:rank_slstm_step``).  The rank holds
          its share of the MoE expert stacks (``sharding.
          expert_layout``; "serve_ep" for the ``ep_*`` variants, which
          places what "serve" places in the port) and its MoE blocks
          exchange activations (``models/moe.py``); the record's
          ``experts`` says what it holds.

What a record holds (the reference's schema, so ``launch/roofline.py``
reads either):

  cost.flops            matmul FLOPs: the aten ops ``torch.utils.
                        flop_counter`` has formulas for, plus the kernels'
                        analytic FLOPs (``kernels/cost.py``);
                        ``cost["elementwise flops"]`` apart: one a
                        pointwise op's output element (the fixed-order
                        decode attention's products and sums are there);
  cost["bytes accessed"] each op's tensor inputs plus outputs (views and
                        ``empty`` move none), plus the kernels' bytes: an
                        un-fused upper bound, every intermediate written
                        and read back through device memory;
  memory.peak_memory_in_bytes  the peak of live non-view bytes: the
                        program's inputs (parameters or their shards, AdamW
                        state, batch, cache), plus each op's new outputs
                        until their tensors die;
  collectives           the abstract mesh's records through
                        ``launch/collective_stats.py``;
  kernels               launches, FLOPs and bytes by kernel (the launches
                        are the ``build.LaunchCounter`` counts the card
                        would add);
  program               one line: what the rank ran.

No scan correction: the port runs every layer eagerly, so a period is
never counted once, and every record is ``layers_mode: "unroll"`` with no
``p0`` / ``p1``.  The recurrent time loops (Mamba, mLSTM, sLSTM prefill
and training) run two steps on ``meta`` (``models/layers.py:scan_steps``):
the first, and one standing for the rest, whose kernel launches count
once a remaining step (``kernels/cost.py:repeated``), as the card
launches them.  So their FLOPs and bytes are the loop body's, as the
reference's cost analysis counts a scan body, and ``launch/roofline.py``
adds the other steps' FLOPs as the reference's does.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_1b \\
      --shape decode_32k --single-only
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --single-only [--variant streamed] [--mesh-shape 4x64]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.api import CompressedTensor
from repro_torch.core.codec import BlockStreams
from repro_torch.core.codec_api import Codec, use_codec
from repro_torch.core.params import EnecParams
from repro_torch.kernels import cost as kernel_cost
from repro_torch.launch import collective_stats
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import build_model
from repro_torch.models.lm import block_program
from repro_torch.models.registry import (abstract_params, active_param_count,
                                         input_specs, param_count)
from repro_torch.optim import adamw
from repro_torch.runtime import collectives, elastic, sharding, streaming
from repro_torch.runtime.overlap import build_schedule, overlap_enabled
from repro_torch.runtime.steps import (build_decode_step, build_prefill_step,
                                       serving_layouts,
                                       build_train_step)
from repro_torch.runtime.weights import (DenseWeight, is_handle,
                                         tree_leaves, tree_map_with_path)

# the paper's Table IV parameters, those of the reference's streamed
# variant
TABLE_IV = EnecParams(b=122, n=6, m=3, L=16, l=96)

VARIANT_TWEAKS = {
    "baseline": {},
    "streamed": {},
    "remat_dots": {"remat_policy": "dots"},
    "bf16_combine": {"moe_combine_dtype": "bf16"},
    "ep_contract": {},
    "ep_contract_bf16": {"moe_combine_dtype": "bf16"},
    "ep_a2a": {"moe_dispatch_a2a": True},
    "flash_decode": {"decode_score_shard": True},
    "attn_chunk_full": {"attn_chunk": 1 << 20},  # single-pass softmax attn
}
# the serving weight mode of a variant (baseline: the reference's plain
# parameters, which the port serves as dense handles)
VARIANT_MODE = {"streamed": "stream"}



def variant_skip(variant: str, kind: str):
    """Why the port's program cannot express ``variant`` for a cell of
    ``kind``, or None."""
    if variant == "streamed" and kind == "train":
        return "the port trains dense parameters only"
    return None


def _periods(cfg) -> int:
    if cfg.is_encdec:
        return cfg.n_layers
    return cfg.n_layers // len(block_program(cfg))


def production_mesh(multi_pod: bool = False, shape=None) -> AbstractMesh:
    """Rank 0 of the 16x16 (or 2x16x16) mesh, or of a ``(data, model)``
    mesh of ``shape`` (``(pod, data, model)`` for three sizes)."""
    if shape is not None:
        axes = ("pod", "data", "model") if len(shape) == 3 \
            else ("data", "model")
        return AbstractMesh(tuple(shape), axes)
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


# ---------------------------------------------------------------------------
# counting: FLOPs, bytes and live memory of the ops a program runs
# ---------------------------------------------------------------------------

def tensors_bytes(*trees) -> int:
    """Bytes of the distinct storages of every tensor in ``trees`` (handle
    trees, NamedTuples, dicts and lists of tensors)."""
    seen, total = set(), 0
    for t in _flat_tensors(trees, []):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


_EMPTY = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
          torch.ops.aten.empty_like, torch.ops.aten.new_empty,
          torch.ops.aten.new_empty_strided}


def _flat_tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results, or of a serving tree:
    tensors, and lists, tuples and dicts of them, compressed tensors and
    weight handles."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _flat_tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _flat_tensors(v, out)
    elif isinstance(x, CompressedTensor):
        _flat_tensors((x.streams, x.raw_bytes), out)
    elif is_handle(x):
        for f in dataclasses.fields(x):
            _flat_tensors(getattr(x, f.name), out)
    return out


_OPS: dict = {}   # op -> (FLOP formula, moves bytes, fresh outputs, pointwise)


def _op_info(func) -> tuple:
    info = _OPS.get(func)
    if info is None:
        packet = func._overloadpacket
        returns = func._schema.returns
        aliased = [r.alias_info is not None for r in returns]
        view = bool(returns) and all(a and not r.alias_info.is_write
                                     for a, r in zip(aliased, returns))
        info = _OPS[func] = (flop_registry.get(packet),
                             not view and packet not in _EMPTY,
                             not any(aliased),
                             torch.Tag.pointwise in func.tags)
    return info


class CostMode(TorchDispatchMode):
    """Counts every aten op run under it: matmul FLOPs (``flop_counter``'s
    formulas), elementwise FLOPs, bytes (tensor inputs plus outputs; views
    and ``empty`` none) and the live bytes of the new outputs, from
    ``live`` bytes of inputs at the start, keeping the peak.  A new
    output's bytes stay live until its storage dies, not the tensor: a
    view or ``detach()`` of it may outlive it (remat's kept products)."""

    def __init__(self, live: int = 0):
        super().__init__()
        self.flops = 0
        self.elementwise = 0
        self.bytes = 0
        self.ops = 0
        self.live = self.peak = int(live)
        self._refs: dict = {}      # id(weakref) -> (weakref, bytes)

    def _died(self, ref) -> None:
        self.live -= self._refs.pop(id(ref))[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        formula, moves, fresh, pointwise = _op_info(func)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        outs = _flat_tensors(out, [])
        if pointwise:
            self.elementwise += sum(t.numel() for t in outs)
        if moves:
            self.bytes += sum(t.numel() * t.element_size() for t in
                              _flat_tensors((args, kwargs), outs[:]))
        if fresh:
            for t in outs:
                storage = t.untyped_storage()
                ref = weakref.ref(storage, self._died)
                self._refs[id(ref)] = (ref, storage.nbytes())
                self.live += storage.nbytes()
            self.peak = max(self.peak, self.live)
        return out


# ---------------------------------------------------------------------------
# a cell's program
# ---------------------------------------------------------------------------

def _meta_like(a: torch.Tensor, shape) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=a.dtype, device="meta")


def expert_mode_of(variant: str, kind: str) -> str:
    """The expert layout's mode of a cell: "serve_ep" for the ``ep_*``
    variants' serving cells, as the reference's ``lower_cell`` picks it,
    else "serve"."""
    if variant.startswith(("ep_contract", "ep_a2a")) and kind != "train":
        return "serve_ep"
    return "serve"


def place_abstract(tree, mesh, axis: str = collectives.MODEL_AXIS,
                   expert_mode: str = "serve"):
    """The serving tree as rank ``mesh.rank`` holds it: each sharded stream
    cut to the rank's own shard rows and each MoE expert stack to the
    rank's share (``collectives.place_serving_tree``'s layout, on ``meta``
    tensors)."""
    A = mesh.shape.get(axis, 1)

    def place(ct):
        if not collectives._shardable(ct, A):
            return ct
        specs = sharding.ct_pspecs(ct, mesh, axis)
        return dataclasses.replace(ct, streams=BlockStreams(*(
            _meta_like(a, sharding.local_shard(a, spec, mesh).shape)
            for a, spec in zip(ct.streams, specs))))

    layouts = collectives.expert_layouts(tree, mesh, expert_mode)

    def one(path, leaf):
        if path in layouts:
            return collectives.place_expert(leaf, layouts[path], mesh, axis)
        if is_handle(leaf) and isinstance(getattr(leaf, "ct", None),
                                          CompressedTensor):
            return dataclasses.replace(leaf, ct=place(leaf.ct))
        return leaf

    return tree_map_with_path(one, tree)


def expert_record(whole, placed, mesh, expert_mode: str):
    """The MoE expert stacks of a cell's rank: its layout, the bytes it
    holds, the formula's (``sharding.ExpertLayout.nbytes`` of each stack's
    layers: a dense stack's share) and the whole pool's; None without
    experts."""
    layouts = collectives.expert_layouts(whole, mesh, expert_mode)
    if not layouts:
        return None
    formula = 0
    for path, leaf in tree_leaves(whole):
        if path in layouts:
            stack = leaf.shape[0] if isinstance(leaf, torch.Tensor) \
                else leaf.ct.streams.mask.shape[0]
            formula += layouts[path].nbytes(int(stack)) // 3
    held = collectives.expert_census(placed, mesh, expert_mode)
    return {"layout": held["layout"], "bytes": held["bytes"],
            "formula_bytes": formula,
            "whole_bytes": collectives.expert_census(whole)["bytes"]}


def meta_tree(tree):
    """A serving tree a run built (handles, tensors) with every tensor
    replaced by a ``meta`` tensor of its shape and dtype: the dry-run of
    exactly that tree (its compressed leaves, escapes and decoder
    buckets)."""
    def meta(a):
        return None if a is None else torch.empty_like(a, device="meta")

    def one(_, leaf):
        if is_handle(leaf):
            ct = getattr(leaf, "ct", None)
            if isinstance(ct, CompressedTensor) and ct.streams is not None:
                return dataclasses.replace(leaf, ct=dataclasses.replace(
                    ct, streams=ct.streams.map(meta)))
            if isinstance(leaf, DenseWeight):
                return DenseWeight(w=meta(leaf.w))
            return leaf
        return meta(leaf)

    return tree_map_with_path(one, tree)


def serving_params(cfg, mode: str, mesh, tree=None,
                   expert_mode: str = "serve"):
    """``(whole, placed)``: the abstract serving tree of ``mode`` (the
    ``min_bytes`` and shards of the reference's streamed variant: 1 MiB,
    16), or :func:`meta_tree` of ``tree``, and that tree placed for rank 0
    (MoE expert stacks under ``expert_mode``); a stream tree's prefetch
    layout made once, as ``launch/serve.py`` makes it at set-up."""
    whole = (meta_tree(tree) if tree is not None else
             streaming.abstract_serving_params(cfg, TABLE_IV, mode=mode))
    params = place_abstract(whole, mesh, expert_mode=expert_mode)
    if not cfg.is_encdec:
        n_periods = _periods(cfg)
        if overlap_enabled(cfg.overlap, params["period"], n_periods):
            build_schedule(params["period"], n_periods)
    return whole, params


def _program(cfg, shape, mesh, mode, tree, expert_mode: str = "serve"):
    """``(inputs, run, line, experts)``: the rank's inputs, the function
    that runs its program on them, one line saying what it is and its
    :func:`expert_record`."""
    model = build_model(cfg)
    specs = input_specs(cfg, shape)
    dims = "x".join(map(str, mesh.shape.values()))
    if shape.kind == "train":
        whole = abstract_params(cfg)
        pspecs = elastic.train_pspecs(whole, mesh)
        params = elastic.abstract_shards(whole, mesh, pspecs["params"])
        opt = adamw.init(params)
        step = build_train_step(model, adamw.AdamWConfig(), mesh)
        rows = sharding.local_shard(
            specs["tokens"], sharding.batch_pspecs(
                specs, mesh, shape.global_batch)["tokens"], mesh).shape[0]
        ba = sharding.batch_axis(mesh, shape.global_batch)
        line = (f"train step on mesh {dims} rank {mesh.rank}: params and "
                f"AdamW moments sharded (train_pspecs; replicated across "
                f"pod), dense gather, forward + backward on {rows} of "
                f"{shape.global_batch} rows x {shape.seq_len} (batch on "
                f"{ba}), rank-ordered gradient sum over {ba}, AdamW on the "
                f"shards")
        return ((params, opt, specs), lambda: step(params, opt, specs), line,
                None)
    whole, params = serving_params(cfg, mode, mesh, tree, expert_mode)
    experts = expert_record(whole, params, mesh, expert_mode)
    del whole
    b = shape.global_batch
    layouts = serving_layouts(
        cfg, mesh, shape.seq_len, b,
        specs["frames"].shape[1] if "frames" in specs else None)
    layout = layouts["layout"]
    ba = sharding.batch_axis(mesh, b)
    rows = sharding.local_shard(specs["tokens"], (ba,), mesh).shape[0]
    if shape.kind == "prefill":
        step = build_prefill_step(model, max_len=shape.seq_len, mesh=mesh,
                                  expert_mode=expert_mode)
        batch = {k: v for k, v in specs.items()}
        run = lambda: step(params, batch)  # noqa: E731
        what = (f"prefill of {rows} of {b} rows x {shape.seq_len} tokens "
                f"(batch on {ba})")
        inputs = (params, batch)
    else:
        step = build_decode_step(model, mesh=mesh, expert_mode=expert_mode)
        cache = rank_cache(specs["cache"], mesh, b, layout)
        run = lambda: step(params, cache, specs["tokens"])  # noqa: E731
        what = (f"decode step of {rows} of {b} sequences (batch on {ba}) "
                f"over a cache of {shape.seq_len}")
        inputs = (params, {"cache": cache, "tokens": specs["tokens"]})
    route = ""
    if layout.sharded and shape.kind == "decode":
        route = (", flash-decoding: stats and per-chunk partials gathered"
                 if cfg.decode_score_shard else ", scores gathered")
    ep = ""
    if experts is not None:
        ep = (f"; MoE experts: {experts['layout']}, activations exchanged, "
              f"none gathered")
        if expert_mode == "serve_ep":
            ep += (" (serve_ep places what serve places in the port: no "
                   "contracting dim is split, docs/PORT.md convention 11)")
    held = ""
    if "state" in layouts:
        state = layouts["state"]
        held += (f"; {state.kind} states {state.describe()}, "
                 f"{state.gathered} gathered a step")
    if "memory" in layouts:
        mem = layouts["memory"]
        held += f"; encoder memory {mem.describe()}"
        if mem.sharded and shape.kind == "decode":
            held += (", cross attention's stats and per-chunk partials "
                     "gathered" if cfg.decode_score_shard else
                     ", cross attention's scores gathered")
    line = (f"{what}, {mode} weights, on serving mesh {dims} rank "
            f"{mesh.rank}: own stream shards, gathered at use; the dense "
            f"math whole over the rank's rows; K/V ring "
            f"{layout.describe()}{route}{held}{ep}")
    return inputs, run, line, experts


def rank_cache(cache, mesh, b: int, layout):
    """The rank's block of a whole (``meta``) decode cache of ``b`` rows
    under ``sharding.port_cache_pspecs``, as new ``meta`` tensors of the
    block's shapes, with ``layout`` as its ``kv_layout`` and, read from
    its leaves, its Mamba and sLSTM states' ``state_layout`` and its
    encoder memory's ``mem_layout``."""
    specs = dict(sharding.spec_leaves(sharding.port_cache_pspecs(
        cache, mesh, b, layout)))
    local = tree_map_with_path(lambda p, t: _meta_like(
        t, sharding.local_shard(t, specs[p], mesh).shape), cache)
    local["kv_layout"] = layout
    entries = cache.get("entries", ())
    mamba = [e["h"] for e in entries if "conv" in e]
    slstm = [e["h"] for e in entries if "h" in e and "conv" not in e]
    if mamba or slstm:
        d_inner, d_state = mamba[0].shape[-2:] if mamba else (0, 0)
        local["state_layout"] = sharding.state_layout(
            mesh, d_inner, d_state, batch=b,
            d_slstm=slstm[0].shape[-1] if slstm else 0)
    if "mem_k" in cache:
        local["mem_layout"] = sharding.memory_layout(
            mesh, cache["mem_k"].shape[2], batch=b)
    return local


def lower_cell(cfg, shape: ShapeSpec, mesh, *, variant: str = "baseline",
               mode=None, tree=None) -> dict:
    """Run one cell's program for ``mesh``'s rank on ``meta`` tensors;
    returns its record: ``cost``, ``memory``, ``collectives``,
    ``kernels``, ``program``, ``lower_s``.  ``mode``: the serving weight
    mode (default: the variant's, dense for the baseline); ``tree``: a
    serving tree a run built, served instead of the abstract one (its
    :func:`meta_tree`)."""
    mode = mode or VARIANT_MODE.get(variant, "dense")
    t0 = time.time()
    kernel_cost.reset()
    mesh.records.clear()
    inputs, run, line, experts = _program(
        cfg, shape, mesh, mode, tree, expert_mode_of(variant, shape.kind))
    # a codec of its own: the dry-run's gathers count on no one's ledger
    with use_codec(Codec()), collectives.use_serving_mesh(mesh), \
            torch.no_grad(), CostMode(tensors_bytes(*inputs)) as counter:
        out = run()
        del out
    kernels = kernel_cost.snapshot()
    rec = {"lower_s": round(time.time() - t0, 2), "program": line,
           "cost": {
               "flops": float(counter.flops + sum(
                   k["flops"] for k in kernels.values())),
               "bytes accessed": float(counter.bytes + sum(
                   k["bytes"] for k in kernels.values())),
               "elementwise flops": float(counter.elementwise)},
           "memory": {"peak_memory_in_bytes": counter.peak,
                      "argument_size_in_bytes": tensors_bytes(*inputs)},
           "collectives": collective_stats.collective_stats(mesh.records),
           "kernels": kernels, "ops": counter.ops}
    if experts is not None:
        rec["experts"] = experts
    return rec


def run_cell(arch: str, shape_name: str, outdir: Path, multi_pod_modes,
             variant: str = "baseline", mesh_shape=None, cfg=None,
             shape: ShapeSpec = None, mode=None, write: bool = True) -> dict:
    """One cell's record on each mesh of ``multi_pod_modes`` ("single",
    "multi"), written to ``outdir/<arch>__<shape>[__variant][__meshAxB]
    .json``.  ``cfg`` / ``shape`` override the arch's config and the named
    shape (smoke configs, a cut shape)."""
    cfg = cfg or get_config(arch)
    if VARIANT_TWEAKS.get(variant):
        cfg = dataclasses.replace(cfg, **VARIANT_TWEAKS[variant])
    shape = shape or SHAPES[shape_name]
    # every train cell rematerialised, as the reference's dry-run runs it
    cfg = dataclasses.replace(cfg, remat=(shape.kind == "train"))
    ok, reason = shape_applicable(cfg, shape_name)
    record = {"arch": arch, "shape": shape_name,
              "params": param_count(cfg),
              "active_params": active_param_count(cfg),
              "n_periods": _periods(cfg)}
    suffix = shape_name if variant == "baseline" \
        else f"{shape_name}__{variant}"
    if mesh_shape is not None:
        suffix += "__mesh" + "x".join(map(str, mesh_shape))
    skip = reason if not ok else variant_skip(variant, shape.kind)
    if skip:
        record.update(status="skipped", reason=skip, variant=variant)
        if write:
            _write(outdir, arch, suffix if ok else shape_name, record)
        print(f"[dryrun] {arch} x {shape_name} ({variant}): {skip}")
        return record
    # every layer runs eagerly: nothing is counted once (module docstring)
    record["layers_mode"] = "unroll"
    record["variant"] = variant
    for mesh_name in multi_pod_modes:
        mesh = production_mesh(mesh_name == "multi", mesh_shape)
        entry = {}
        try:
            rec = lower_cell(cfg, shape, mesh, variant=variant, mode=mode)
            entry["full"] = rec
            entry["status"] = "ok"
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
                  f"{rec['lower_s']}s flops={rec['cost']['flops']:.3e} "
                  f"bytes={rec['cost']['bytes accessed']:.3e} peak="
                  f"{rec['memory']['peak_memory_in_bytes'] / 2**30:.2f} GiB "
                  f"wire={rec['collectives']['total_wire_bytes']:.3e}")
        except Exception as e:  # noqa: BLE001 — record the failure verbatim
            entry["status"] = "failed"
            entry["error"] = f"{type(e).__name__}: {e}"
            entry["traceback"] = traceback.format_exc()[-4000:]
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name} FAILED: "
                  f"{entry['error']}")
        record[mesh_name] = entry
    statuses = [record[m]["status"] for m in multi_pod_modes]
    record["status"] = ("failed" if "failed" in statuses or "ok" not in
                        statuses else "ok")
    if write:
        _write(outdir, arch, suffix, record)
    return record


def _write(outdir: Path, arch: str, shape_name: str, record: dict):
    outdir.mkdir(parents=True, exist_ok=True)
    path = outdir / f"{arch}__{shape_name}.json"
    existing = {}
    if path.exists():
        try:
            existing = json.loads(path.read_text())
        except Exception:  # noqa: BLE001 — a damaged record is rewritten
            existing = {}
    existing.update(record)
    path.write_text(json.dumps(existing, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--variant", default="baseline",
                    choices=tuple(VARIANT_TWEAKS))
    ap.add_argument("--mesh-shape", default=None,
                    help="override the single-pod mesh, e.g. 4x64 (DxM) "
                         "or 2x4x4 (PxDxM, a pod mesh)")
    ap.add_argument("--single-only", action="store_true")
    ap.add_argument("--multi-only", action="store_true")
    args = ap.parse_args(argv)

    modes = ["single", "multi"]
    if args.single_only:
        modes = ["single"]
    if args.multi_only:
        modes = ["multi"]
    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    mesh_shape = None
    if args.mesh_shape:
        mesh_shape = tuple(int(v) for v in args.mesh_shape.split("x"))
    failures = 0
    t0 = time.time()
    for arch in archs:
        for shape_name in shapes:
            rec = run_cell(arch, shape_name, Path(args.out), modes,
                           variant=args.variant, mesh_shape=mesh_shape)
            failures += rec.get("status") == "failed"
    print(f"[dryrun] done in {time.time() - t0:.1f}s; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
