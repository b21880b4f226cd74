"""Serving launcher of the PyTorch port (counterpart of
``repro/launch/serve.py``): seeded synthetic weights, compressed on the
device under the chosen weight-execution mode (or restored from an ENEC
checkpoint), then served through the continuous-batching engine
(``runtime/engine.py``).

Modes (runtime/streaming.py):
  dense   raw weights, canonical tiled matmul (dense-tile kernel entry)
  stream  ENEC streams decoded layer by layer inside the step (ENEC
          decode kernel, then the dense-tile entry)
  fused   ENEC tile streams decoded inside the matmul kernel (default)
All three give bitwise-equal logits on one device (``--dense``, the
reference's deprecated alias, is ``--mode dense``).  Compression runs
through the codec's encode plans: the ENEC encode kernel on the card.

Serving: ``--batch N`` submits N requests at once into the engine's
bounded admission queue (``--queue-depth``); they join a
``--concurrency``-slot KV ring (default N), each prefilled alone, and
decode together, one step per token, the slot prefix of each step a power
of two.  On the card each such bucket's step is a CUDA graph, captured on
its first use and replayed after (``runtime/captured.py``).
``--deadline-ms`` gives each request a total deadline: expired work is
shed before its prefill or evicted at a step.

MoE expert streaming: ``--expert-cache-mb MB`` (MoE archs) keeps every
expert as a per-expert compressed record in host memory
(``runtime/experts.py``) and decodes the experts each step routes to on
the device, through an LRU cache of that many MB (0 keeps nothing past a
step); logits are bitwise equal to serving the dense stacks.  A step that
fetches experts brings the routed ids to the host mid-step, so with a
store every decode step runs eagerly, also on the card.

Overlap: ``--overlap {off,on,auto}`` (default auto, as the reference)
sets ``cfg.overlap``: with streamed weights in the layer loop (stream mode,
and MoE expert stacks in fused mode) each layer's weights are decoded by
one batched decode issued a layer ahead, on a side stream on the card
(``runtime/overlap.py``; a stack of one period runs serially); logits are
bitwise equal either way.

Checkpoints: ``--save-ckpt DIR`` writes an enec-v2 checkpoint of the
compressed weights (in the serving layout of the mode; with a store, the
experts as per-expert records) and serves;
``--ckpt DIR`` restores through ``CheckpointManager.load_for_serving``:
the records become weight handles on the device, only compressed bytes
cross host to device, and no weight is initialised.  The restore runs
under ``policy="degraded"``, which collects every quarantined record and
its fallback from an earlier step (a ``RestoreReport``); by default
(``--degraded``) the server then serves with health ``degraded``, and
under ``--strict`` it prints the report and exits 1 with health
``failed``.  :data:`HEALTH` is the process's readiness state
(``restoring`` -> ``ready`` | ``degraded`` | ``failed``; the engine drives
it after that).

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --save-ckpt /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --ckpt /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --arch phi3_5_moe_42b_a6_6b --expert-cache-mb 0
    PYTHONPATH=src python -m repro_torch.launch.serve --batch 4 \\
        --prompt-len 64 --tokens 16          # full width, on the GPU

Serving mesh: ``--tp A`` (or ``--mesh``, the widest model axis the world
divides by) serves on a ``(data, model)`` mesh of the ranks that ``python
-m torch.distributed.run`` starts (``launch/mesh.py``; gloo on the CPU and
when ranks share a card, NCCL with a card each).  Each rank holds only its
own shard rows of every sharded stream (``--shards`` defaults to the model
axis's width, else 2) and gathers the other ranks' rows as compressed bytes
when a layer uses them (``runtime/collectives.py``; the ``d2d_allgather``
link of the ledger); the dense math runs on every rank, so every rank
serves every request and its logits equal a single-device run's bit for
bit.  The step runs eagerly under a mesh.  Only rank 0 prints.
Each rank holds its share of the K/V ring's sequence where
``runtime/sharding.py:kv_layout`` allows it (a rank's slice a whole number
of 1024-position chunks: ``(--prompt-len + --tokens) % (A x 1024) ==
0``), else the whole ring; the mesh line says which.  A sharded ring's
decode attention gathers the scores over the model axis, or, with the
config's ``decode_score_shard`` (flash-decoding), only the softmax's
stats and partials; logits stay one device's bits either way.  A
hybrid arch's Mamba states hold the rank's blocks of ``h``'s d_state and
``conv``'s channels where they divide by the model axis
(``runtime/sharding.py:state_layout``); each step gathers the conv output
and the read-out's products, and the mesh line says which blocks a rank
holds.  An xLSTM arch's sLSTM ``h`` holds the rank's block of D where it
divides by the model axis (``c`` / ``n`` / ``m`` and the mLSTM states
whole); each step gathers the bf16 ``h`` before ``r_in``, and the mesh
line says which block a rank holds and the bytes a step gathers.  An MoE
arch's expert stacks are placed by ``runtime/sharding.py:expert_layout``:
each rank holds, decodes and multiplies only its own experts (E on the
model axis where it divides; a dense stack also splits each expert
matrix's output columns over the data axis), nothing of them is gathered,
and the MoE block exchanges activations instead (``models/moe.py``); the
experts line says what each rank holds.
``--expert-cache-mb`` stays refused on a mesh, as the reference refuses
it.  ``--ckpt`` restores onto the mesh, each rank uploading only its
shards' bytes (a compressed expert stack's: its own experts'); a dense
record uploads whole and is cut.  ``--save-ckpt`` saves the whole tree
from rank 0 before placing it.

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.serve --smoke --device cpu --tp 4

One :class:`~repro_torch.core.codec_api.Codec` owns the run: it is ambient
for the whole of ``main`` (``use_codec``), so the encode plans, the
checkpoint manager, the h2d ledger and every handle's decode count on it.
``main`` returns the run's tokens (batch, tokens) and logits (tokens,
batch, vocab) when every request completed, TTFT (mean over requests,
queueing included), TPOT (mean host time of the steps that replayed a
graph, after their tokens reached the host; the capturing steps are
reported apart), the device ms of a replay, tok/s, kernel launch counts
(the run, the prefills, each decode step), the engine's stats and the
set-up, save and restore figures, so a calling script can compare runs.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import CheckpointError, CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.codec_api import Codec, use_codec
from repro_torch.kernels import decode_attention_kv, enec_decode, enec_encode
from repro_torch.kernels.decompress_matmul import (DENSE_LAUNCHES,
                                                  FUSED_LAUNCHES)
from repro_torch.kernels.idd_scan import LAUNCHES as IDD_SCAN_LAUNCHES
from repro_torch.launch.mesh import make_host_mesh, world_size
from repro_torch.models import build_model, lm
from repro_torch.models.lm import abstract_params
from repro_torch.runtime.collectives import (expert_census,
                                             place_serving_tree,
                                             tree_gather_nbytes,
                                             use_serving_mesh)
from repro_torch.runtime.engine import Engine, EngineConfig, ServerHealth
from repro_torch.runtime.experts import ExpertStore, install_expert_store
from repro_torch.runtime.overlap import (OVERLAP_MODES, build_schedule,
                                         overlap_enabled)
from repro_torch.runtime.sharding import kv_layout
from repro_torch.runtime.streaming import (assign_weight_modes, mode_mix,
                                           stream_stats, tree_leaves)
from repro_torch.runtime.weights import FusedWeight, StreamedWeight

# every kernel of the package, whether or not serving launches it
COUNTERS = {"enec_decode": enec_decode.LAUNCHES,
            "decompress_matmul": FUSED_LAUNCHES,
            "dense_tile_matmul": DENSE_LAUNCHES,
            "enec_encode": enec_encode.LAUNCHES,
            "idd_scan": IDD_SCAN_LAUNCHES,
            "decode_attention_kv": decode_attention_kv.LAUNCHES}


# readiness of this serving process, the answer to a load balancer's probe
HEALTH = ServerHealth()


def launch_counts() -> dict:
    return {name: c.n for name, c in COUNTERS.items()}


def _since(base: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - base[k] for k in now}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


def wire_ratio(tree) -> float:
    """Raw over compressed (framed wire) bytes of the compressed leaves."""
    raw = wire = 0
    for _, leaf in tree_leaves(tree):
        if isinstance(leaf, (StreamedWeight, FusedWeight)):
            n_layers = leaf.ct.streams.mask.shape[0]
            raw += n_layers * leaf.ct.nbytes_raw()
            wire += leaf.ct.nbytes_wire()
    return raw / wire if wire else 1.0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3_2_1b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--mode", default=None,
                    choices=("dense", "stream", "fused"),
                    help="weight-execution mode (default fused)")
    ap.add_argument("--dense", action="store_true",
                    help="deprecated alias for --mode dense")
    ap.add_argument("--min-bytes", type=int, default=4096,
                    help="smallest leaf worth compressing")
    ap.add_argument("--shards", type=int, default=None,
                    help="TP shard count of the stream block dim (default: "
                         "the serving mesh's model-axis width under "
                         "--tp / --mesh, else 2)")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis width of the serving mesh: stream "
                         "shards are spread over this axis and gathered as "
                         "compressed bytes when used; must divide the "
                         "world size; 1 = one device")
    ap.add_argument("--mesh", action="store_true",
                    help="a (data, model) serving mesh with the widest "
                         "model axis the world size divides by (--tp "
                         "<largest divisor>)")
    ap.add_argument("--batch", type=int, default=4,
                    help="requests submitted at once")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=8,
                    help="new tokens per request (1 from the prefill)")
    ap.add_argument("--concurrency", type=int, default=0,
                    help="KV slots of the engine (default: --batch)")
    ap.add_argument("--queue-depth", type=int, default=16,
                    help="admission queue depth (at least --batch)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="total deadline per request (0: none)")
    ap.add_argument("--expert-cache-mb", type=float, default=None,
                    metavar="MB",
                    help="MoE expert streaming: keep expert stacks as "
                         "per-expert compressed records and decode routed "
                         "experts through a byte-budgeted LRU cache of this "
                         "many MB (0 caches nothing; only MoE arches have "
                         "eligible leaves)")
    ap.add_argument("--overlap", default="auto", choices=OVERLAP_MODES,
                    help="decode-prefetch pipeline for streamed weights: "
                         "decode layer l+1 while layer l computes; auto "
                         "enables it whenever streamed leaves are present; "
                         "logits are bitwise equal either way")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="weight seed")
    ck = ap.add_mutually_exclusive_group()
    ck.add_argument("--ckpt", default=None, metavar="DIR",
                    help="restore the weights from an ENEC checkpoint "
                         "instead of initialising them")
    ck.add_argument("--save-ckpt", default=None, metavar="DIR",
                    help="write an enec-v2 checkpoint of the compressed "
                         "weights (the mode's serving layout), then serve")
    pol = ap.add_mutually_exclusive_group()
    pol.add_argument("--strict", action="store_true",
                     help="refuse a damaged restore: print the quarantine "
                          "list and exit 1 instead of serving fallbacks")
    pol.add_argument("--degraded", action="store_true",
                     help="serve through damage with per-record fallbacks "
                          "from earlier steps and print the RestoreReport "
                          "(default)")
    args = ap.parse_args(argv)
    if args.dense and args.mode not in (None, "dense"):
        ap.error("--dense conflicts with --mode " + args.mode)
    if args.dense:
        print("[serve] --dense is a deprecated alias: use --mode dense")
    args.mode = "dense" if args.dense else (args.mode or "fused")
    return args


def _restore_params(args, cfg, mode, codec, dev, expert_store,
                    mesh=None) -> tuple:
    """--ckpt: the weights come from the checkpoint; the tree restored
    into is ``meta`` tensors, so nothing is initialised.  The restore runs
    under ``policy="degraded"``, so the whole quarantine list is collected
    in one pass; the caller decides between serving and exiting
    (``--strict``).  On a ``mesh`` each rank uploads its own shards only.
    Returns ``(params, info, report)``, ``report`` the
    :class:`~repro_torch.checkpoint.ckpt.RestoreReport`."""
    mgr = CheckpointManager(args.ckpt, codec=codec, device=dev)
    manifest = mgr.manifest()
    # a training checkpoint holds {"params": ..., "opt": ...}; a serving
    # checkpoint holds the params tree at the root
    prefix = ("params" if any(e["name"].startswith("params/")
                              for e in manifest["leaves"]) else "")
    like = abstract_params(cfg)
    codec.reset_transfer_stats()
    codec.reset_decode_cache_stats()
    t0 = time.perf_counter()
    params, _ = mgr.load_for_serving(like, mode=mode, prefix=prefix,
                                     min_bytes=args.min_bytes,
                                     shards=args.shards, policy="degraded",
                                     mesh=mesh, expert_store=expert_store)
    _sync(dev)
    h2d = codec.link_stats()["h2d"]
    report = mgr.last_restore_report
    info = {"seconds": time.perf_counter() - t0, "step": manifest["step"],
            "ratio": manifest["ratio"],
            "h2d_compressed_bytes": h2d["compressed_bytes"],
            "h2d_dense_bytes": h2d["dense_bytes"],
            "dense_records": list(mgr.last_dense_records),
            "record_h2d": dict(mgr.last_record_h2d),
            "placed_records": list(mgr.last_placed_records),
            "decode_dispatches": codec.decode_cache_stats()["dispatches"],
            "plan_buckets": len(mgr.last_decode_plan.buckets),
            "quarantined": [dataclasses.asdict(q)
                            for q in report.quarantined],
            "retry": report.retry}
    print(f"[serve] restored step {info['step']} from {args.ckpt} in "
          f"{info['seconds']:.2f}s (h2d "
          f"{info['h2d_compressed_bytes'] / 1e6:.1f} MB compressed, "
          f"{info['h2d_dense_bytes'] / 1e6:.1f} MB dense; ratio "
          f"{info['ratio']:.4f}x; {info['decode_dispatches']} decode "
          f"dispatches, {info['plan_buckets']} plan buckets; io retries "
          f"{report.retry.get('retries', 0)}/"
          f"{report.retry.get('attempts', 0)} attempts)")
    return params, info, report


def _save_params(args, params, mode, codec, dev, expert_records) -> dict:
    """--save-ckpt: the handle tree is saved as it is (its stream bundles
    become the records), so the weights are compressed once."""
    mgr = CheckpointManager(
        args.save_ckpt, serving_layout=None if mode == "dense" else mode,
        serving_min_bytes=args.min_bytes, serving_shards=args.shards,
        expert_records=expert_records, codec=codec, device=dev)
    t0 = time.perf_counter()
    mgr.save(0, {"params": params}, blocking=True)
    info = {"seconds": time.perf_counter() - t0}
    manifest = mgr.manifest(0)
    step_dir = Path(args.save_ckpt) / "step_000000000000"
    info.update(ratio=manifest["ratio"],
                bytes_on_disk=sum(f.stat().st_size
                                  for f in step_dir.iterdir()),
                records=len(manifest["leaves"]))
    print(f"[serve] saved {info['records']} records to {args.save_ckpt} in "
          f"{info['seconds']:.2f}s ({info['bytes_on_disk'] / 1e6:.1f} MB on "
          f"disk, ratio {info['ratio']:.4f}x)")
    return info


def _serving_mesh(args):
    """The ``(data, model)`` mesh of ``--tp`` / ``--mesh`` over the world
    the launcher started, or None for one device."""
    if args.tp <= 1 and not args.mesh:
        return None
    world = world_size()
    if args.tp > world:
        raise ValueError(
            f"--tp {args.tp} needs a world of {args.tp} ranks and this one "
            f"has {world}: start the ranks with python -m "
            f"torch.distributed.run --nproc-per-node {args.tp} -m "
            f"repro_torch.launch.serve ... --tp {args.tp}")
    if args.expert_cache_mb is not None:
        raise ValueError("--expert-cache-mb does not compose with --tp / "
                         "--mesh yet: the expert store fetches the routed "
                         "experts on one device each step")
    return make_host_mesh(model="max" if args.mesh and args.tp <= 1
                          else args.tp, device=args.device)


def main(argv=None) -> dict:
    args = parse_args(argv)
    HEALTH.reset()      # back-to-back runs in one process start afresh
    dev = resolve_device(args.device)
    mesh = _serving_mesh(args)
    if mesh is not None:
        dev = mesh.device
    if args.shards is None:
        # the stream shards land one set per rank of the model axis
        args.shards = mesh.shape["model"] if mesh is not None else 2
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if cfg.is_encdec:
        # the engine prefills tokens only, as the reference's does
        raise ValueError(
            f"{args.arch} is an encoder-decoder: the serving engine cannot "
            f"prefill its frames.  Serve it through "
            f"repro_torch.models.registry.build_model(cfg): prefill_fn("
            f"params, {{'frames', 'tokens'}}, max_len), then decode_fn (or "
            f"decode_step on init_step_state's buffers)")
    cfg = dataclasses.replace(cfg, overlap=args.overlap)
    codec = Codec()     # owns this run's encodes, decodes and ledger
    # every rank serves every request; rank 0 speaks for them
    quiet = mesh is not None and mesh.rank != 0
    with use_codec(codec), (contextlib.redirect_stdout(io.StringIO())
                            if quiet else contextlib.nullcontext()):
        return _serve(args, cfg, build_model(cfg), codec, dev, mesh)


def _link_line(codec) -> str:
    """The run's ledger: compressed / dense MB over every link that moved
    bytes (a sharded serve moves no dense byte between ranks)."""
    parts = [f"{k}:{v['compressed_bytes'] / 1e6:.1f}/"
             f"{v['dense_bytes'] / 1e6:.1f}MB"
             for k, v in codec.link_stats().items() if v["ops"]]
    return "[serve] serve links (compressed/dense): " + (
        " ".join(parts) or "none")


def _serve(args, cfg, model, codec, dev, mesh=None) -> dict:
    t0 = time.perf_counter()
    restore = save = None
    # 0 MB is a legal budget: every routed expert misses and is dropped
    # after its step
    store = (None if args.expert_cache_mb is None else
             ExpertStore(budget_bytes=int(args.expert_cache_mb * 2**20),
                         codec=codec, device=dev))
    policy = "strict" if args.strict else "degraded"
    if args.ckpt:
        HEALTH.transition("restoring")
        try:
            params, restore, report = _restore_params(
                args, cfg, args.mode, codec, dev, store, mesh)
        except (CheckpointError, FileNotFoundError) as e:
            HEALTH.transition("failed", str(e))
            print(f"[serve] restore FAILED: {e}")
            raise SystemExit(1)
        if report.degraded:
            print("[serve]", report.summary())
            if policy == "strict":
                HEALTH.transition(
                    "failed", f"{len(report.quarantined)} quarantined "
                              f"record(s) under --strict")
                print(f"[serve] --strict: refusing to serve with "
                      f"{len(report.quarantined)} quarantined record(s); "
                      f"exiting 1")
                raise SystemExit(1)
            HEALTH.transition(
                "degraded",
                f"{len(report.quarantined)} record(s) on fallback")
        else:
            HEALTH.transition("ready")
    else:
        params = model.init(seed=args.seed, device=dev)
        if store is not None:
            # BEFORE assign_weight_modes: the expert stacks become
            # ExpertRef handles, which the mode assignment passes through
            params, _ = install_expert_store(params, store=store,
                                             min_bytes=args.min_bytes)
        params = assign_weight_modes(params, mode=args.mode,
                                     min_bytes=args.min_bytes,
                                     shards=args.shards, codec=codec)
        HEALTH.transition("ready")
    _sync(dev)
    setup_s = time.perf_counter() - t0
    encode = codec.encode_cache_stats()
    if args.save_ckpt and (mesh is None or mesh.rank == 0):
        save = _save_params(args, params, args.mode, codec, dev,
                            store is not None)
    if mesh is not None:
        if args.save_ckpt:
            dist.barrier()      # the checkpoint is whole for every rank
        # each rank keeps its own shard rows (a restore placed them) and
        # its share of the MoE expert stacks
        params = place_serving_tree(params, mesh)
    # what this rank holds of the MoE expert stacks (None without them,
    # and with an expert store)
    placement = expert_census(params, mesh)
    resident = (torch.cuda.memory_allocated(dev) if dev.type == "cuda"
                else None)
    ratio = wire_ratio(params)
    stats = stream_stats(params)
    n_periods = cfg.n_layers // len(params["period"])
    overlap = {"mode": args.overlap, "enabled": overlap_enabled(
        args.overlap, params["period"], n_periods)}
    if overlap["enabled"]:
        schedule = build_schedule(params["period"], n_periods)
        overlap.update(slots=len(schedule.slots),
                       buckets_per_layer=schedule.buckets_per_layer)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    gather_nbytes = 0
    max_len = args.prompt_len + args.tokens
    layout = state = None
    if mesh is not None:
        gather_nbytes = tree_gather_nbytes(params, mesh)
        layout = kv_layout(mesh, max_len, pin=cfg.decode_score_shard)
        state = lm.state_layout(cfg, mesh)
        route = ("flash-decoding: stats and partials gathered"
                 if cfg.decode_score_shard else "scores gathered")
        print(f"[serve] serving mesh {mesh.shape} ({mesh.size} ranks, "
              f"backend {dist.get_backend() if mesh.size > 1 else None}): "
              f"--shards {args.shards}, {gather_nbytes / 1e6:.2f} MB of "
              f"sharded streams gathered a use of every leaf; KV ring of "
              f"{max_len} {layout.describe()}"
              + (f", {route}" if layout.sharded else "")
              + ("" if state is None else
                 f"; {state.kind} states {state.describe()}, "
                 f"{lm.state_gather_bytes(cfg, state, args.batch)} B of "
                 f"{state.gathered} gathered a step at {args.batch} rows"))
        if placement is not None:
            print(f"[serve] experts on the mesh: {placement['layout']}; "
                  f"{placement['bytes'] / 1e6:.2f} MB held on this rank, "
                  f"{placement['placed']} stacks gathered at use (the "
                  f"compressed stacks' {placement['stream_nbytes'] / 1e6:.2f}"
                  f" MB of streams were gathered (A - 1) times a use "
                  f"before)")
    print(f"[serve] arch={cfg.name} mode={args.mode} device={name} "
          f"setup={setup_s:.2f}s encode_buckets="
          f"{encode['planned_buckets']} mode_mix={mode_mix(params)}")
    print(f"[serve] health={HEALTH.state} ready={HEALTH.ready()} "
          f"policy={policy}")
    print(f"[serve] mode={args.mode} overlap={args.overlap} "
          f"prefetch={overlap} stream_stats={stats} "
          f"wire_ratio={ratio:.4f}")

    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen)
    ecfg = EngineConfig(
        max_slots=max(1, args.concurrency or args.batch),
        queue_depth=max(args.queue_depth, args.batch),
        max_prompt_len=args.prompt_len, max_new_tokens=args.tokens,
        default_deadline_s=(args.deadline_ms / 1e3 if args.deadline_ms
                            else None),
        collect_logits=True)
    engine = Engine(model, params, ecfg, codec=codec, device=dev,
                    expert_store=store, health=HEALTH,
                    extra_context=None if mesh is None
                    else lambda: use_serving_mesh(mesh))

    base = launch_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(prompts[i].numpy(), args.tokens, name=f"seq{i}")
            for i in range(args.batch)]
    engine.run_until_idle()
    wall = time.perf_counter() - t0
    launches = _since(base)
    ring_bytes = engine.ring_bytes()
    state_bytes = engine.state_bytes()
    state_leaf_bytes = engine.state_leaf_bytes()
    health = HEALTH.state        # while serving, before the drain
    engine.shutdown(deadline_s=30.0)

    finished = [r for r in reqs if r.state in ("done", "timed_out")]
    ttfts = [r.ttft_s() for r in finished]
    ttft = sum(ttfts) / len(ttfts) if ttfts else 0.0
    # TPOT: the steps that replayed a graph (on the CPU, the steps after
    # each bucket's first); the steps that captured are reported apart
    steady = [t for t, c in zip(engine.step_times_s, engine.step_captured)
              if not c] or engine.step_times_s
    tpot = sum(steady) / len(steady) if steady else 0.0
    dev_ms = [m for m, c in zip(engine.step_device_ms,
                                engine.step_captured)
              if m is not None and not c]
    step_dev_ms = sum(dev_ms) / len(dev_ms) if dev_ms else None
    tok_s = sum(len(r.tokens) for r in finished) / wall
    st = engine.stats()
    est = st["engine"]
    device_ms = "n/a" if step_dev_ms is None else f"{step_dev_ms:.3f}ms"
    evicted = sum(est[f"evicted_{k}"] for k in ("deadline", "fault",
                                                "abort"))
    print(f"[serve] batch={args.batch} prompt={args.prompt_len} "
          f"tokens={args.tokens} slots={ecfg.max_slots} "
          f"TTFT={ttft * 1e3:.2f}ms TPOT={tpot * 1e3:.2f}ms "
          f"step_device={device_ms} tok/s={tok_s:.2f} mode={args.mode}")
    print(f"[serve] engine: steps={est['steps']} prefills={est['prefills']} "
          f"buckets={est['compiled_buckets']} done={est['done']} "
          f"timed_out={est['timed_out']} shed={est['shed']} "
          f"evicted={evicted} rejected={est['rejected']} "
          f"governor={engine.governor.state} health={engine.health.state}")
    experts = None
    if store is not None:
        experts = store.stats()
        dec_ms = (1e3 * sum(engine.step_decode_s)
                  / max(1, len(engine.step_decode_s)))
        budget = ("inf" if experts["budget_bytes"] is None
                  else f"{experts['budget_bytes'] / 1e6:.2f}MB")
        print(f"[serve] experts: hits={experts['hits']} "
              f"misses={experts['misses']} "
              f"evictions={experts['evictions']} "
              f"fetches={experts['fetches']} "
              f"buckets={experts['fetch_buckets']} "
              f"resident={experts['resident_bytes'] / 1e6:.2f}MB/{budget} "
              f"miss-decode={dec_ms:.2f}ms/step (every step eager)")
    print(f"[serve] launches={launches} prefill={engine.prefill_launches} "
          f"per_decode_step="
          f"{engine.step_launches[0] if engine.step_launches else {}}")
    print(_link_line(codec))
    if layout is not None:
        kv_step = engine.step_kv_bytes[0] if engine.step_kv_bytes else 0
        print(f"[serve] KV ring {ring_bytes / 1e6:.2f} MB on this rank; "
              f"recurrent states {state_bytes / 1e6:.2f} MB; the decode "
              f"attention and recurrent states gathered "
              f"{kv_step / 1e6:.3f} MB a step")
    if placement is not None and mesh is not None:
        ep_step = engine.step_ep_bytes[0] if engine.step_ep_bytes else 0
        print(f"[serve] MoE blocks exchanged {ep_step / 1e6:.4f} MB of "
              f"activations a step on this rank")
    complete = len(finished) == len(reqs) and all(
        len(r.tokens) == args.tokens for r in reqs)
    tokens = logits = None
    if complete:
        tokens = torch.tensor([r.tokens for r in reqs])
        logits = torch.stack([torch.stack([r.logits[t] for r in reqs])
                              for t in range(args.tokens)])
        print(f"[serve] seq0={tokens[0].tolist()}")
    return {"tokens": tokens, "logits": logits,
            "ttft_s": ttft, "tpot_s": tpot, "tok_s": tok_s,
            "step_device_ms": step_dev_ms, "setup_s": setup_s,
            "launches": launches,
            "prefill_launches": engine.prefill_launches,
            "step_launches": engine.step_launches,
            "warmup_launches": engine.captured.warmup_launches,
            "step_s": engine.step_times_s,
            "step_device_ms_all": engine.step_device_ms,
            "step_buckets": engine.step_buckets,
            "step_decode_s": engine.step_decode_s,
            "step_h2d_bytes": engine.step_h2d_bytes, "experts": experts,
            "step_gather_bytes": engine.step_gather_bytes,
            "step_kv_bytes": engine.step_kv_bytes,
            "step_ep_bytes": engine.step_ep_bytes,
            "expert_placement": placement,
            "ring_bytes": ring_bytes, "state_bytes": state_bytes,
            "kv_layout": None if layout is None else {
                "sharded": layout.sharded, "axes": list(layout.axes),
                "positions": layout.local_length, "offset": layout.offset,
                "why": layout.why},
            "state_layout": None if state is None else {
                "h_axis": state.h_axis, "conv_axis": state.conv_axis,
                "slstm_axis": state.slstm_axis,
                "state_block": list(state.state_block),
                "channel_block": list(state.channel_block),
                "slstm_block": list(state.slstm_block),
                "describe": state.describe()},
            "state_leaf_bytes": state_leaf_bytes,
            "gather_nbytes": gather_nbytes, "links": codec.link_stats(),
            "mesh": None if mesh is None else dict(mesh.shape),
            "rank": 0 if mesh is None else mesh.rank,
            "resident_bytes": resident,
            "capture_s": engine.captured.capture_s, "engine": st,
            "mode_mix": mode_mix(params),
            "stream_stats": stats, "wire_ratio": ratio,
            "overlap": overlap, "health": health,
            "encode_buckets": encode["planned_buckets"],
            "encode_dispatches": encode["dispatches"],
            "save": save, "restore": restore}


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
