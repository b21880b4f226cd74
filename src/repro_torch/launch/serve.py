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
All three give bitwise-equal logits on one device.  Compression runs
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
import dataclasses
import time
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import CheckpointError, CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.codec_api import Codec, use_codec
from repro_torch.kernels import decode_attention_kv, enec_decode, enec_encode
from repro_torch.kernels.decompress_matmul import (DENSE_LAUNCHES,
                                                  FUSED_LAUNCHES)
from repro_torch.kernels.idd_scan import LAUNCHES as IDD_SCAN_LAUNCHES
from repro_torch.models import build_model
from repro_torch.models.lm import abstract_params
from repro_torch.runtime.engine import Engine, EngineConfig, ServerHealth
from repro_torch.runtime.experts import ExpertStore, install_expert_store
from repro_torch.runtime.overlap import (OVERLAP_MODES, build_schedule,
                                         overlap_enabled)
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
    ap.add_argument("--mode", default="fused",
                    choices=("dense", "stream", "fused"))
    ap.add_argument("--min-bytes", type=int, default=4096,
                    help="smallest leaf worth compressing")
    ap.add_argument("--shards", type=int, default=2,
                    help="TP shard count of the stream block dim")
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
    return ap.parse_args(argv)


def _restore_params(args, cfg, mode, codec, dev, expert_store) -> tuple:
    """--ckpt: the weights come from the checkpoint; the tree restored
    into is ``meta`` tensors, so nothing is initialised.  The restore runs
    under ``policy="degraded"``, so the whole quarantine list is collected
    in one pass; the caller decides between serving and exiting
    (``--strict``).  Returns ``(params, info, report)``, ``report`` the
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
                                     expert_store=expert_store)
    _sync(dev)
    h2d = codec.link_stats()["h2d"]
    report = mgr.last_restore_report
    info = {"seconds": time.perf_counter() - t0, "step": manifest["step"],
            "ratio": manifest["ratio"],
            "h2d_compressed_bytes": h2d["compressed_bytes"],
            "h2d_dense_bytes": h2d["dense_bytes"],
            "dense_records": list(mgr.last_dense_records),
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


def main(argv=None) -> dict:
    args = parse_args(argv)
    HEALTH.reset()      # back-to-back runs in one process start afresh
    dev = resolve_device(args.device)
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
    with use_codec(codec):
        return _serve(args, cfg, build_model(cfg), codec, dev)


def _serve(args, cfg, model, codec, dev) -> dict:
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
                args, cfg, args.mode, codec, dev, store)
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
    if args.save_ckpt:
        save = _save_params(args, params, args.mode, codec, dev,
                            store is not None)
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
                    expert_store=store, health=HEALTH)

    base = launch_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(prompts[i].numpy(), args.tokens, name=f"seq{i}")
            for i in range(args.batch)]
    engine.run_until_idle()
    wall = time.perf_counter() - t0
    launches = _since(base)
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
            "capture_s": engine.captured.capture_s, "engine": st,
            "mode_mix": mode_mix(params),
            "stream_stats": stats, "wire_ratio": ratio,
            "overlap": overlap, "health": health,
            "encode_buckets": encode["planned_buckets"],
            "encode_dispatches": encode["dispatches"],
            "save": save, "restore": restore}


if __name__ == "__main__":
    main()
