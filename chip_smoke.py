#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and hold
its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits nonzero:

1. build   compile ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a into
           ``build/kernels/`` (one nvcc per source, all in parallel); print
           the build time and the card's name and power limit (nvidia-smi).
2. decode  the ENEC decode kernel against the plain decoder, bitwise:
           bf16 / fp16 / fp32, N in {2048, 16384}, the (m, n, L) grid,
           all / no anomalous groups, m == n, per-block (b, l) across the
           wrap boundary, each under its plan and under grids 1, 3 and
           2 x SMs, the generic branch for lanes-branch cases and the
           other unit size, streams off 16-byte alignment; then the
           decode of the full-width 128256x2048 embed under the same
           overrides, timed (with and without a spin kernel ahead of the
           window, each unit size and the generic branch) beside the plain
           version, its bound and a device copy_ of the same bytes; one
           llama layer's 7 stream-mode leaf decodes timed the same way;
           ptxas resources and the plan.
   encode  the ENEC encode kernel against the plain encoder, byte for byte
           in all five streams, on the same grid (per-block b across the
           wrap) under the same overrides and an unaligned input; each
           result decoded back to its input by the decode kernel; then the
           encode of the full-width embed, timed as the decode is; after
           phase 4, the fused set-up's own launches (the whole tree in one
           bucket, per-block b of every stack) re-planned, held against
           the plain encoder byte for byte and timed beside their bound
           and a device copy_.
3. matmul  both entries of the decode+matmul kernel at every leaf shape
           of llama3_2_1b and minitron_4b and M in {1, batch,
           batch*prompt}: the fused entry bitwise equal to the dense-tile
           entry on the decoded weight, row-major and transposed (the
           layout stream mode hands it); each row bitwise equal to the
           same row at M = 1 and M = batch (split-K at M <= 16, the serial
           walk above: the engine's contract); within a stated tolerance
           of the plain version and of torch.matmul; fp16 / fp32 / f32-x /
           ragged / m == n cases in both branches; the logits head on
           the full-width llama tied head (embed.T) with each row bitwise
           equal at M = 1, 2, batch, timed; timed at M = batch and
           M = batch*prompt (both layouts of the dense-tile entry), each
           with and without a spin kernel ahead of the window; the ptxas
           registers of the four kernel builds, each branch's grid,
           resident CTAs per SM and shared memory, and the host time a
           call of each entry and of torch.matmul.
4. serve   llama3_2_1b at full width from seeded synthetic weights,
           compressed on the card by the encode kernel, through
           ``launch.serve.main`` (the continuous-batching engine, each
           batch bucket's decode step a CUDA graph) in fused, stream and
           dense modes (4 requests, prompt 64, 16 new tokens): equal
           greedy tokens, bitwise-equal logits, the kernel launches of
           each decode step (a replay's, by its capture's count) and of
           each bucket's warm-up as read from the code, the run's
           launches exactly the prefills', steps' and warm-ups', encode
           launches equal to the set-up's encode buckets (stream mode
           prefetches by default: a layer's decode is one batched launch
           per bucket of its schedule); TPOT of the captured step and the
           device ms of a replay; plus a smoke-size model on the card
           against the plain CPU path.
5. ckpt    the fused run again through ``serve.main``, first with
           ``--save-ckpt DIR`` (an enec-v2 checkpoint in a temporary
           directory), then with ``--ckpt DIR``: the restored run's tokens
           and logits bitwise equal to phase 4's fused run, no leaf of at
           least ``--min-bytes`` moved host to device as dense bytes, and
           restore decode dispatches equal to the restore plan's buckets.
   degraded
           the ckpt phase's fused tree saved as steps 0 and 1, one byte of
           one record of step 1 flipped: ``serve.main --ckpt`` (degraded
           by default) quarantines exactly it, restores it from step 0 and
           serves logits bitwise equal to phase 4's fused run with health
           ``degraded``; a strict restore raises and ``--strict`` exits 1
           with health ``failed``; a decode fault injected through
           ``runtime/faults.py`` degrades the same way; every restored leaf
           of at least ``--min-bytes`` moves host to device compressed;
           then the flipped byte on a stream-layout checkpoint served in
           stream mode, kernel 1 decoding the fallback record every step.
   mesh    the serving mesh: ``serve.main --tp A`` on A ranks of ``python
           -m torch.distributed.run`` sharing this card (gloo), full-width
           llama3_2_1b, 2 requests x prompt 64 x 3 tokens, eager steps:
           A = 2 in stream mode with the prefetch on and off, fused mode
           and a restore of a ``--shards 2`` stream checkpoint; A = 4 in
           stream mode.  Every rank's logits bitwise equal to one
           device's (phase serve's runs, a ``--shards 4`` run and a
           single-device restore here), no dense byte gathered and a
           step's gathered bytes (A - 1) x the placed streams'
           ``stream_nbytes``, kernel 1 / 2 / 2' launches a step as one
           device's step and the code's, each rank's restore h2d of the
           placed records about 1/A of one device's, one llama leaf's
           ``shard_local_decode`` pieces together bitwise the whole
           decode, no rank compiling a kernel; the backend, card count,
           peak and resident GB a rank and TPOT logged.
   engine  ``runtime/engine.py`` on full-width llama3_2_1b in fused,
           stream and dense modes and on minitron_4b fused (4 requests x
           prompt 64 x 16 new tokens, 4 slots): (a) each request's logits
           bitwise equal to the request served alone by the eager
           one-shot loop (``one_shot_alone``); (b) llama only, a staggered
           join (request 0 alone two steps, then 1, then 2 and 3: buckets
           1, 2 and 4 captured and replayed), (a) for every request; (c)
           the bucket-4 replays bitwise equal to the eager bucket-4 loop
           (``eager_bucket_loop``); (d) each step's launches by the
           replay accounting equal one step's, read from the code and
           the prefetch schedule (``step_launches``); (e) the captured
           buckets within {1, 2, 4}; (f) TPOT of the eager loops and of
           the captured engine and the device ms a replay, in one run.
           First, inside a capture, kernel 3 and kernel 2's first arrival
           counters on a new stream must refuse.
   overlap the decode-prefetch pipeline (``runtime/overlap.py``, kernel 1
           on a side stream inside the captured step) on full-width
           llama3_2_1b and minitron_4b in stream mode through the engine,
           overlap off and on in one call: (a) logits bitwise equal off
           against on, captured (buckets 1, 2, 4) and eager, and to each
           request alone; (b) each replay's launches equal one step's read
           from the code and the schedule (a layer's prefetch:
           ``buckets_per_layer`` kernel-1 launches); (c) a profile of 5
           bucket-4 replays: device ms, busy share, kernel-1 ms, the
           concatenation's ms and the share of kernel 1 that overlaps
           other kernels; (d) TPOT, TTFT, peak GB; (e) ``stream_stats``.
   scan    the standalone prefix-sum kernel through ``ops.idd_scan``:
           bitwise equal to ``torch.cumsum`` and the plain version in both
           branches of its plan (one warp a row; the look-back scan across
           CTAs) on the shapes of tests/test_kernels.py, bool input, the
           llama embed's (16032, 1024) blocks x groups, (8, 2**20) long
           rows of full-range values and ragged last tiles, again after
           the timed runs; timed at the embed's and the long rows' shapes
           beside torch.cumsum, with the ptxas resources and the plans.
   kv_attention
           decode attention over an ENEC-compressed KV prefix through
           ``ops.compress_kv_prefix`` + ``ops.decode_attention_kv_enec``:
           the prefix byte-identical to the plain encoder (and decoded
           back losslessly), the kernel within the reference test's
           tolerance of its plain version and of dense attention on the
           decoded K/V, on that test's grid, an m == n case and two
           full-width shapes (B 8, S 32768, KV 8, grp 3 and 8), under the
           planner's split-KV grid and other partitions of the chunks;
           the full-width ones on at least one CTA an SM, bitwise equal
           across two calls, timed beside SDPA on the dense bf16 K/V,
           with the ptxas resources and the plans.
   serve_minitron
           minitron_4b at full width through ``launch.serve.main`` (the
           engine) in fused, stream and dense modes (4 requests, prompt
           64, 16 new tokens): equal greedy tokens, bitwise-equal logits,
           launches per decode step and per warm-up as read from the code
           (the untied head is a second flat stream beside the embed),
           encode launches equal to the set-up's buckets.
   moe     phi3_5_moe at published widths cut to 8 layers (``MOE_LAYERS``;
           the dense tree of 32 does not fit the card) through
           ``runtime/engine.py``: dense, stream and fused (each bucket's
           step a CUDA graph), then fused with an expert store at budgets
           0, one step's working set and unbounded (every step eager);
           checks (a)-(f) of :func:`phase_moe`; TTFT, TPOT, device ms a
           step, the store's hit rate, miss-decode ms and h2d GB a step,
           peak device memory beside MemAvailable; kernel 1 on a layer's
           routed experts, 2' on one expert (M = 4, 16) and 4 on an
           expert leaf, each against its plain version and its bound;
           kernel 2's fused entry on a layer's 4 attention leaves (M = 4)
           beside its plain version, its bound and torch.matmul.
   families
           the recurrent and prefix families through ``runtime/engine.py``
           from seeded synthetic weights at published widths, cut to 8
           layers (xlstm_125m, two periods; jamba_v0_1_52b, one period)
           and 9 (paligemma_3b), each in dense, stream and fused mode, 4 requests
           x prompt 64 x 16 new tokens submitted together and staggered
           (buckets 1, 2, 4 captured): checks (a)-(e) of
           :func:`phase_families` (logits bitwise across modes, to the
           eager step and to each request alone; launches a replay read
           from the code; xLSTM's state handoff; PaliGemma's prefill with
           256 prefix embeddings); kernel 2' at every distinct weight
           shape of the dense trees and the heads, fused kernel 2 at every
           fused leaf shape, each at M = 4 and 64 against its plain
           version, timed beside it, its bound and torch.matmul; the
           decode attention's rows independent of the batch at each
           family's heads, beside the einsum form it replaced; TTFT,
           TPOT, device ms a replay, busy share, peak GB and a profile of
           the replay by kernel.
   api     the quickstart flow of the tree-level codec API on the ten
           Table III weight sets: ``search_for_array``, ``compress_tree``
           (one encode launch per bucket), the wire round trip,
           ``decompress_tree`` bitwise, ``tree_ratio``; records and
           ratios equal to the plain CPU path's; compress and decompress
           GB/s (launch-bound at these sizes).
   train_mesh
           the training mesh after phase train: ``launch/train.py --mesh``
           on 2 ranks of ``python -m torch.distributed.run`` sharing this
           card (gloo), full-width llama3_2_1b at the launcher's defaults:
           (1, 2) for 3 steps saved at step 3, bitwise equal to phase
           train's 3-step run (losses, gradient norms, the digest of each
           rank's shards against that state cut the same way), then that
           checkpoint resumed on (2, 1) to step 6 within 1e-3 of phase
           train's losses, both ranks equal (its final save, which nothing
           reads, skipped);
           one step's gradient tree through ``compressed_allreduce``
           bitwise equal to the plain rank-ordered sum; launches of 2',
           4 and 1 equal to the code's and the codec's counts; seconds a
           step split into gather / compute / reduce, the bytes of each,
           the gradient ratio, peak and held GB a rank.
   remat   rematerialised training of full-width llama3_2_1b
           (:func:`phase_remat`).
   examples
           the five ``examples_torch/`` scripts with ``--device cuda`` in
           this process, each one's launches counted alone and its
           self-checks raising through (``train_lm`` for 3 steps, then
           resumed on the same directory to 12), ``quickstart.py`` in a
           subprocess printing the in-process lines; then full-width
           llama3_2_1b from ``compress_params_for_streaming`` at its
           defaults: encode launches the plan's buckets, 4 x 64 + 16
           greedy tokens eagerly with logits bitwise the dense tree's and
           launches the code's, ``materialize_weight_tree`` bitwise in one
           decode launch a bucket (:func:`phase_examples`).
   dryrun  the dry-run (``launch/dryrun.py``, on ``meta`` tensors) of
           llama3_2_1b's decode step at batch 4 over a cache of 128 on a
           1x1 mesh in dense, stream and fused mode against the same eager
           ``decode_fn`` step on the card: launches a kernel equal to the
           counters' deltas, kernel FLOPs equal to 2 M K N over the step's
           products, the predicted peak within 20 % of the measured one;
           the H100 roofline terms of the cell beside the measured step;
           the records of two 16x16 cells (llama3_2_1b x decode_32k,
           qwen3_moe_235b_a22b x train_4k), dry-run on the host's CPU in
           subprocesses started after phase 1.
6. a ``{"kernels": [...]}`` JSON line, then the card line and the last
   line ``{"ok": true, "device": {...}}``.  Each kernel's ``launches`` is
   its count in the run of its ``path`` (fused, the main path, for the
   decoder, the encoder, the fused entry and the dense-tile entry, which
   runs the logits head; ``scan`` and ``kv_attention`` for kernels 3 and
   5);
   ``launches_by_path`` gives its count in each run (the three llama
   modes, ``ckpt_save``, ``ckpt_restore``, ``degraded``,
   ``degraded_stream``, the five ``mesh_A*`` runs (rank 0's counts),
   ``engine_fused``, ``overlap_llama3_2_1b``,
   ``overlap_minitron_4b``, ``scan``,
   ``kv_attention``, the three ``minitron_*`` modes, the six ``moe_*``
   runs, the nine ``families_*`` runs, ``api``, the three ``whisper_*``
   modes, ``train``, the three ``train_mesh_*`` runs (rank 0's), the
   three ``remat_*`` runs, the five ``examples_*`` examples and the three
   ``examples_llama3_2_1b_*`` runs (set-up, serve, materialize) and the
   three ``dryrun_*`` steps), and
   ``launches_per_captured_step`` its launches in one replay of each
   engine case's and each family run's bucket-4 graph.  Every count is set to 0 just before its
   run and read just after it; a graph's replays add what its capture
   counted (``runtime/captured.py``).

Details go to ``chiprun_out/chip_smoke.json``.  The script needs CUDA and
the repository's ``src/``; without either it exits nonzero and prints no
result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_SCRIPT = time.perf_counter()     # the script's start, for its total
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_FLOPS = 67e12                  # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12                # H100 SXM bf16 tensor cores, dense
BATCH, PROMPT, TOKENS = 4, 64, 16
MIN_BYTES = 4096                   # serve's default --min-bytes
N_LAYERS = 16
LEAVES = {"wq": (2048, 2048), "wk": (2048, 512), "wv": (2048, 512),
          "wo": (2048, 2048), "w_gate": (2048, 8192), "w_up": (2048, 8192),
          "w_down": (8192, 2048)}
MINITRON_LEAVES = {"wq": (3072, 3072), "wk": (3072, 1024),
                   "wv": (3072, 1024), "wo": (3072, 3072),
                   "w_gate": (3072, 9216), "w_up": (3072, 9216),
                   "w_down": (9216, 3072)}
# f32 sums of the same exact products in another order: measured <= 3e-6
# at K <= 8192 with O(1) outputs.  A kernel that rounded f32 inputs to TF32
# or kept bf16 partial sums errs by >= 1e-4; phase 3 computes both controls
# and fails unless each exceeds this limit.
MATMUL_ATOL = 2e-5

# every kernel entry's launch counter (``launch.serve.COUNTERS``)
KERNELS = ("enec_decode", "decompress_matmul", "dense_tile_matmul",
           "enec_encode", "idd_scan", "decode_attention_kv")


def step_launches(layers: int, flat: int, buckets_per_layer=None) -> dict:
    """Kernel launches of one decode step of each served mode, read from
    the code: ``layers`` x 7 matmul leaves a step (each through
    ``weight_matmul``), ``flat`` flat L=1 streams that ``lm.decode_fn``
    materializes a step (the embed, and an untied head), and the logits
    head, one dense-tile launch in every mode (``layers.lm_logits``).  A
    stream-mode layer decodes its 7 leaves one by one (overlap off,
    ``buckets_per_layer`` None) or in the prefetch's one batched decode of
    ``buckets_per_layer`` launches (``runtime/overlap.py``)."""
    zero = dict.fromkeys(KERNELS, 0)
    matmuls = layers * len(LEAVES)
    decodes = layers * (len(LEAVES) if buckets_per_layer is None
                        else buckets_per_layer)
    return {"fused": zero | {"enec_decode": flat,
                             "decompress_matmul": matmuls,
                             "dense_tile_matmul": 1},
            "stream": zero | {"enec_decode": flat + decodes,
                              "dense_tile_matmul": matmuls + 1},
            "dense": zero | {"dense_tile_matmul": matmuls + 1}}


MINITRON_LAYERS = 32
MINITRON_VOCAB = 256000
# the flat streams of a step: llama's tied embed; minitron's embed and head
FLAT = {"llama3_2_1b": 1, "minitron_4b": 2}
ARCH_LAYERS = {"llama3_2_1b": N_LAYERS, "minitron_4b": MINITRON_LAYERS}


def run_step_launches(arch: str, mode: str, out: dict, layers=None) -> dict:
    """One decode step's launches of a ``serve.main`` run (of ``layers``
    layers; default the arch's served depth), its stream mode's prefetch
    read from the run's schedule (``out["overlap"]``)."""
    bpl = (out["overlap"]["buckets_per_layer"] if out["overlap"]["enabled"]
           else None)
    return step_launches(layers or ARCH_LAYERS[arch], FLAT[arch], bpl)[mode]

# phase scan: the shapes of tests/test_kernels.py::test_idd_scan_matches_
# cumsum, the llama embed's blocks x groups (16032 blocks of 1024 groups of
# 16) and long rows that carry across 8192 rows of 128 lanes
SCAN_SHAPES = ((1, 128), (4, 1024), (2, 4096), (3, 2048))
SCAN_EMBED = (16032, 1024)
SCAN_LONG = (8, 1 << 20)

# phase kv_attention: the grid of tests/test_decode_attention_kv.py and two
# full-width decode shapes (B, S, KV, grp): a batch of 8 at a 32768-token
# prefix, with minitron_4b's GQA group (24 heads over 8) and qwen3_32b's
# (64 over 8); the tolerance is that test's (f32 sums in another order,
# through exp and one division)
KV_GRID = ((1, 128, 1, 1), (2, 256, 2, 4), (1, 512, 4, 8))
KV_GRP12 = (1, 384, 2, 12)     # two blocks of 8 queries in the kernel
KV_FULL = {"minitron_4b": (8, 32768, 8, 3), "qwen3_32b": (8, 32768, 8, 8)}
KV_ATOL, KV_RTOL = 2e-5, 1e-4
# At S = 32768 the outputs are ~2e-3, so KV_ATOL alone would pass a kernel
# that skipped a chunk (a 1/256 change); the error is also held relative to
# the output's magnitude, and a control (dense attention without the last
# chunk) must exceed that limit.
KV_REL = 1e-4

RESULTS: dict = {}
SERVE_REFS: dict = {}     # phase serve's logits and launches, by mode
MESH_WHISPER_REF: dict = {}   # phase mesh's one-device whisper logits


def fail(msg: str):
    raise SystemExit(f"[chip_smoke] FAILED: {msg}")


def check(cond, msg: str):
    if not cond:
        fail(msg)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def needed_bytes(streams) -> int:
    """Compressed bytes a decode must read: mask, low and raw streams, and
    the true (per-block byte-padded) length of each high stream — the data
    this run holds, not the padded static bound."""
    import torch
    hl = streams.high_len.reshape(-1).to(torch.int64)
    fixed = sum(a.numel() for a in (streams.mask, streams.low, streams.raw))
    return fixed + int(((hl + 7) // 8).sum())


SPIN_CYCLES = 250_000     # ~125 us of a spin kernel before each timed run


def cuda_ms(fn, reps: int, flush=None, spin: bool = False) -> float:
    """Mean time of ``fn`` over ``reps`` runs (CUDA events), after one
    warm-up; ``flush`` runs before each timed run, outside the window
    (evicts the 50 MB L2 so weights are read from memory).  The window
    opens when the host has enqueued the start event, so on an idle card it
    also holds the host's cost of launching ``fn`` (every kernel time of
    the ``kernels`` line is taken so, as in earlier runs).  With ``spin``
    a spin kernel keeps the card busy while the host enqueues ``fn``, so
    the window holds the device's work alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    secs = time.perf_counter() - t0
    log(f"build: {len(build.SOURCES)} sources in {secs:.2f}s into "
        f"{build.BUILD_DIR.relative_to(ROOT)}")
    for name, info in build.BUILD_LOG.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    RESULTS["build_s"] = secs
    log(f"card: {card_line()}")


# ---------------------------------------------------------------------------
# phase 2: the decode kernel
# ---------------------------------------------------------------------------

def _weights(shape, fmt, gen, outliers=3e-3):
    import torch
    w = torch.randn(shape, generator=gen, device="cuda") * 0.02
    w = torch.where(torch.rand(shape, generator=gen, device="cuda")
                    < outliers, w * 32, w)
    return w.to(fmt.float_dtype)


def _grid(gen):
    """The cases both codec kernels are held on, as ``(bits, fmt, p, label,
    b_vec, l_vec)``: bf16 / fp16 / fp32 at N in {2048, 16384} with searched
    parameters; the (m, n, L) grid; all / no anomalous groups and m == n;
    two tensors' blocks in one launch with exponents at each window's edge
    (per-block b and l across the wrap)."""
    import torch
    from repro_torch.core import params, stats
    from repro_torch.core.dtypes import BF16, FORMATS, to_bits
    from repro_torch.core.params import EnecParams
    for key, fmt in FORMATS.items():
        for n_elems in (2048, 16384):
            bits = to_bits(_weights((4, n_elems), fmt, gen))
            st = stats.stack_stats(bits.reshape(1, -1), fmt)
            p = params.widen_for_range(
                params.search(st.hist, fmt, block_elems=n_elems),
                *st.bounds())
            yield bits, fmt, p, f"{key} N={n_elems} {p.astuple()}", None, None
    for m, n, L in ((1, 4, 16), (3, 6, 16), (5, 6, 32), (2, 7, 64),
                    (6, 6, 16)):
        for n_elems in (2048, 16384):
            exps = torch.randint(127 - (1 << n) + 1, 128, (2, n_elems),
                                 generator=gen, device="cuda")
            low = torch.randint(0, 1 << 16, (2, n_elems), generator=gen,
                                device="cuda") & 0x807F
            bits = ((exps << 7) | low).to(torch.int32)
            p = EnecParams(b=127, n=n, m=m, L=L, l=127 - (1 << n) + 1)
            yield (bits, BF16, p, f"grid m={m} n={n} L={L} N={n_elems}",
                   None, None)
    n_elems = 16384
    exps = torch.cat([torch.full((1, n_elems), 120, device="cuda"),
                      torch.full((1, n_elems), 127, device="cuda")])
    bits = ((exps << 7) | (torch.randint(0, 1 << 16, (2, n_elems),
                                         generator=gen, device="cuda")
                           & 0x807F)).to(torch.int32)
    yield (bits, BF16, EnecParams(b=127, n=4, m=2, L=16, l=120), "all/none",
           None, None)
    yield (bits, BF16, EnecParams(b=127, n=4, m=4, L=16, l=120), "m == n",
           None, None)
    ps = (EnecParams(b=126, n=4, m=2, L=16, l=120),
          EnecParams(b=100, n=4, m=2, L=16, l=90))
    rows = []
    for p in ps:
        e = torch.randint(p.l, p.l + 16, (n_elems,), generator=gen,
                          device="cuda")
        e[:2] = torch.tensor([p.l, p.l + 15])
        rows.append((e << 7) | (torch.arange(n_elems, device="cuda") & 127))
    b_vec = torch.tensor([p.b for p in ps], dtype=torch.int32, device="cuda")
    l_vec = torch.tensor([p.l for p in ps], dtype=torch.int32, device="cuda")
    yield (torch.stack(rows).to(torch.int32), BF16, ps[0], "per-block (b, l)",
           b_vec, l_vec)


def _decode_both(streams, n_elems, fmt, p, b_vec=None, l_vec=None):
    import torch
    from repro_torch.kernels import enec_decode, ops
    got = ops.decode_blocks(streams, n_elems, fmt, p, b_vec, l_vec)
    torch.cuda.synchronize()
    want = enec_decode.decode_blocks_plain(streams, n_elems, fmt, p,
                                           b_vec, l_vec)
    return got, want


def _sms() -> int:
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count


def _other_launches(pl, sms: int) -> list:
    """The overrides a codec kernel call is held under besides its plan:
    grids 1, 3 and 2 x SMs (as many as it has blocks) and, where the plan
    takes the lanes branch, the generic branch."""
    runs = [{"grid": g} for g in (1, 3, 2 * sms)
            if g <= pl.nblocks and g != pl.grid]
    if pl.lanes:
        runs.append({"lanes": False})
    return runs


def _decode_variants(streams, n_elems, fmt, p, b_vec, l_vec, want, label,
                     sms: int, runs=None) -> list:
    """The decode kernel under every override of ``_other_launches`` (or
    ``runs``), each bitwise equal to ``want``."""
    import torch
    from repro_torch.kernels import enec_decode
    nblocks = streams.mask.shape[0]
    b_vec, l_vec = _vecs(nblocks, p, b_vec, l_vec)
    pl, _ = enec_decode.launch_plan(nblocks, n_elems, fmt, p, "cuda")
    if runs is None:
        runs = _other_launches(pl, sms)
    for kw in runs:
        got = enec_decode.decode_blocks_cuda(streams, n_elems, fmt, p, b_vec,
                                             l_vec, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"decode kernel {kw} != plain "
              f"({label})")
    return runs


def _vecs(nblocks, p, b_vec=None, l_vec=None):
    import torch
    if b_vec is None:
        b_vec = torch.full((nblocks,), p.b, dtype=torch.int32, device="cuda")
    if l_vec is None:
        l_vec = torch.full((nblocks,), p.l, dtype=torch.int32, device="cuda")
    return b_vec, l_vec


def _unaligned(t, offset: int):
    """A contiguous copy of ``t`` whose data starts ``offset`` bytes past
    an aligned allocation (the stream-staging fallbacks: 4-byte cp.async at
    offset 4, byte loads at offset 1)."""
    import torch
    nbytes = t.numel() * t.element_size()
    buf = torch.empty(nbytes + 16, dtype=torch.uint8, device=t.device)
    out = buf[offset:offset + nbytes].view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


def _copy_ms(nbytes: int, flush=None) -> float:
    """A device ``copy_`` of nbytes / 2 bytes (nbytes read and written in
    all): the card's practical floor for a kernel moving nbytes."""
    import torch
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), 10, flush)
    del src, dst
    return ms


def phase_decode():
    import torch
    from repro_torch.core import codec
    from repro_torch.core.api import slice_stacked
    from repro_torch.core.codec_api import Codec
    from repro_torch.kernels import enec_decode
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = _sms()
    cases = variants = 0
    branches = set()
    for bits, fmt, p, label, b_vec, l_vec in _grid(gen):
        streams = codec.encode_blocks(bits, fmt, p, b_vec=b_vec)
        got, want = _decode_both(streams, bits.shape[1], fmt, p, b_vec, l_vec)
        check(torch.equal(got, want), f"decode kernel != plain ({label})")
        check(torch.equal(got.to(fmt.work_dtype) & fmt.bits_mask, bits),
              f"decode is not lossless ({label})")
        variants += len(_decode_variants(streams, bits.shape[1], fmt, p,
                                         b_vec, l_vec, want, label, sms))
        branches.add(enec_decode.lanes_ok(fmt, bits.shape[1], p))
        if cases == 0:   # streams off 16-byte alignment: cp.async, loads
            for off in (4, 1):
                moved = streams._replace(**{
                    k: _unaligned(getattr(streams, k), off)
                    for k in ("mask", "low", "high", "raw")})
                variants += len(_decode_variants(
                    moved, bits.shape[1], fmt, p, b_vec, l_vec, want,
                    f"{label}, streams at offset {off}", sms,
                    runs=[{}, {"lanes": False}, {"grid": 3}]))
        cases += 1
    check(branches == {False, True}, f"the grid reaches branches {branches}")
    log(f"decode: {cases} cases bitwise equal to the plain decoder under "
        f"the plan and {variants} other launches (grids 1, 3, 2 x SMs; "
        f"generic branch; unaligned streams)")

    # the main path's decode: the full-width tied embed, flat L=1 stack
    embed = (torch.nn.init.trunc_normal_(
        torch.empty((128256, 2048), device="cuda"), 0.0, 1.0, -2.0, 2.0,
        generator=gen) * 0.02).to(torch.bfloat16)
    codec_obj = Codec()
    [ct] = codec_obj.compress_stacked_many([embed[None]], shards=2)
    flat = codec.flatten_blocks(ct.streams)
    nblocks = flat.mask.shape[0]
    b_vec, l_vec = _vecs(nblocks, ct.params)
    got, want = _decode_both(flat, ct.block_elems, ct.fmt, ct.params,
                             b_vec, l_vec)
    check(torch.equal(got, want), "embed decode kernel != plain")
    embed_err = float((got.view(torch.bfloat16).float()
                       - want.view(torch.bfloat16).float()).abs().max())
    check(torch.equal(got.reshape(-1)[:embed.numel()],
                      embed.reshape(-1).view(torch.int16)),
          "embed decode is not lossless")
    del got
    pl, plan_info = enec_decode.launch_plan(nblocks, ct.block_elems, ct.fmt,
                                            ct.params, "cuda")
    check(pl.lanes, f"the embed's plan {plan_info} is not the lanes branch")
    embed_runs = _decode_variants(flat, ct.block_elems, ct.fmt, ct.params,
                                  b_vec, l_vec, want, "embed", sms)
    del want
    timed = {}

    def dec(**kw):
        return lambda: enec_decode.decode_blocks_cuda(
            flat, ct.block_elems, ct.fmt, ct.params, b_vec, l_vec, **kw)

    ms = cuda_ms(dec(), reps=10)
    dev_ms = cuda_ms(dec(), reps=10, spin=True)
    timed["generic"] = {
        "ms": cuda_ms(dec(lanes=False), reps=10),
        "dev_ms": cuda_ms(dec(lanes=False), reps=10, spin=True),
        "plan": enec_decode.launch_plan(nblocks, ct.block_elems, ct.fmt,
                                        ct.params, "cuda", lanes=False)[1]}
    plain_ms = cuda_ms(lambda: enec_decode.decode_blocks_plain(
        flat, ct.block_elems, ct.fmt, ct.params, b_vec, l_vec), reps=2)
    in_bytes = needed_bytes(flat) + 8 * nblocks        # + per-block b, l
    out_bytes = nblocks * ct.block_elems * 2
    bound = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    copy_ms = _copy_ms(in_bytes + out_bytes)
    hl = flat.high_len.to(torch.int64)
    hw = ct.params.n - ct.params.m
    staged_high = int(sum(
        min(flat.high.shape[1], -(-e // 16) * 16) for e in
        [_high_extent(int(c), hw, ct.block_elems, flat.high.shape[1])
         for c in (hl // max(hw, 1)).tolist()])) if hw else 0
    log(f"decode embed 128256x2048 bf16 ({nblocks} blocks, params "
        f"{ct.params.astuple()}, ratio {ct.ratio():.4f}): kernel "
        f"{ms:.4f} ms [spin {dev_ms:.4f}], plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms (bytes {in_bytes + out_bytes}), device copy_ of "
        f"the same bytes {copy_ms:.4f} ms, {bound / ms:.3f} of bound; "
        f"generic branch "
        f"{timed['generic']['ms']:.4f} [spin "
        f"{timed['generic']['dev_ms']:.4f}] ms; plan {plan_info}; high "
        f"bytes staged {staged_high} of {flat.high.numel()} static, "
        f"{int(((hl + 7) // 8).sum())} exact; held under {embed_runs}")

    # one llama layer's 7 leaves as stream mode decodes them (one launch a
    # leaf, flat blocks of one layer of the stacked streams)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    layer = {"ms": 0.0, "dev_ms": 0.0, "bound_ms": 0.0, "bytes": 0}
    for name, (k, n) in LEAVES.items():
        w = (torch.nn.init.trunc_normal_(
            torch.empty((2, k, n), device="cuda"), 0.0, 1.0, -2.0, 2.0,
            generator=gen) / math.sqrt(k)).to(torch.bfloat16)
        [lct] = codec_obj.compress_stacked_many([w], shards=2)
        lflat = codec.flatten_blocks(slice_stacked(lct, 0).streams)
        lflat_one, lp_one = lflat.map(lambda t: t[:1]), lct.params
        lb, ll = _vecs(lflat.mask.shape[0], lct.params)
        lwant = enec_decode.decode_blocks_plain(lflat, lct.block_elems,
                                                lct.fmt, lct.params, lb, ll)
        _decode_variants(lflat, lct.block_elems, lct.fmt, lct.params, lb,
                         ll, lwant, f"layer leaf {name}", sms, runs=[{}])
        fn = (lambda f=lflat, c=lct, b=lb, l=ll:
              enec_decode.decode_blocks_cuda(f, c.block_elems, c.fmt,
                                             c.params, b, l))
        nbytes = (needed_bytes(lflat) + 8 * lflat.mask.shape[0]
                  + lflat.mask.shape[0] * lct.block_elems * 2)
        layer["ms"] += cuda_ms(fn, 20, flush_buf.zero_)
        layer["dev_ms"] += cuda_ms(fn, 20, flush_buf.zero_, spin=True)
        layer["bytes"] += nbytes
        del w, lct, lwant
    layer["bound_ms"] = layer["bytes"] / HBM_BYTES_PER_S * 1e3
    # host time a call (one-block decodes back to back, one synchronize):
    # what each of stream mode's 113 decodes a step costs the host
    one = codec.flatten_blocks(lflat_one)
    ob, ol = _vecs(1, lp_one)
    enec_decode.decode_blocks_cuda(one, 16384, ct.fmt, lp_one, ob, ol)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        enec_decode.decode_blocks_cuda(one, 16384, ct.fmt, lp_one, ob, ol)
    torch.cuda.synchronize()
    layer["host_us_per_call"] = (time.perf_counter() - t0) / 200 * 1e6
    layer["copy_ms"] = 7 * _copy_ms(layer["bytes"] // 7, flush_buf.zero_)
    log(f"decode one llama layer's 7 stream-mode leaves (7 launches, L2 "
        f"flushed): {layer['ms']:.4f} ms [spin {layer['dev_ms']:.4f}], "
        f"bound {layer['bound_ms']:.4f} ms (bytes {layer['bytes']}), 7 "
        f"device copy_s of a seventh of the bytes each "
        f"{layer['copy_ms']:.4f} ms; host {layer['host_us_per_call']:.1f} "
        f"us a call")
    resources = _ptxas_resources("enec_decode", {
        "decode_lanes_kernel": "lanes", "decode_generic_kernel": "generic"})
    for kind, line in resources.items():
        log(f"decode ptxas {kind}: {line}")
    RESULTS["decode"] = {"cases": cases, "variants": variants,
                         "embed_ms": ms, "embed_dev_ms": dev_ms,
                         "embed_plain_ms": plain_ms, "embed_bound_ms": bound,
                         "embed_copy_ms": copy_ms,
                         "embed_bytes": in_bytes + out_bytes,
                         "embed_max_abs_err": embed_err,
                         "embed_params": list(ct.params.astuple()),
                         "embed_ratio": ct.ratio(), "embed_plan": plan_info,
                         "embed_high_bytes_staged": staged_high,
                         "embed_timed": timed, "layer_stream": layer,
                         "resources": resources}
    del embed, ct, flat, flush_buf
    torch.cuda.empty_cache()


def _high_extent(c: int, hw: int, n: int, w_high: int) -> int:
    """csrc/enec_block.cuh: high_extent (the high bytes a decode stages)."""
    if c <= 0 or hw == 0:
        return 0
    if hw % 8 == 0:
        return (hw // 8 - 1) * n + c
    w, sub = hw, n
    while w < 8 and sub > 1:
        w, sub = w * 2, sub // 2
    return c if c <= sub else w_high


# ---------------------------------------------------------------------------
# phase encode: the encode kernel
# ---------------------------------------------------------------------------

def _encode_both(bits, fmt, p, b_vec=None):
    """Encode kernel and plain encoder on the same (B, N) work-type bits."""
    import torch
    from repro_torch.core.dtypes import to_container
    from repro_torch.kernels import enec_encode
    raw = to_container(bits, fmt).contiguous()
    if b_vec is None:
        b_vec = torch.full((bits.shape[0],), p.b, dtype=torch.int32,
                           device="cuda")
    got = enec_encode.encode_blocks_cuda(raw, fmt, p, b_vec)
    torch.cuda.synchronize()
    want = enec_encode.encode_blocks_plain(raw, fmt, p, b_vec)
    return got, want


def _encode_variants(raw, fmt, p, b_vec, want, label, sms: int,
                     runs=None) -> list:
    """The encode kernel under every override of ``_other_launches`` (or
    ``runs``), each byte-identical to ``want`` in all five streams."""
    import torch
    from repro_torch.kernels import enec_encode
    nblocks, n_elems = raw.shape
    pl, _ = enec_encode.launch_plan(nblocks, n_elems, fmt, p, "cuda")
    if runs is None:
        runs = _other_launches(pl, sms)
    for kw in runs:
        got = enec_encode.encode_blocks_cuda(raw, fmt, p, b_vec, **kw)
        torch.cuda.synchronize()
        for name in got._fields:
            check(torch.equal(getattr(got, name), getattr(want, name)),
                  f"encode kernel {kw} != plain in {name} ({label})")
    return runs


def phase_encode():
    import torch
    from repro_torch.core import params, stats
    from repro_torch.core.dtypes import BF16, to_container
    from repro_torch.kernels import enec_decode, enec_encode
    gen = torch.Generator(device="cuda").manual_seed(2)
    sms = _sms()
    cases = variants = 0
    branches = set()
    for bits, fmt, p, label, b_vec, l_vec in _grid(gen):
        got, want = _encode_both(bits, fmt, p, b_vec)
        for name in got._fields:
            check(torch.equal(getattr(got, name), getattr(want, name)),
                  f"encode kernel != plain in {name} ({label})")
        b, l_ = _vecs(bits.shape[0], p, b_vec, l_vec)
        dec = enec_decode.decode_blocks_cuda(got, bits.shape[1], fmt, p, b,
                                             l_)
        torch.cuda.synchronize()
        check(torch.equal(dec.to(fmt.work_dtype) & fmt.bits_mask, bits),
              f"encode kernel -> decode kernel is not lossless ({label})")
        raw = to_container(bits, fmt).contiguous()
        variants += len(_encode_variants(raw, fmt, p, b, want, label, sms))
        branches.add(enec_encode.lanes_ok(fmt, bits.shape[1], p))
        if cases == 0:   # input off 16-byte alignment: cp.async, loads
            for off in (4, 2):
                variants += len(_encode_variants(
                    _unaligned(raw, off), fmt, p, b, want,
                    f"{label}, input at offset {off}", sms,
                    runs=[{}, {"lanes": False}, {"grid": 3}]))
        cases += 1
    check(branches == {False, True}, f"the grid reaches branches {branches}")
    log(f"encode: {cases} cases byte-identical to the plain encoder in all "
        f"five streams under the plan and {variants} other launches (grids "
        f"1, 3, 2 x SMs; generic branch; unaligned input), each decoded "
        f"back to its input by the decode kernel")

    # the main path's largest encode: the full-width tied embed
    embed = (torch.nn.init.trunc_normal_(
        torch.empty((128256, 2048), device="cuda"), 0.0, 1.0, -2.0, 2.0,
        generator=gen) * 0.02).to(torch.bfloat16)
    raw = embed.view(torch.int16).reshape(-1, 16384)
    st = stats.stack_stats(raw.reshape(1, -1), BF16)
    p = params.widen_for_range(params.search(st.hist, BF16), *st.bounds())
    nblocks = raw.shape[0]
    b_vec = torch.full((nblocks,), p.b, dtype=torch.int32, device="cuda")
    got = enec_encode.encode_blocks_cuda(raw, BF16, p, b_vec)
    torch.cuda.synchronize()
    want = enec_encode.encode_blocks_plain(raw, BF16, p, b_vec)
    for name in got._fields:
        check(torch.equal(getattr(got, name), getattr(want, name)),
              f"embed encode kernel != plain in {name}")
    # largest difference of any stream byte (or high_len) from the plain
    # encoder's: the byte-identity check as a number
    embed_err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                    if a.numel() else 0 for a, b in zip(got, want))
    written = sum(a.numel() * a.element_size() for a in got)
    del got
    pl, plan_info = enec_encode.launch_plan(nblocks, 16384, BF16, p, "cuda")
    check(pl.lanes, f"the embed's plan {plan_info} is not the lanes branch")
    embed_runs = _encode_variants(raw, BF16, p, b_vec, want, "embed", sms)
    del want
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def enc(**kw):
        return lambda: enec_encode.encode_blocks_cuda(raw, BF16, p, b_vec,
                                                      **kw)

    ms = cuda_ms(enc(), 10, flush_buf.zero_)
    dev_ms = cuda_ms(enc(), 10, flush_buf.zero_, spin=True)
    generic = {"ms": cuda_ms(enc(lanes=False), 10, flush_buf.zero_),
               "dev_ms": cuda_ms(enc(lanes=False), 10, flush_buf.zero_,
                                 spin=True),
               "plan": enec_encode.launch_plan(nblocks, 16384, BF16, p,
                                               "cuda", lanes=False)[1]}
    plain_ms = cuda_ms(lambda: enec_encode.encode_blocks_plain(
        raw, BF16, p, b_vec), 2, flush_buf.zero_)
    in_bytes = raw.numel() * 2 + 4 * nblocks            # + per-block b
    bound = (in_bytes + written) / HBM_BYTES_PER_S * 1e3
    copy_ms = _copy_ms(in_bytes + written, flush_buf.zero_)
    resources = _ptxas_resources("enec_encode", {
        "encode_kernelILb1E": "lanes", "encode_kernelILb0E": "generic"})
    for kind, line in resources.items():
        log(f"encode ptxas {kind}: {line}")
    log(f"encode embed 128256x2048 bf16 ({nblocks} blocks, params "
        f"{p.astuple()}): kernel {ms:.4f} ms [spin {dev_ms:.4f}], plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes "
        f"{in_bytes + written}), device copy_ of the same bytes "
        f"{copy_ms:.4f} ms, {bound / ms:.3f} of bound; generic branch "
        f"{generic['ms']:.4f} [spin {generic['dev_ms']:.4f}] ms; plan "
        f"{plan_info}; held under {embed_runs}")
    RESULTS["encode"] = {"cases": cases, "variants": variants,
                         "embed_ms": ms, "embed_dev_ms": dev_ms,
                         "embed_plain_ms": plain_ms, "embed_bound_ms": bound,
                         "embed_copy_ms": copy_ms,
                         "embed_bytes": in_bytes + written,
                         "embed_max_abs_err": embed_err,
                         "embed_params": list(p.astuple()),
                         "embed_plan": plan_info, "embed_generic": generic,
                         "resources": resources}
    del embed, raw, flush_buf
    torch.cuda.empty_cache()


def _setup_launches():
    """The fused set-up's encode launches, re-planned as ``serve.main``
    plans them on the same seeded llama3_2_1b weights: (bucket, blocks,
    fmt, params, b_vec) for each."""
    from repro_torch.configs import get_config
    from repro_torch.core.codec_api import Codec
    from repro_torch.models import build_model
    from repro_torch.runtime.streaming import serving_encode_plans
    params = build_model(get_config("llama3_2_1b")).init(seed=0,
                                                         device="cuda")
    codec_obj = Codec()
    for plan in serving_encode_plans(params, mode="fused",
                                     min_bytes=MIN_BYTES, shards=2,
                                     codec=codec_obj):
        for bucket, (blocks, fmt, p, b_vec) in zip(
                plan.buckets, codec_obj.encode_launches(plan)):
            yield bucket, blocks, fmt, p, b_vec


def _time_encode_launch(blocks, fmt, p, b_vec, written: int) -> dict:
    """One encode launch through ``ops.encode_blocks`` (its input already
    in the kernel's container type), in both windows, beside its bound and
    a device copy_ of the same bytes."""
    import torch
    from repro_torch.core.dtypes import to_container
    from repro_torch.kernels import ops
    if blocks.dtype != fmt.bits_dtype:
        blocks = to_container(blocks, fmt)
    blocks = blocks.contiguous()
    b_vec = b_vec.to(torch.int32).contiguous()
    nbytes = blocks.numel() * blocks.element_size() + 4 * len(b_vec) \
        + written
    run = (lambda: ops.encode_blocks(blocks, fmt, p, b_vec))
    return {"ms": cuda_ms(run, 3), "dev_ms": cuda_ms(run, 3, spin=True),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "copy_ms": _copy_ms(nbytes), "bytes": nbytes}


def time_setup_encode() -> list:
    """Each of the fused set-up's encode launches timed, with no byte
    check: the same measurement on any tree's ``repro_torch`` (a parent
    commit's package first on ``sys.path``), for before and after in one
    call."""
    import torch
    from repro_torch.kernels import ops
    rows = []
    for _, blocks, fmt, p, b_vec in _setup_launches():
        got = ops.encode_blocks(blocks, fmt, p, b_vec)
        written = sum(a.numel() * a.element_size() for a in got)
        del got
        rows.append({"blocks": blocks.shape[0]}
                    | _time_encode_launch(blocks, fmt, p, b_vec, written))
        del blocks, b_vec
        torch.cuda.empty_cache()
    log(f"encode: the fused set-up's launch(es) timed: {rows}")
    return rows


def phase_setup_encode(fused):
    """The fused set-up's own encoder launches: the same seeded weights
    re-planned as ``serve.main`` plans them (``fused`` is phase 4's fused
    run, whose bucket count they must repeat); each bucket's one launch,
    over its whole block count with its per-block ``b``, byte-identical to
    the plain encoder in all five streams (compared in chunks of rows),
    then timed beside its bound and a device copy_ of the same bytes."""
    import torch
    from repro_torch.kernels import enec_encode, ops
    launches = []
    for bucket, blocks, fmt, p, b_vec in _setup_launches():
        got = ops.encode_blocks(blocks, fmt, p, b_vec)
        torch.cuda.synchronize()
        nblocks = blocks.shape[0]
        chunk = 16384
        for s in range(0, nblocks, chunk):
            want = enec_encode.encode_blocks_plain(
                blocks[s:s + chunk], fmt, p, b_vec[s:s + chunk])
            for name in want._fields:
                check(torch.equal(getattr(got, name)[s:s + chunk],
                                  getattr(want, name)),
                      f"set-up encode launch != plain in {name} "
                      f"(blocks {s}..{s + chunk} of {nblocks})")
            del want
        written = sum(a.numel() * a.element_size() for a in got)
        del got
        launches.append({
            "key": [bucket.fmt_name, list(bucket.params_key),
                    bucket.block_elems],
            "stacks": bucket.n_tensors, "blocks": nblocks,
            "input_bytes": blocks.numel() * blocks.element_size(),
            "distinct_b": int(torch.unique(b_vec).numel()),
            "plan": enec_encode.launch_plan(nblocks, blocks.shape[1], fmt, p,
                                            "cuda")[1]}
            | _time_encode_launch(blocks, fmt, p, b_vec, written))
        del blocks, b_vec
        torch.cuda.empty_cache()
    check(len(launches) == fused["encode_buckets"],
          f"re-planned set-up has {len(launches)} buckets, the fused run "
          f"{fused['encode_buckets']}")
    log(f"encode: the fused set-up's {len(launches)} launch(es) "
        f"{launches} byte-identical to the plain encoder in all five "
        f"streams (ms [spin window] beside the bound and a device copy_ of "
        f"the same bytes)")
    RESULTS["encode"]["setup_launches"] = launches
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: the fused decode+matmul kernel
# ---------------------------------------------------------------------------

def _tf32(t):
    """``t`` (f32) rounded to TF32's 10 mantissa bits (half away from 0)."""
    import torch
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _bf16_sums(x, w):
    """x @ w with the partial sum rounded to bf16 after each 128-deep tile."""
    import torch
    acc = torch.zeros((x.shape[0], w.shape[1]), device=x.device)
    for k0 in range(0, w.shape[0], 128):
        acc = (acc + x[:, k0:k0 + 128].float() @ w[k0:k0 + 128].float()
               ).bfloat16().float()
    return acc


def _ptxas_resources(source: str = "decompress_matmul",
                     kinds: dict = None) -> dict:
    """Registers, spills and static shared memory of each kernel of one
    source's build, from its ``ptxas -v`` output, keyed by ``kinds`` (a
    mangled-name fragment -> label; the matmul's four instantiations by
    default)."""
    import re
    from repro_torch.kernels import build
    if kinds is None:
        kinds = {"ILb1ELb1E": "fused split", "ILb1ELb0E": "fused serial",
                 "ILb0ELb1E": "dense split", "ILb0ELb0E": "dense serial"}
    out, kind, spill = {}, None, ""
    for line in build.BUILD_LOG.get(source, {}).get(
            "ptxas", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kind = next((v for k, v in kinds.items() if k in m.group(1)),
                        m.group(1))
        elif "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif "Used" in line and kind:
            out[kind] = f"{line.split(':', 1)[-1].strip()}; {spill}"
    return out


def _time_leaf(name, k, n, m, x, ct, w, w_t, comp_bytes, codec_obj, flush,
               plain: bool) -> dict:
    """Times of one leaf at one M: both entries (the dense-tile one on the
    row-major and the transposed layout) and torch.matmul in both of
    cuda_ms's windows (``*_ms`` without, ``*_dev_ms`` with the spin
    kernel), and the plain versions; bounds from this run's bytes and
    operations."""
    import torch
    from repro_torch.kernels.decompress_matmul import (
        decompress_matmul_cuda, decompress_matmul_plain, dense_matmul_cuda,
        dense_matmul_plain)
    timed = {"ms": lambda: decompress_matmul_cuda(x, ct, k, n),
             "dense_ms": lambda: dense_matmul_cuda(x, w),
             "dense_t_ms": lambda: dense_matmul_cuda(x, w_t),
             "library_ms": lambda: torch.matmul(x, w)}
    row = {}
    for key, fn in timed.items():   # both windows (cuda_ms), in one run
        row[key] = cuda_ms(fn, 20, flush)
        row[key.replace("ms", "dev_ms")] = cuda_ms(fn, 20, flush, spin=True)
    if plain:
        row["plain_ms"] = cuda_ms(lambda: decompress_matmul_plain(
            x, ct, k, n, codec_obj), 3, flush)
        row["dense_plain_ms"] = cuda_ms(lambda: dense_matmul_plain(x, w), 3,
                                        flush)
    xo = m * k * 2 + m * n * 4
    flops_ms = 2 * m * k * n / BF16_FLOPS * 1e3   # bf16 x bf16 products
    row["bound_ms"] = max((comp_bytes + xo) / HBM_BYTES_PER_S * 1e3,
                          flops_ms)
    row["dense_bound_ms"] = max((k * n * 2 + xo) / HBM_BYTES_PER_S * 1e3,
                                flops_ms)
    log(f"matmul {name} {k}x{n} M={m} (ms [spin window]): fused "
        f"{row['ms']:.4f} [{row['dev_ms']:.4f}] (bound "
        f"{row['bound_ms']:.4f}), dense-tile {row['dense_ms']:.4f} "
        f"[{row['dense_dev_ms']:.4f}], transposed {row['dense_t_ms']:.4f} "
        f"[{row['dense_t_dev_ms']:.4f}] (bound {row['dense_bound_ms']:.4f}),"
        f" torch.matmul bf16 {row['library_ms']:.4f} "
        f"[{row['library_dev_ms']:.4f}]"
        + (f", plain {row['plain_ms']:.4f}" if plain else ""))
    return row


def _head_rows(gen, flush) -> dict:
    """The logits head as a decode step runs it (``layers.lm_logits``: the
    dense-tile entry on the tied full-width llama head ``embed.T``, the
    transposed view it takes as it is): each row's logits bitwise equal at
    M = 1, 2 and 4 (the engine's contract), within MATMUL_ATOL of the plain
    tiled matmul and of torch.matmul; timed beside its bound and
    torch.matmul on the same bf16 operands."""
    import torch
    from repro_torch.kernels.ref import tiled_matmul_ref
    from repro_torch.models.layers import lm_logits
    vocab, d = 128256, 2048
    embed = (torch.nn.init.trunc_normal_(
        torch.empty((vocab, d), device="cuda"), 0.0, 1.0, -2.0, 2.0,
        generator=gen) * 0.02).to(torch.bfloat16)
    x = torch.randn((BATCH, 1, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    by_m = {m: lm_logits(x[:m], embed.T) for m in (1, 2, BATCH)}
    torch.cuda.synchronize()
    full = by_m[BATCH]
    check(tuple(full.shape) == (BATCH, 1, vocab), f"head {full.shape}")
    for m in (1, 2):
        check(torch.equal(by_m[m].view(torch.int32),
                          full[:m].view(torch.int32)),
              f"head rows at M={m} differ from M={BATCH}")
    x2 = x.reshape(BATCH, d)
    err = float((full[:, 0] - tiled_matmul_ref(x2, embed.T)).abs().max())
    err_lib = float((full[:, 0] - torch.matmul(x2.float(), embed.T.float()))
                    .abs().max())
    check(max(err, err_lib) <= MATMUL_ATOL, f"head |kernel - plain| {err}, "
          f"|kernel - torch.matmul| {err_lib} > {MATMUL_ATOL}")
    row = {"max_abs_err_plain": err, "max_abs_err_matmul": err_lib,
           "ms": cuda_ms(lambda: lm_logits(x, embed.T), 20, flush),
           "dev_ms": cuda_ms(lambda: lm_logits(x, embed.T), 20, flush,
                             spin=True),
           "library_ms": cuda_ms(lambda: torch.matmul(x2, embed.T), 20,
                                 flush),
           "library_dev_ms": cuda_ms(lambda: torch.matmul(x2, embed.T), 20,
                                     flush, spin=True),
           "bound_ms": (vocab * d * 2 + BATCH * d * 2 + BATCH * vocab * 4)
           / HBM_BYTES_PER_S * 1e3}
    log(f"matmul head: llama tied head {d}x{vocab} (embed.T) at M={BATCH}: "
        f"rows bitwise equal at M = 1, 2, {BATCH}; |kernel - plain| "
        f"{err:.3g}, |kernel - torch.matmul| {err_lib:.3g}; dense-tile "
        f"{row['ms']:.4f} ms [spin {row['dev_ms']:.4f}], torch.matmul bf16 "
        f"{row['library_ms']:.4f} [{row['library_dev_ms']:.4f}], bound "
        f"{row['bound_ms']:.4f} ms")
    del embed, by_m, full
    return row


def _host_us_per_call(codec_obj, gen) -> dict:
    """Host clock per call of each matmul path over 200 calls issued back
    to back with one synchronize at the end, on llama's smallest leaf at
    M = BATCH: the launch cost an eager decode step pays 112 times."""
    import torch
    from repro_torch.core.api import slice_stacked
    from repro_torch.kernels.decompress_matmul import (
        decompress_matmul_cuda, dense_matmul_cuda)
    k, n = LEAVES["wk"]
    w = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
         ).to(torch.bfloat16)
    [ct] = codec_obj.tile_weights_for_fusion_many([w])
    ct = slice_stacked(ct, 0)
    x = torch.randn((BATCH, k), generator=gen, device="cuda").to(
        torch.bfloat16)
    out = {}
    for name, fn in (("fused", lambda: decompress_matmul_cuda(x, ct, k, n)),
                     ("dense", lambda: dense_matmul_cuda(x, w)),
                     ("torch.matmul", lambda: torch.matmul(x, w))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / 200 * 1e6
    return out


def phase_matmul():
    """Both entries at every leaf shape of llama3_2_1b and minitron_4b and
    M in {1, BATCH, BATCH * PROMPT}: fused == dense-tile (row-major and
    transposed weight) bitwise; each row bitwise equal to the same row at
    M = 1 and M = BATCH (the two branches of the schedule: split-K at
    M <= 16, the serial walk above); within MATMUL_ATOL of the plain version
    and torch.matmul; timed at M = BATCH and M = BATCH * PROMPT."""
    import torch
    from repro_torch.core.api import slice_stacked
    from repro_torch.core.codec_api import Codec
    from repro_torch.kernels.decompress_matmul import (
        decompress_matmul_cuda, decompress_matmul_plain, dense_matmul_cuda,
        dense_matmul_plain, last_plan, plan)
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    codec_obj = Codec()
    rows, max_err, max_err_dense, max_err_lib = [], 0.0, 0.0, 0.0
    controls, plans = {}, {}
    src = {"fused": "ms", "fused_plain": "plain_ms", "dense": "dense_ms",
           "dense_t": "dense_t_ms", "dense_plain": "dense_plain_ms",
           "library": "library_ms", "fused_bound": "bound_ms",
           "dense_bound": "dense_bound_ms", "fused_dev": "dev_ms",
           "dense_dev": "dense_dev_ms", "dense_t_dev": "dense_t_dev_ms",
           "library_dev": "library_dev_ms"}
    totals = {}
    ms_all = (1, BATCH, BATCH * PROMPT)
    for model, leaves in (("llama3_2_1b", LEAVES),
                          ("minitron_4b", MINITRON_LEAVES)):
        for m_t in (BATCH, BATCH * PROMPT):
            totals[(model, m_t)] = dict.fromkeys(src, 0.0)
        for name, (k, n) in leaves.items():
            w = (torch.nn.init.trunc_normal_(
                torch.empty((k, n), device="cuda"), 0.0, 1.0, -2.0, 2.0,
                generator=gen) / math.sqrt(k)).to(torch.bfloat16)
            [ct] = codec_obj.tile_weights_for_fusion_many([w], shards=2)
            check(ct is not None, f"{name}: tiles did not compress")
            ct = slice_stacked(ct, 0)
            w_dec = codec_obj.untile_matmul_weight(ct, k, n)
            check(torch.equal(w_dec, w), f"{name}: tile decode not lossless")
            # the layout a stream handle materializes (stride_k == 1)
            w_t = w_dec.t().contiguous().t()
            comp_bytes = needed_bytes(ct.streams)
            x_all = torch.randn((ms_all[-1], k), generator=gen,
                                device="cuda").to(torch.bfloat16)
            by_m = {}
            for m in ms_all:
                x = x_all[:m]
                fused = decompress_matmul_cuda(x, ct, k, n)
                f_plan = last_plan()
                dense = dense_matmul_cuda(x, w_dec)
                d_plan = last_plan()
                dense_t = dense_matmul_cuda(x, w_t)
                torch.cuda.synchronize()
                label = f"{model} {name} M={m}"
                for entry, pl in (("fused", f_plan), ("dense", d_plan)):
                    check(pl["split"] == plan(m, k, n).split,
                          f"{label}: {entry} plan {pl}")
                    branch = "split" if pl["split"] else "serial"
                    plans.setdefault(f"{entry} {branch}", pl)
                for other, what in ((dense, "dense-tile"),
                                    (dense_t, "dense-tile transposed")):
                    check(torch.equal(fused.view(torch.int32),
                                      other.view(torch.int32)),
                          f"{label}: fused != {what} entry bitwise")
                plain = decompress_matmul_plain(x, ct, k, n, codec_obj)
                lib = torch.matmul(x.float(), w.float())
                err = float((fused - plain).abs().max())
                err_dense = float((dense - dense_matmul_plain(x, w_dec))
                                  .abs().max())
                err_lib = float((fused - lib).abs().max())
                check(max(err, err_dense, err_lib) <= MATMUL_ATOL,
                      f"{label}: |fused - plain| {err}, |dense-tile - "
                      f"plain| {err_dense}, |fused - torch.matmul| "
                      f"{err_lib} > {MATMUL_ATOL}")
                max_err = max(max_err, err)
                max_err_dense = max(max_err_dense, err_dense)
                max_err_lib = max(max_err_lib, err_lib)
                by_m[m] = fused
                row = {"model": model, "leaf": name, "k": k, "n": n, "m": m,
                       "plan": f_plan, "dense_plan": d_plan,
                       "max_abs_err_plain": err,
                       "max_abs_err_matmul": err_lib}
                if m == BATCH and "bf16_sums" not in controls:
                    controls["bf16_sums"] = float(
                        (_bf16_sums(x, w) - plain).abs().max())
                if m != 1:
                    row.update(_time_leaf(
                        f"{model} {name}", k, n, m, x, ct, w, w_t,
                        comp_bytes, codec_obj, flush,
                        plain=model == "llama3_2_1b"))
                    for key, s_key in src.items():
                        totals[(model, m)][key] += row.get(s_key, 0.0)
                rows.append(row)
            # the engine contract: a row's bits do not depend on M (nor on
            # the branch M takes)
            for m in ms_all[:-1]:
                check(torch.equal(by_m[ms_all[-1]][:m].view(torch.int32),
                                  by_m[m].view(torch.int32)),
                      f"{model} {name}: rows at M={ms_all[-1]} differ from "
                      f"M={m}")
    # the kernel's other branches: fp16 / fp32 weights, f32 activations,
    # ragged K and N (zero-padded tiles), m == n (no high stream), each at
    # a split-K M and a serial M
    from repro_torch.core.params import EnecParams
    for w_dt, (k, n), x_dt, fixed in (
            (torch.float16, (256, 384), torch.bfloat16, False),
            (torch.float32, (256, 384), torch.float32, False),
            (torch.bfloat16, (250, 120), torch.float32, False),
            (torch.bfloat16, (250, 120), torch.bfloat16, False),
            (torch.bfloat16, (256, 128), torch.bfloat16, True)):
        w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(w_dt)
        p = None
        if fixed:
            e = (w.view(torch.int16).to(torch.int32) >> 7) & 0xFF
            lo, hi = int(e.min()), int(e.max())
            width = max((hi - lo).bit_length() + 1, 2)
            p = EnecParams(b=hi, n=width, m=width, L=16, l=lo)
        [ct] = codec_obj.tile_weights_for_fusion_many([w], p=p)
        ct = slice_stacked(ct, 0)
        check(not fixed or ct.streams.high.shape[-1] == 0, "m == n case")
        x_all = torch.randn((264, k), generator=gen, device="cuda").to(x_dt)
        by_m = {}
        for m in (5, 40, 264):   # both branches of both entries
            x = x_all[:m]
            fused = decompress_matmul_cuda(x, ct, k, n)
            f_plan = last_plan()
            plans.setdefault("fused split" if f_plan["split"]
                             else "fused serial", f_plan)
            dense = dense_matmul_cuda(x, w)
            dense_t = dense_matmul_cuda(x, w.t().contiguous().t())
            torch.cuda.synchronize()
            label = (f"{w_dt} {k}x{n} x {x_dt}{' m==n' if fixed else ''} "
                     f"M={m}")
            for other, what in ((dense, "dense-tile"),
                                (dense_t, "dense-tile transposed")):
                check(torch.equal(fused.view(torch.int32),
                                  other.view(torch.int32)),
                      f"{label}: fused != {what} entry bitwise")
            plain = decompress_matmul_plain(x, ct, k, n, codec_obj)
            err = float((fused - plain).abs().max())
            check(err <= MATMUL_ATOL, f"{label}: |fused - plain| {err}")
            max_err = max(max_err, err)
            by_m[m] = fused
            rows.append({"case": label, "max_abs_err_plain": err})
            if w_dt == torch.float32 and m == 5:
                controls["tf32_inputs"] = float(
                    (dense_matmul_plain(_tf32(x), _tf32(w)) - plain)
                    .abs().max())
        for m in (5, 40):
            check(torch.equal(by_m[264][:m].view(torch.int32),
                              by_m[m].view(torch.int32)),
                  f"{label}: rows at M=264 differ from M={m}")
    for name, c in controls.items():
        check(c > MATMUL_ATOL, f"control {name} errs by {c} <= "
              f"{MATMUL_ATOL}: the tolerance would not catch it")
    head = _head_rows(gen, flush)
    host_us = _host_us_per_call(codec_obj, gen)
    log(f"matmul host time a call (llama wk, M={BATCH}, 200 calls, one "
        f"synchronize): {host_us}")
    resources = {"ptxas": _ptxas_resources(), "plans": plans,
                 "host_us_per_call": host_us}
    for kind, line in resources["ptxas"].items():
        log(f"matmul ptxas {kind}: {line}")
    for kind, pl in plans.items():
        log(f"matmul plan {kind}: {pl}")
    t = totals[("llama3_2_1b", BATCH)]
    log(f"matmul: {len(rows)} shape/M cases, fused == dense-tile (row-major "
        f"and transposed) bitwise, rows independent of M, max |fused - "
        f"plain| {max_err:.3g}, |dense-tile - plain| {max_err_dense:.3g}, "
        f"|fused - torch.matmul| {max_err_lib:.3g} <= {MATMUL_ATOL}; "
        f"controls (must exceed it) {controls}")
    for (model, m), tt in totals.items():
        log(f"matmul one {model} layer's 7 leaves at M={m} (ms [spin "
            f"window]): fused {tt['fused']:.4f} [{tt['fused_dev']:.4f}] "
            f"(bound {tt['fused_bound']:.4f}), dense-tile {tt['dense']:.4f} "
            f"[{tt['dense_dev']:.4f}] / transposed {tt['dense_t']:.4f} "
            f"[{tt['dense_t_dev']:.4f}] (bound {tt['dense_bound']:.4f}), "
            f"torch.matmul {tt['library']:.4f} [{tt['library_dev']:.4f}]")
    RESULTS["matmul"] = {"rows": rows, "totals_m_batch": t,
                         "totals": {f"{mo} M={m}": tt
                                    for (mo, m), tt in totals.items()},
                         "max_abs_err": max_err,
                         "max_abs_err_dense": max_err_dense,
                         "max_abs_err_matmul": max_err_lib,
                         "atol": MATMUL_ATOL, "controls": controls,
                         "resources": resources, "head": head}
    del flush_buf
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------

def _smoke_against_cpu():
    """Smoke-size model: the card's kernels against the plain CPU path on
    the same weights and prompts."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.lm import init_params
    from repro_torch.runtime.streaming import assign_weight_modes, \
        tree_map_with_path
    cfg = get_smoke_config("llama3_2_1b")
    model = build_model(cfg)
    params = init_params(cfg, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(3))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map_with_path(lambda _, t: t.to(dev), params)
        tree = assign_weight_modes(p, mode="fused", min_bytes=1024, shards=2)
        logits, cache = model.prefill_fn(tree, {"tokens": prompts.to(dev)},
                                         20)
        toks, seq = [torch.argmax(logits, -1)], [logits]
        for _ in range(6):
            logits, cache = model.decode_fn(tree, cache, toks[-1])
            toks.append(torch.argmax(logits, -1))
            seq.append(logits)
        outs[dev] = (torch.stack(toks).cpu(), torch.stack(seq).cpu())
    err = float((outs["cpu"][1] - outs["cuda"][1]).abs().max())
    check(torch.equal(outs["cpu"][0], outs["cuda"][0]),
          "smoke greedy tokens differ between the card and the CPU path")
    check(err <= 2.0 ** -8, f"smoke logits card vs CPU differ by {err}")
    log(f"smoke llama3_2_1b fused, card vs plain CPU path: tokens equal, "
        f"max |logit diff| {err:.3g}")
    return err


def phase_serve():
    import torch
    from repro_torch.launch import serve
    card = card_line()
    smoke_err = _smoke_against_cpu()
    runs = {}
    for mode in ("fused", "stream", "dense"):
        serve.reset_launch_counts()      # this path's run starts here ...
        out = serve.main(["--batch", str(BATCH), "--prompt-len", str(PROMPT),
                          "--tokens", str(TOKENS), "--mode", mode])
        out["path_launches"] = serve.launch_counts()    # ... and ends here
        runs[mode] = out
        torch.cuda.empty_cache()
    ref = runs["fused"]
    vocab = 128256
    check(tuple(ref["logits"].shape) == (TOKENS, BATCH, vocab),
          f"logits shape {tuple(ref['logits'].shape)}")
    check(bool(torch.isfinite(ref["logits"]).all()), "non-finite logits")
    for mode in ("stream", "dense"):
        check(torch.equal(runs[mode]["tokens"], ref["tokens"]),
              f"{mode} greedy tokens differ from fused")
        check(torch.equal(runs[mode]["logits"].view(torch.int32),
                          ref["logits"].view(torch.int32)),
              f"{mode} logits not bitwise equal to fused")
    for mode, out in runs.items():
        step = out["step_launches"][0]
        want = run_step_launches("llama3_2_1b", mode, out)
        _check_overlap_schedule(f"serve {mode}", mode, out)
        _check_engine_run(f"serve {mode}", out, want)
        for name, n in want.items():
            check(n == 0 or out["path_launches"][name] > 0,
                  f"{mode}: kernel {name} was never launched in its run")
        # set-up compresses on the card: one encode launch per bucket of
        # its encode plans, none in dense mode
        enc = out["path_launches"]["enec_encode"]
        check(enc == out["encode_dispatches"] == out["encode_buckets"],
              f"{mode}: {enc} encode launches, set-up reports "
              f"{out['encode_dispatches']} dispatches of "
              f"{out['encode_buckets']} buckets")
        check((enc > 0) == (mode != "dense"),
              f"{mode}: {enc} encode launches in set-up")
        log(f"serve {mode}: set-up {out['setup_s']:.3f} s "
            f"({out['encode_buckets']} encode buckets), TTFT "
            f"{out['ttft_s'] * 1e3:.2f} ms, TPOT {out['tpot_s'] * 1e3:.2f} "
            f"ms (captured step; device {out['step_device_ms']:.3f} ms a "
            f"replay; captures {_capture_ms(out)} ms), "
            f"{out['tok_s']:.2f} tok/s, wire ratio "
            f"{out['wire_ratio']:.4f}, hbm ratio "
            f"{out['stream_stats']['hbm_ratio']:.4f}, launches/step {step}, "
            f"launches in this run {out['path_launches']}, mode_mix "
            f"{out['mode_mix']} on {card}")
    launches = {m: o["path_launches"] for m, o in runs.items()}
    # phase mesh holds its ranks against these runs' first requests and
    # steps (a row's bits do not depend on the batch or on max_len)
    for mode in ("fused", "stream"):
        SERVE_REFS[mode] = {
            "logits": runs[mode]["logits"][:MESH_TOKENS, :MESH_BATCH].cpu(),
            "step_launches": runs[mode]["step_launches"][0]}
    log(f"serve: fused/stream/dense tokens equal, logits bitwise equal; "
        f"seq0 {ref['tokens'][0].tolist()}")
    RESULTS["serve"] = {
        "card": card, "smoke_max_err": smoke_err,
        "modes": {m: {k: o[k] for k in ("ttft_s", "tpot_s", "tok_s",
                                        "step_device_ms", "setup_s",
                                        "wire_ratio", "encode_buckets",
                                        "path_launches", "prefill_launches",
                                        "mode_mix", "step_s",
                                        "step_device_ms_all",
                                        "step_buckets", "capture_s")}
                  | {"step_launches": o["step_launches"][0],
                     "hbm_ratio": o["stream_stats"]["hbm_ratio"]}
                  for m, o in runs.items()}}
    return launches, runs["fused"]


def _check_overlap_schedule(label, mode, out):
    """The default ``--overlap auto`` prefetches exactly in stream mode,
    where every one of a layer's 7 matmul leaves is a streamed slot and a
    layer's batched decode takes at most one launch per leaf."""
    ov = out["overlap"]
    check(ov["mode"] == "auto" and ov["enabled"] == (mode == "stream"),
          f"{label}: overlap {ov}")
    if ov["enabled"]:
        check(ov["slots"] == len(LEAVES)
              == out["stream_stats"]["overlap_eligible_tensors"]
              and 1 <= ov["buckets_per_layer"] <= len(LEAVES),
              f"{label}: prefetch schedule {ov}, stream_stats "
              f"{out['stream_stats']}")


def _capture_ms(out) -> dict:
    return {b: round(t * 1e3, 2) for b, t in out["capture_s"].items()}


def _check_engine_run(label, out, want_step):
    """A ``serve.main`` run through the engine: each decode step's
    launches (a graph replay's, by the count its capture took) and each
    bucket's warm-up equal one step's launches as read from the code; the
    run launched the prefills', the steps' and the warm-ups' kernels and
    nothing else; buckets within {1, 2, 4}, each captured once and
    replayed by every step; a device time for every replay."""
    steps, warm = out["step_launches"], out["warmup_launches"]
    check(steps and all(st == want_step for st in steps),
          f"{label}: launches a decode step {steps[:2]} != {want_step}")
    check(all(w == want_step for w in warm.values()),
          f"{label}: warm-up launches {warm} != one step's {want_step}")
    run = {k: out["prefill_launches"][k] + sum(st[k] for st in steps)
           + sum(w[k] for w in warm.values()) for k in KERNELS}
    check(run == out["launches"], f"{label}: the run launched "
          f"{out['launches']}, prefills + steps + warm-ups {run}")
    buckets = out["engine"]["engine"]["compiled_buckets"]
    check(set(buckets) <= {1, 2, 4} and buckets == sorted(warm),
          f"{label}: buckets {buckets}, warm-ups {sorted(warm)}")
    check(all(ms is not None and ms > 0
              for ms in out["step_device_ms_all"]),
          f"{label}: a replay without a device time")


# ---------------------------------------------------------------------------
# phase 5: checkpoint save -> restore -> serve
# ---------------------------------------------------------------------------

def _leaf_bytes() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.lm import param_shapes
    return {f"params/{path}": math.prod(shape) * 2       # bf16
            for path, shape in param_shapes(get_config("llama3_2_1b")).items()}


def phase_ckpt(fused):
    """``fused`` is phase 4's fused run: the restored run must repeat it
    bit for bit."""
    import shutil
    import tempfile

    import torch
    from repro_torch.launch import serve
    args = ["--batch", str(BATCH), "--prompt-len", str(PROMPT), "--tokens",
            str(TOKENS), "--mode", "fused", "--min-bytes", str(MIN_BYTES)]
    ck = tempfile.mkdtemp(prefix="enec-ckpt-")
    launches, runs = {}, {}
    try:
        for path, extra in (("ckpt_save", ["--save-ckpt", ck]),
                            ("ckpt_restore", ["--ckpt", ck])):
            serve.reset_launch_counts()      # this path's run starts here ...
            out = serve.main(args + extra)
            launches[path] = serve.launch_counts()   # ... and ends here
            runs[path] = out
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    for path, out in runs.items():
        check(torch.equal(out["tokens"], fused["tokens"]),
              f"{path}: greedy tokens differ from the fresh fused run")
        check(torch.equal(out["logits"].view(torch.int32),
                          fused["logits"].view(torch.int32)),
              f"{path}: logits not bitwise equal to the fresh fused run")
        _check_engine_run(path, out,
                          run_step_launches("llama3_2_1b", "fused", out))
    save, restore = runs["ckpt_save"]["save"], runs["ckpt_restore"]["restore"]
    sizes = _leaf_bytes()
    big = [n for n in restore["dense_records"] if sizes[n] >= MIN_BYTES]
    check(not big, f"restore moved leaves of >= {MIN_BYTES} bytes host to "
          f"device as dense bytes: {big}")
    check(restore["h2d_dense_bytes"] == sum(
        sizes[n] for n in restore["dense_records"]),
        f"h2d dense bytes {restore['h2d_dense_bytes']} are not those of "
        f"the small dense records {restore['dense_records']}")
    check(restore["decode_dispatches"] == restore["plan_buckets"],
          f"restore: {restore['decode_dispatches']} decode dispatches, "
          f"{restore['plan_buckets']} plan buckets")
    for path, out in runs.items():
        check(launches[path]["enec_encode"] == out["encode_dispatches"],
              f"{path}: {launches[path]['enec_encode']} encode launches, "
              f"the codec counts {out['encode_dispatches']}")
    log(f"ckpt fused full width: save {save['seconds']:.3f} s "
        f"({save['records']} records, {save['bytes_on_disk']} bytes on "
        f"disk, manifest ratio {save['ratio']:.4f}), restore "
        f"{restore['seconds']:.3f} s (h2d "
        f"{restore['h2d_compressed_bytes'] / 1e6:.3f} MB compressed, "
        f"{restore['h2d_dense_bytes'] / 1e6:.6f} MB dense in "
        f"{len(restore['dense_records'])} records < {MIN_BYTES} bytes; "
        f"{restore['decode_dispatches']} decode dispatches == "
        f"{restore['plan_buckets']} plan buckets); restored tokens and "
        f"logits bitwise equal to the fresh fused run; launches "
        f"{launches} on {card_line()}")
    RESULTS["ckpt"] = {"save": save, "restore": restore,
                       "setup_s": {p: o["setup_s"] for p, o in runs.items()},
                       "launches": launches}
    return launches


# ---------------------------------------------------------------------------
# phase scan: the standalone prefix-sum kernel
# ---------------------------------------------------------------------------

def _int_err(a, b) -> int:
    import torch
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0


def phase_scan():
    """Kernel 3 through its entry point ``ops.idd_scan``, bitwise against
    ``torch.cumsum`` and the plain version, in both branches of its plan
    (warp rows: the reference test's shapes, bool input, the embed's
    (16032, 1024), rows of 4096, 32 x SMs rows of 8320; look-back: the
    (8, 2**20) long rows of full-range values, a ragged last tile in
    int32 and in bool); the look-back again after the timed runs (the
    status words' epochs and the ticket reset); timed at the embed's and
    the long rows' shapes."""
    import importlib
    import torch
    from repro_torch.kernels import ops
    scan_mod = importlib.import_module("repro_torch.kernels.idd_scan")
    from repro_torch.launch import serve
    gen = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def bits(shape):
        return torch.rand(shape, generator=gen, device="cuda") < 0.3

    def full_range(shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             device="cuda", dtype=torch.int32)

    cases = [(f"{shape} int32", bits(shape).to(torch.int32))
             for shape in SCAN_SHAPES]
    cases += [("(3, 2048) bool", bits((3, 2048))),
              ("(64, 4096) int32", full_range((64, 4096))),
              (f"({32 * sms}, 8320) int32", full_range((32 * sms, 8320))),
              ("(3, 24704) bool", bits((3, 3 * 8192 + 128))),
              ("(2, 24704) int32", full_range((2, 3 * 8192 + 128))),
              (f"{SCAN_EMBED} int32", bits(SCAN_EMBED).to(torch.int32)),
              # full-range values: the sums wrap mod 2**32 many times
              (f"{SCAN_LONG} int32", full_range(SCAN_LONG))]
    serve.reset_launch_counts()          # this path's run starts here ...
    got = [ops.idd_scan(x) for _, x in cases]
    torch.cuda.synchronize()
    launches = serve.launch_counts()     # ... and ends here
    max_err, branches = 0, {}
    for (label, x), out in zip(cases, got):
        want = torch.cumsum(x.to(torch.int32), -1, dtype=torch.int32)
        check(out.dtype == torch.int32 and torch.equal(out, want),
              f"scan kernel != torch.cumsum ({label})")
        check(torch.equal(out, scan_mod.idd_scan_plain(x)),
              f"scan kernel != plain ({label})")
        max_err = max(max_err, _int_err(out, want))
        p = scan_mod.plan(*x.shape, x.dtype == torch.bool, sms)
        branches[label] = {"lookback": p.lookback, "grid": p.grid,
                           "tiles_per_row": p.tiles_per_row}
    check(launches["idd_scan"] == len(cases),
          f"{launches['idd_scan']} scan launches for {len(cases)} calls")
    check({b["lookback"] for b in branches.values()} == {False, True},
          f"the scan cases do not reach both branches: {branches}")
    check(branches[f"{SCAN_LONG} int32"]["grid"] > SCAN_LONG[0],
          f"the long rows ran on {branches[f'{SCAN_LONG} int32']['grid']} "
          f"CTAs")
    log(f"scan: {len(cases)} cases bitwise equal to torch.cumsum and the "
        f"plain version; plans {branches}; launches {launches}")
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timed = {}
    for label, x in cases[-2:]:
        row = {"ms": cuda_ms(lambda: scan_mod.idd_scan_cuda(x), 20,
                             flush_buf.zero_),
               "plain_ms": cuda_ms(lambda: scan_mod.idd_scan_plain(x), 20,
                                   flush_buf.zero_),
               "library_ms": cuda_ms(lambda: torch.cumsum(
                   x, -1, dtype=torch.int32), 20, flush_buf.zero_),
               "bound_ms": x.numel() * (x.element_size() + 4)
               / HBM_BYTES_PER_S * 1e3, "plan": branches[label],
               # the device's work alone (a spin kernel ahead of the window)
               "dev_ms": cuda_ms(lambda: scan_mod.idd_scan_cuda(x), 20,
                                 flush_buf.zero_, spin=True),
               "library_dev_ms": cuda_ms(lambda: torch.cumsum(
                   x, -1, dtype=torch.int32), 20, flush_buf.zero_,
                   spin=True)}
        timed[label] = row
        log(f"scan {label}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, torch.cumsum {row['library_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms, "
            f"{row['bound_ms'] / row['ms']:.3f} of bound; spin window: kernel "
            f"{row['dev_ms']:.4f} ms, torch.cumsum "
            f"{row['library_dev_ms']:.4f} ms; plan {row['plan']}")
    # after the timed launches (new epochs on the same status words)
    for label, x in cases[-4:]:
        check(torch.equal(scan_mod.idd_scan_cuda(x), torch.cumsum(
            x.to(torch.int32), -1, dtype=torch.int32)),
            f"scan kernel != torch.cumsum after the timed runs ({label})")
    resources = _ptxas_resources("idd_scan", {
        "scan_rows_kernelIiE": "rows int32", "scan_rows_kernelIhE":
        "rows bool", "scan_lookback_kernelIiE": "lookback int32",
        "scan_lookback_kernelIhE": "lookback bool"})
    for kind, line in resources.items():
        log(f"scan ptxas {kind}: {line}")
    RESULTS["scan"] = {"cases": [label for label, _ in cases],
                       "max_abs_err": max_err, "timed": timed,
                       "plans": branches, "resources": resources,
                       "row_shape": f"{SCAN_EMBED} int32"}
    del cases, got, flush_buf
    torch.cuda.empty_cache()
    return {"scan": launches}


# ---------------------------------------------------------------------------
# phase kv_attention: decode attention over an ENEC-compressed KV prefix
# ---------------------------------------------------------------------------

def _kv_case(shape, gen, m_equals_n=False, group=None):
    """Seeded bf16 q, K, V (normal x 0.3, as the reference test makes them)
    and params searched over K and V together (or m == n over their
    exponent range; or the searched ones with group length ``group``)."""
    import torch
    from repro_torch.core import params, stats
    from repro_torch.core.dtypes import BF16
    from repro_torch.core.params import EnecParams
    b, s, kv, grp = shape

    def t(dims):
        return (torch.randn(dims, generator=gen, device="cuda") * 0.3).to(
            torch.bfloat16)

    k, v, q = t((b, s, kv, 128)), t((b, s, kv, 128)), t((b, kv, grp, 128))
    both = torch.cat([k.reshape(-1), v.reshape(-1)]).view(torch.int16)
    st = stats.stack_stats(both.reshape(1, -1), BF16)
    del both
    lo, hi = st.bounds()
    if m_equals_n:
        width = (hi - lo).bit_length() + 1
        p = EnecParams(b=hi, n=width, m=width, L=16, l=lo)
    else:
        p = params.widen_for_range(
            params.search(st.hist, BF16, block_elems=128 * 128), lo, hi)
    if group is not None:
        p = EnecParams(b=p.b, n=p.n, m=p.m, L=group, l=p.l)
    return q, k, v, p


def _dense_attention(q, k, v):
    """Decompress-then-attend: the plain einsum softmax of the reference
    test's ``_dense`` on dense K/V (B, S, KV, 128)."""
    import torch
    scores = torch.einsum("bkgh,bskh->bkgs", q.float(), k.float()) \
        / math.sqrt(k.shape[-1])
    return torch.einsum("bkgs,bskh->bkgh", torch.softmax(scores, -1),
                        v.float())


def _kv_tiles(kv):
    """(B, S, KV, 128) -> the (B * KV * S/128, 16384) bit tiles that
    ``compress_kv_prefix`` encodes."""
    import torch
    return kv.permute(0, 2, 1, 3).reshape(-1, 128 * kv.shape[-1]).view(
        torch.int16)


def _kv_plan_summary(pl) -> dict:
    """How a kernel-5 plan cuts its pairs: pairs held whole by one CTA,
    pairs split across CTAs, the most CTAs sharing one pair, and CTAs
    whose range cuts a pair mid-way."""
    parts = [len(pl.contributors(p)) for p in range(pl.pairs)]
    cuts = sum(1 for a, e in pl.ranges()
               if a % pl.n_chunks or e % pl.n_chunks)
    return {"grid": pl.grid, "whole_pairs": parts.count(1),
            "split_pairs": len(parts) - parts.count(1),
            "max_ctas_a_pair": max(parts), "ctas_cutting_a_pair": cuts}


def phase_kv_attention():
    """Kernel 5 through its entry points ``ops.compress_kv_prefix`` and
    ``ops.decode_attention_kv_enec``: the compressed prefix byte-identical
    to the plain encoder, the attention within tolerance of its plain
    version and of dense attention on the decoded K/V, under the planner's
    grid and under other partitions of the items (one CTA, ranges that cut
    pairs mid-way, one item a CTA); at the two full-width shapes a grid of
    at least one CTA an SM, the bits equal across two calls, and the times
    beside SDPA on the dense K/V."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import codec
    from repro_torch.core.dtypes import BF16
    from repro_torch.kernels import ops
    from repro_torch.kernels import decode_attention_kv as dak
    from repro_torch.kernels.decode_attention_kv import (
        decode_attention_kv_enec_cuda, decode_attention_kv_plain)
    from repro_torch.kernels.enec_decode import decode_blocks_plain
    from repro_torch.kernels.enec_encode import encode_blocks_plain
    from repro_torch.launch import serve
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [(f"grid {shape}", _kv_case(shape, gen)) for shape in KV_GRID]
    cases.append((f"m == n {KV_GRID[1]}", _kv_case(KV_GRID[1], gen, True)))
    # 16 groups a block: a 2-byte mask stream, staged by plain loads (not
    # 16-byte aligned), and a partial mask word in the warps' rank
    cases.append((f"L 1024 {KV_GRID[1]}", _kv_case(KV_GRID[1], gen,
                                                   group=1024)))
    cases.append((f"grp 12 {KV_GRP12}", _kv_case(KV_GRP12, gen)))
    cases += [(f"{name} {shape}", _kv_case(shape, gen))
              for name, shape in KV_FULL.items()]
    serve.reset_launch_counts()          # this path's run starts here ...
    runs, plans = [], []
    for _, (q, k, v, p) in cases:
        ks, vs = ops.compress_kv_prefix(k, p), ops.compress_kv_prefix(v, p)
        runs.append((ks, vs, ops.decode_attention_kv_enec(q, ks, vs, p)))
        plans.append(dak.launch_plan(q, ks, p)[1])
    torch.cuda.synchronize()
    launches = serve.launch_counts()     # ... and ends here
    check(launches["decode_attention_kv"] == len(cases)
          and launches["enec_encode"] == 2 * len(cases),
          f"kv_attention launches {launches} for {len(cases)} cases")
    rows, max_err = {}, 0.0
    for (label, (q, k, v, p)), (ks, vs, out), lp in zip(cases, runs, plans):
        for kv, s in ((k, ks), (v, vs)):
            tiles = _kv_tiles(kv)
            want = encode_blocks_plain(tiles, BF16, p)
            flat = codec.flatten_blocks(s)
            for name in want._fields:
                check(torch.equal(getattr(flat, name), getattr(want, name)),
                      f"compress_kv_prefix != plain encoder in {name} "
                      f"({label})")
            check(torch.equal(decode_blocks_plain(flat, 128 * 128, BF16, p),
                              tiles), f"KV decode is not lossless ({label})")
            del want, flat, tiles
        plain = decode_attention_kv_plain(q, ks, vs, p)
        dense = _dense_attention(q, k, v)
        scale = float(dense.abs().max())
        err_plain = float((out - plain).abs().max())
        err_dense = float((out - dense).abs().max())
        err_plain_dense = float((plain - dense).abs().max())
        for name, a, b in (("kernel - plain", out, plain),
                           ("kernel - dense", out, dense),
                           ("plain - dense", plain, dense)):
            check(torch.allclose(a, b, atol=KV_ATOL, rtol=KV_RTOL),
                  f"{label}: |{name}| {float((a - b).abs().max())} beyond "
                  f"atol {KV_ATOL} / rtol {KV_RTOL}")
            rel = float((a - b).abs().max()) / scale
            check(rel <= KV_REL, f"{label}: |{name}| / max|dense| {rel} > "
                  f"{KV_REL}")
        max_err = max(max_err, err_plain, err_dense)
        b, s, n_kv, hd = k.shape
        grp = q.shape[2]
        lp |= _kv_plan_summary(dak.Plan(b * n_kv, s // 128, grp, lp["grid"]))
        row = {"shape": label, "params": list(p.astuple()),
               "ratio_k": BF16.total_bits * k.numel() / 8
               / needed_bytes(ks), "max_abs_err_plain": err_plain,
               "max_abs_err_dense": err_dense,
               "max_abs_err_plain_dense": err_plain_dense,
               "max_abs_out": scale, "plan": lp}
        # other partitions of the same items (after the main path's run):
        # one CTA, ranges that cut pairs mid-way, one item a CTA
        items = b * n_kv * (s // 128)
        grids = ({1, 3, 5, items} if items <= 64 else {2 * lp["sm_count"]})
        grids.discard(lp["grid"])
        for g in sorted(g for g in grids if g <= items):
            alt = decode_attention_kv_enec_cuda(q, ks, vs, p, grid=g)
            summ = _kv_plan_summary(dak.Plan(b * n_kv, s // 128, grp, g))
            err = float((alt - plain).abs().max())
            check(torch.allclose(alt, plain, atol=KV_ATOL, rtol=KV_RTOL)
                  and err / scale <= KV_REL, f"{label}: grid {g} ({summ}) "
                  f"|kernel - plain| {err} beyond the limits")
            row.setdefault("other_grids", {})[g] = summ | {"max_abs_err": err}
            max_err = max(max_err, err)
        if label.split()[0] in KV_FULL:
            check(lp["grid"] >= lp["sm_count"], f"{label}: grid {lp['grid']} "
                  f"below the {lp['sm_count']} SMs")
            again = decode_attention_kv_enec_cuda(q, ks, vs, p)
            check(torch.equal(again.view(torch.int32), out.view(torch.int32)),
                  f"{label}: two calls differ in their bits")
            del again
            c = ks.mask.shape[2]
            control = float((_dense_attention(q, k[:, :-128], v[:, :-128])
                             - dense).abs().max()) / scale
            check(control > KV_REL, f"{label}: dropping the last of {c} "
                  f"chunks moves the output by {control} <= {KV_REL}: the "
                  f"relative limit would not catch it")
            row["control_rel_err_without_last_chunk"] = control
            flush_buf = torch.empty(256 << 20, dtype=torch.uint8,
                                    device="cuda")
            row["ms"] = cuda_ms(lambda: decode_attention_kv_enec_cuda(
                q, ks, vs, p), 5, flush_buf.zero_)
            row["plain_ms"] = cuda_ms(lambda: decode_attention_kv_plain(
                q, ks, vs, p), 2, flush_buf.zero_)
            q4 = q.reshape(b, n_kv * grp, 1, hd)
            k4 = k.permute(0, 2, 1, 3).contiguous()
            v4 = v.permute(0, 2, 1, 3).contiguous()
            sdpa = F.scaled_dot_product_attention(q4, k4, v4,
                                                  enable_gqa=True)
            row["library_rel_err"] = float(
                (sdpa.float().reshape(out.shape) - dense).abs().max()) / scale
            row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                       enable_gqa=True),
                5, flush_buf.zero_)
            row["dev_ms"] = cuda_ms(lambda: decode_attention_kv_enec_cuda(
                q, ks, vs, p), 5, flush_buf.zero_, spin=True)
            row["library_dev_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                       enable_gqa=True),
                5, flush_buf.zero_, spin=True)
            in_bytes = (needed_bytes(ks) + needed_bytes(vs)
                        + q.numel() * q.element_size())
            out_bytes = out.numel() * out.element_size()
            bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
            # scores and p @ V: 2 FMAs per (query, token, dim), f32 FMA
            flops_ms = 4 * b * n_kv * grp * s * hd / F32_FLOPS * 1e3
            row.update(bytes=in_bytes + out_bytes, bytes_ms=bytes_ms,
                       flops_ms=flops_ms, bound_ms=max(bytes_ms, flops_ms),
                       bound_by="bytes" if bytes_ms >= flops_ms
                       else "operations",
                       dense_bytes=2 * k.numel() * k.element_size())
            log(f"kv_attention {label}: kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, SDPA on dense bf16 K/V "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}; {in_bytes + out_bytes} bytes, K "
                f"ratio {row['ratio_k']:.4f}), {row['bound_ms'] / row['ms']:.4f}"
                f" of bound; spin window: kernel {row['dev_ms']:.4f} ms, SDPA "
                f"{row['library_dev_ms']:.4f} ms; control {control:.3g}; plan "
                f"{lp}")
            del q4, k4, v4, sdpa, flush_buf
        rows[label] = row
        del plain, dense
    log(f"kv_attention: {len(cases)} cases, compressed prefix byte-identical "
        f"to the plain encoder, kernel within atol {KV_ATOL} / rtol "
        f"{KV_RTOL} and {KV_REL} relative of plain and dense attention at "
        f"every grid, the full-width calls bitwise equal across two calls, "
        f"max |err| {max_err:.3g}; launches {launches}")
    resources = _ptxas_resources("decode_attention_kv", {
        "decode_attention_kv_kernelILi1E": "grp <= 8",
        "decode_attention_kv_kernelILi2E": "grp 9..16"})
    for kind, line in resources.items():
        log(f"kv_attention ptxas {kind}: {line}")
    RESULTS["kv_attention"] = {"rows": rows, "max_abs_err": max_err,
                               "atol": KV_ATOL, "rtol": KV_RTOL,
                               "rel": KV_REL, "resources": resources}
    del cases, runs
    torch.cuda.empty_cache()
    return {"kv_attention": launches}


# ---------------------------------------------------------------------------
# phase engine: the continuous-batching engine, its step a CUDA graph
# ---------------------------------------------------------------------------

def _prompts(vocab: int):
    """``serve.main``'s prompts: (BATCH, PROMPT) from seed 1."""
    import torch
    gen = torch.Generator().manual_seed(1)
    return torch.randint(0, vocab, (BATCH, PROMPT), generator=gen).numpy()


def _sync_s(t0: float) -> float:
    import torch
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def one_shot_alone(model, params, prompt, max_len: int):
    """The eager one-shot loop for one request served alone: a batch-1
    prefill, then ``decode_fn`` and argmax for each further token.
    Returns the logits of each token and the host seconds of each decode
    step (to its token on the host)."""
    import torch
    tok_in = torch.as_tensor(prompt, dtype=torch.int64,
                             device="cuda")[None, :]
    logits, cache = model.prefill_fn(params, {"tokens": tok_in}, max_len)
    tok = torch.argmax(logits, -1)
    outs, secs = [logits[0]], []
    for _ in range(TOKENS - 1):
        t0 = time.perf_counter()
        logits, cache = model.decode_fn(params, cache, tok)
        tok = torch.argmax(logits, -1)
        tok.tolist()
        secs.append(time.perf_counter() - t0)
        outs.append(logits[0])
    return outs, secs


def eager_bucket_loop(model, params, prompts, max_len: int):
    """The engine's step without the graph: each prompt prefilled alone
    into its slot of a ring of ``len(prompts)`` slots, then
    ``lm.decode_step`` run eagerly on the whole bucket.  Returns each
    slot's logits per token and the host seconds of each step."""
    import torch
    n = len(prompts)
    state = model.init_step_state(n, max_len, device="cuda")
    outs = [[] for _ in range(n)]
    for slot, prompt in enumerate(prompts):
        tok_in = torch.as_tensor(prompt, dtype=torch.int64,
                                 device="cuda")[None, :]
        logits, cache = model.prefill_fn(params, {"tokens": tok_in},
                                         max_len)
        for ring, part in zip(state["entries"], cache["entries"]):
            for k, t in part.items():     # K/V and recurrent states
                ring[k][:, slot].copy_(t[:, 0])
        state["tokens"][slot] = torch.argmax(logits[0], -1)
        state["lengths"][slot] = len(prompt)
        outs[slot].append(logits[0])
    secs = []
    for _ in range(TOKENS - 1):
        t0 = time.perf_counter()
        model.decode_step(params, state, n)
        state["tokens"].tolist()
        secs.append(time.perf_counter() - t0)
        for slot in range(n):
            outs[slot].append(state["logits"][slot].clone())
    return outs, secs


def _bits_equal(a, b) -> bool:
    import torch
    return len(a) == len(b) and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(a, b))


def _capture_guards() -> dict:
    """Host state a replay would not renew is refused inside a capture:
    kernel 3 (its look-back epoch is a host argument) and kernel 2's
    arrival counters on a stream that has none yet."""
    import importlib
    import torch
    from repro_torch.kernels import ops
    dm = importlib.import_module("repro_torch.kernels.decompress_matmul")
    out = {}
    x = torch.randint(0, 9, (4, 1024), dtype=torch.int32, device="cuda")
    a = torch.randn((4, 256), device="cuda").bfloat16()
    w = torch.randn((256, 256), device="cuda").bfloat16()
    ops.idd_scan(x)
    ops.tiled_matmul(a, w)
    torch.cuda.synchronize()

    def new_stream():
        # PyTorch hands out streams from a pool of 32 a priority, round
        # robin: after the earlier phases' captures a "new" one may be a
        # stream kernel 2 has run on, whose counters exist
        for priority in (0, -1):
            for _ in range(64):
                stream = torch.cuda.Stream(priority=priority)
                if all(k[1] != stream.cuda_stream for k in dm._COUNTERS):
                    return stream
        fail("engine: every pooled CUDA stream has kernel 2's counters")

    for name, fn in (("idd_scan", lambda: ops.idd_scan(x)),
                     ("matmul_counters", lambda: ops.tiled_matmul(a, w))):
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=new_stream()):
                fn()
        except RuntimeError as e:
            check("capture" in str(e), f"{name}: refused with {e}")
            out[name] = str(e)
        else:
            fail(f"{name}: ran inside a CUDA graph capture")
        torch.cuda.synchronize()
    log(f"engine: inside a capture, kernel 3 and kernel 2's first arrival "
        f"counters on a new stream refuse: {out}")
    return out


# kernel groups of a captured step's profile, by the kernel's name
PROFILE_GROUPS = (("kernel 2 fused", "matmul_kernel<true"),
                  ("kernel 2' dense-tile", "matmul_kernel<false"),
                  ("kernel 1 decode", "decode_"))


def _replay_profile(engine, replays: int = 5) -> dict:
    """Device time of a captured step by kernel group, from a
    ``torch.profiler`` trace of ``replays`` replays of the engine's
    largest bucket (the last requests' inputs; freed slots decode at
    length 0): each group's ms a step, the step's kernel count and the
    rest ("other", PyTorch's own kernels).  "not measured" when the trace
    holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    bucket = max(engine.captured.graphs)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(replays):
                engine.captured.run(bucket, engine._load)
            torch.cuda.synchronize()
    except RuntimeError as e:
        return {"not measured": str(e)}
    groups = dict.fromkeys([g for g, _ in PROFILE_GROUPS] + ["other"], 0.0)
    kernels = 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0:
            continue
        kernels += ev.count
        group = next((g for g, key in PROFILE_GROUPS if key in ev.key),
                     "other")
        groups[group] += us / 1e3 / replays
    if kernels == 0:
        return {"not measured": "the trace holds no device time"}
    return {"bucket": bucket, "ms": groups,
            "total_ms": sum(groups.values()),
            "kernels_per_step": kernels / replays}


def _engine_case(arch: str, mode: str, staggered: bool) -> dict:
    """One model and mode at full width through ``runtime/engine.py``:
    (a) each of 4 requests' logits, served together (bucket 4), bitwise
    equal to the request served alone by the eager one-shot loop; (b) with
    ``staggered``, request 0 alone for two steps, then 1, then 2 and 3
    (buckets 1, 2, 4 all captured and replayed), (a) again; (c) the
    bucket-4 replays bitwise equal to the eager bucket-4 loop; (d) each
    step's launches, by the replay's count, equal one step's launches read
    from the code; (e) the captured buckets within {1, 2, 4}; (f) TPOT of
    the eager loops and of the captured engine, and the device ms a
    replay (CUDA events around it), in this one run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.codec_api import Codec, use_codec
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.overlap import build_schedule
    from repro_torch.runtime.streaming import assign_weight_modes
    cfg = get_config(arch)
    model = build_model(cfg)
    codec = Codec()
    label = f"engine {arch} {mode}"
    with use_codec(codec):
        params = assign_weight_modes(
            model.init(seed=0, device="cuda"), mode=mode,
            min_bytes=MIN_BYTES, shards=2, codec=codec)
        # stream mode prefetches (cfg.overlap "auto"): a layer's decode
        # launches are its schedule's buckets
        bpl = (build_schedule(params["period"], cfg.n_layers)
               .buckets_per_layer if mode == "stream" else None)
        want_step = step_launches(cfg.n_layers, FLAT[arch], bpl)[mode]
        prompts = _prompts(cfg.vocab_size)
        ecfg = EngineConfig(max_slots=BATCH, queue_depth=2 * BATCH,
                            max_prompt_len=PROMPT, max_new_tokens=TOKENS,
                            collect_logits=True)
        alone = [one_shot_alone(model, params, p, ecfg.max_len)
                 for p in prompts]
        bucket_outs, bucket_secs = eager_bucket_loop(model, params, prompts,
                                                     ecfg.max_len)
        runs = {}
        schedules = {"together": [(0, range(BATCH))]}
        if staggered:
            schedules["staggered"] = [(0, [0]), (2, [1]), (2, [2, 3])]
        for name, schedule in schedules.items():
            engine = Engine(model, params, ecfg, codec=codec)
            serve.reset_launch_counts()      # this run starts here ...
            reqs = []
            for steps_before, idx in schedule:
                for _ in range(steps_before):
                    engine.step()
                reqs += [engine.submit(prompts[i], TOKENS, name=f"r{i}")
                         for i in idx]
            engine.run_until_idle()
            runs[name] = (engine, reqs, serve.launch_counts())   # ... ends
    for name, (engine, reqs, counts) in runs.items():
        for i, req in enumerate(reqs):
            check(req.state == "done", f"{label} {name}: r{i} {req.state}")
            check(_bits_equal(req.logits, alone[i][0]),
                  f"{label} {name}: r{i} logits differ from the request "
                  f"served alone by the eager one-shot loop")
        check(all(st == want_step for st in engine.step_launches),
              f"{label} {name}: step launches {engine.step_launches[:2]} "
              f"!= {want_step}")
        check(all(w == want_step
                  for w in engine.captured.warmup_launches.values()),
              f"{label} {name}: warm-up launches != one step's")
        run = {k: engine.prefill_launches[k]
               + sum(st[k] for st in engine.step_launches)
               + sum(w[k] for w in engine.captured.warmup_launches.values())
               for k in KERNELS}
        check(run == counts, f"{label} {name}: launched {counts}, "
              f"prefills + steps + warm-ups {run}")
        buckets = engine.stats()["engine"]["compiled_buckets"]
        check(set(buckets) <= {1, 2, 4}, f"{label}: buckets {buckets}")
        check(all(b in buckets for b in engine.step_buckets),
              f"{label} {name}: a step ran a bucket it did not capture")
    engine, reqs, _ = runs["together"]
    check(engine.stats()["engine"]["compiled_buckets"] == [BATCH],
          f"{label}: together captured "
          f"{engine.stats()['engine']['compiled_buckets']}")
    for i, req in enumerate(reqs):
        check(_bits_equal(req.logits, bucket_outs[i]),
              f"{label}: r{i}'s bucket-{BATCH} replays differ from the "
              f"eager bucket-{BATCH} loop")
    if staggered:
        st_engine = runs["staggered"][0]
        check(st_engine.stats()["engine"]["compiled_buckets"] == [1, 2, 4],
              f"{label}: staggered captured "
              f"{st_engine.stats()['engine']['compiled_buckets']}")
        for b in (1, 2, 4):
            check(sum(1 for x in st_engine.step_buckets if x == b) >= 2,
                  f"{label}: bucket {b} replayed fewer than twice")

    def steady(eng):
        return [(t, ms) for t, ms, c in zip(eng.step_times_s,
                                            eng.step_device_ms,
                                            eng.step_captured) if not c]

    res = {}
    for name, (eng, reqs, counts) in runs.items():
        rows = steady(eng)
        res[name] = {
            "tpot_ms": 1e3 * sum(t for t, _ in rows) / len(rows),
            "device_ms": sum(ms for _, ms in rows) / len(rows),
            "step_ms": [1e3 * t for t in eng.step_times_s],
            "step_device_ms": eng.step_device_ms,
            "step_buckets": eng.step_buckets,
            "capture_ms": {b: 1e3 * t
                           for b, t in eng.captured.capture_s.items()},
            "ttft_ms": 1e3 * sum(r.ttft_s() for r in reqs) / len(reqs),
            "launches_per_step": eng.step_launches[0], "launches": counts,
            "compiled_buckets": eng.stats()["engine"]["compiled_buckets"]}
    res["profile"] = _replay_profile(runs["together"][0])
    res["eager_bucket_tpot_ms"] = 1e3 * sum(bucket_secs) / len(bucket_secs)
    res["eager_alone_tpot_ms"] = 1e3 * sum(
        sum(secs) for _, secs in alone) / sum(len(s) for _, s in alone)
    res["device_share"] = (res["together"]["device_ms"]
                           / res["together"]["tpot_ms"])
    log(f"{label}: (a) {BATCH} requests bitwise equal to each served alone "
        f"by the eager one-shot loop"
        + (", (b) and under the staggered join (buckets 1, 2, 4 captured "
           "and replayed)" if staggered else "")
        + f", (c) bucket-{BATCH} replays bitwise equal to the eager "
        f"bucket-{BATCH} loop, (d) launches a step "
        f"{res['together']['launches_per_step']} by the replay accounting, "
        f"(e) buckets {res['together']['compiled_buckets']}"
        + (f" / {res['staggered']['compiled_buckets']}" if staggered else "")
        + f"; (f) TPOT eager alone {res['eager_alone_tpot_ms']:.3f}, eager "
        f"bucket-{BATCH} {res['eager_bucket_tpot_ms']:.3f}, captured "
        f"{res['together']['tpot_ms']:.3f} ms, device "
        f"{res['together']['device_ms']:.3f} ms a replay (busy share "
        f"{res['device_share']:.3f}), captures "
        f"{res['together']['capture_ms']} ms; a replay's profile "
        f"{res['profile']} on {card_line()}")
    del runs, params, alone, bucket_outs
    torch.cuda.empty_cache()
    return res


def phase_engine():
    """The engine on full-width llama3_2_1b in fused, stream and dense
    modes (4 requests x prompt 64 x 16 new tokens, 4 slots; staggered
    joins too) and on minitron_4b fused, checks (a)-(f) of
    :func:`_engine_case`, after the capture guards."""
    guards = _capture_guards()
    cases = {f"llama3_2_1b {m}": _engine_case("llama3_2_1b", m, True)
             for m in ("fused", "stream", "dense")}
    cases["minitron_4b fused"] = _engine_case("minitron_4b", "fused", False)
    RESULTS["engine"] = {"card": card_line(), "guards": guards,
                         "cases": cases}
    return {"engine_fused": cases["llama3_2_1b fused"]["together"][
        "launches"]}


# ---------------------------------------------------------------------------
# phase overlap: the decode-prefetch pipeline on a side stream
# ---------------------------------------------------------------------------

def _intervals_ms(spans) -> float:
    """Total length of the union of ``(start, end)`` spans."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _overlapped(spans, others) -> float:
    """Length of ``spans`` (disjoint: kernels of one stream) covered by the
    union of ``others``."""
    merged = []
    for a, b in sorted(others):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = 0.0
    for a, b in spans:
        for c, d in merged:
            if c >= b:
                break
            total += max(0.0, min(b, d) - max(a, c))
    return total


def _overlap_profile(engine, replays: int = 5) -> dict:
    """A ``torch.profiler`` trace of ``replays`` replays of the engine's
    bucket-4 graph, read from its Chrome trace: device ms a replay (first
    kernel start to last kernel end), the kernels' busy share of that span,
    kernel 1's ms a replay, the ms of ``torch.cat`` copies a replay (the
    prefetch's per-block vectors; a bucket's member streams are views),
    the share of kernel 1's time during which another kernel runs (two
    kernels at once are on two streams; the trace's stream ids of a
    graph's kernels are the executor's, not the capture's), and the ms a
    replay of the kernels under each stream id.  "not measured" when the
    trace holds no kernels."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    bucket = max(engine.captured.graphs)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            engine.captured.run(bucket, engine._load)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = json.loads(Path(path).read_text())
    finally:
        os.remove(path)
    kern = [e for e in trace.get("traceEvents", [])
            if e.get("cat") == "kernel" and e.get("ph") == "X"]
    if not kern:
        return {"not measured": "the trace holds no kernels"}
    spans = [(float(e["ts"]) / 1e3, (float(e["ts"]) + float(e["dur"])) / 1e3,
              e.get("args", {}).get("stream", e.get("tid")),
              "decode_lanes" in e["name"] or "decode_generic" in e["name"])
             for e in kern]
    k1 = [(a, b) for a, b, _, is_k1 in spans if is_k1]
    others = [(a, b) for a, b, _, is_k1 in spans if not is_k1]
    by_stream: dict = {}
    for a, b, s, _ in spans:
        by_stream[str(s)] = by_stream.get(str(s), 0.0) + (b - a) / replays
    start = min(a for a, _, _, _ in spans)
    end = max(b for _, b, _, _ in spans)
    k1_ms = sum(b - a for a, b in k1)
    # the prefetch's concatenation of a bucket's member streams
    cat_ms = sum((float(e["dur"]) / 1e3) for e in kern
                 if "CatArray" in e["name"])
    return {"bucket": bucket, "kernels_per_step": len(spans) / replays,
            "cat_ms": cat_ms / replays,
            "span_ms": (end - start) / replays,
            "busy_share": _intervals_ms([(a, b) for a, b, _, _ in spans])
            / (end - start),
            "kernel1_ms": k1_ms / replays,
            "kernel1_launches": len(k1) / replays,
            "kernel1_overlapped_share": (_overlapped(k1, others) / k1_ms
                                         if k1_ms else 0.0),
            "ms_by_stream": by_stream}


def _overlap_case(arch: str) -> dict:
    """One model at full width in stream mode through ``runtime/engine.py``
    with overlap off and on (4 requests x prompt 64 x 16 new tokens, 4
    slots), on one weight tree: (a) each request's logits bitwise equal
    off against on, captured (a staggered join: buckets 1, 2, 4) and
    eager (the one-shot loop alone), and captured equal to alone; (b) each
    replay's and warm-up's kernel-1 launches (and every other kernel's)
    equal one step's read from the code and the schedule; (c) a profile of
    5 bucket-4 replays (``_overlap_profile``); (d) TPOT and device ms of
    the bucket-4 replays, TTFT, peak device GB; (e) ``stream_stats``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.codec_api import Codec, use_codec
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.runtime.engine import Engine, EngineConfig
    from repro_torch.runtime.overlap import build_schedule
    from repro_torch.runtime.streaming import (assign_weight_modes,
                                               stream_stats)
    cfg = get_config(arch)
    label = f"overlap {arch}"
    codec = Codec()
    res = {}
    with use_codec(codec):
        params = assign_weight_modes(
            build_model(cfg).init(seed=0, device="cuda"), mode="stream",
            min_bytes=MIN_BYTES, shards=2, codec=codec)
        stats = stream_stats(params)
        sched = build_schedule(params["period"], cfg.n_layers)
        check(stats["overlap_eligible_tensors"] == len(sched.slots)
              == len(LEAVES) and stats["flat_stream_tensors"] == FLAT[arch],
              f"{label}: stream_stats {stats}, slots {sched.slots}")
        bpl = sched.buckets_per_layer
        prompts = _prompts(cfg.vocab_size)
        ecfg = EngineConfig(max_slots=BATCH, queue_depth=2 * BATCH,
                            max_prompt_len=PROMPT, max_new_tokens=TOKENS,
                            collect_logits=True)
        for ov in ("off", "on"):
            model = build_model(dataclasses.replace(cfg, overlap=ov))
            want = step_launches(cfg.n_layers, FLAT[arch],
                                 bpl if ov == "on" else None)["stream"]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            alone = [one_shot_alone(model, params, p, ecfg.max_len)
                     for p in prompts]
            runs = {}
            for name, schedule in (
                    ("staggered", [(0, [0]), (2, [1]), (2, [2, 3])]),
                    ("together", [(0, range(BATCH))])):
                engine = Engine(model, params, ecfg, codec=codec)
                serve.reset_launch_counts()      # this run starts here ...
                reqs = []
                for steps_before, idx in schedule:
                    for _ in range(steps_before):
                        engine.step()
                    reqs += [engine.submit(prompts[i], TOKENS, name=f"r{i}")
                             for i in idx]
                engine.run_until_idle()
                counts = serve.launch_counts()   # ... and ends here
                for i, req in enumerate(reqs):
                    check(req.state == "done" and _bits_equal(
                        req.logits, alone[i][0]), f"{label} {ov} {name}: "
                        f"r{i} differs from it served alone")
                check(all(st == want for st in engine.step_launches)
                      and all(w == want for w in
                              engine.captured.warmup_launches.values()),
                      f"{label} {ov} {name}: launches a step "
                      f"{engine.step_launches[:1]} != {want}")
                total = {k: engine.prefill_launches[k]
                         + sum(st[k] for st in engine.step_launches)
                         + sum(w[k] for w in
                               engine.captured.warmup_launches.values())
                         for k in KERNELS}
                check(total == counts, f"{label} {ov} {name}: launched "
                      f"{counts}, prefills + steps + warm-ups {total}")
                runs[name] = (engine, reqs, counts)
            check(runs["staggered"][0].stats()["engine"]["compiled_buckets"]
                  == [1, 2, 4], f"{label} {ov}: staggered buckets")
            engine, reqs, counts = runs["together"]
            profile = _overlap_profile(engine)
            peak = torch.cuda.max_memory_allocated() / 1e9
            rows = [(t, ms) for t, ms, c in zip(engine.step_times_s,
                                                engine.step_device_ms,
                                                engine.step_captured)
                    if not c]
            res[ov] = {
                "tpot_ms": 1e3 * sum(t for t, _ in rows) / len(rows),
                "device_ms": sum(ms for _, ms in rows) / len(rows),
                "ttft_ms": 1e3 * sum(r.ttft_s() for r in reqs) / len(reqs),
                "eager_alone_tpot_ms": 1e3 * sum(
                    sum(secs) for _, secs in alone) / sum(
                    len(secs) for _, secs in alone),
                "capture_ms": {b: 1e3 * t for b, t in
                               engine.captured.capture_s.items()},
                "peak_gb": peak, "launches_per_step": want,
                "launches": counts, "profile": profile,
                "logits": {"alone": [o for o, _ in alone],
                           **{n: [r.logits for r in rq]
                              for n, (_, rq, _) in runs.items()}}}
            res[ov]["busy_share"] = res[ov]["device_ms"] / res[ov]["tpot_ms"]
            del runs, engine, reqs, alone
    for key in ("alone", "staggered", "together"):
        for i in range(BATCH):
            check(_bits_equal(res["off"]["logits"][key][i],
                              res["on"]["logits"][key][i]),
                  f"{label}: r{i} {key} differs between overlap off and on")
    for ov in ("off", "on"):
        res[ov].pop("logits")
        p = res[ov]["profile"]
        log(f"{label} {ov}: (a) bitwise equal off/on, captured and eager, "
            f"and to each request alone; (b) launches a step "
            f"{res[ov]['launches_per_step']}; (d) TPOT "
            f"{res[ov]['tpot_ms']:.3f} ms, device {res[ov]['device_ms']:.3f}"
            f" ms a replay (busy {res[ov]['busy_share']:.3f}), TTFT "
            f"{res[ov]['ttft_ms']:.2f} ms, eager alone "
            f"{res[ov]['eager_alone_tpot_ms']:.3f} ms, peak "
            f"{res[ov]['peak_gb']:.2f} GB, captures {res[ov]['capture_ms']}"
            f"; (c) profile {p} on {card_line()}")
    check(res["on"]["profile"].get("kernel1_launches", 0) > 0
          or "not measured" in res["on"]["profile"],
          f"{label}: kernel 1 not in the overlap-on trace")
    res["stream_stats"] = stats
    res["buckets_per_layer"] = bpl
    del params
    torch.cuda.empty_cache()
    return res


def phase_overlap():
    """The decode-prefetch pipeline (``runtime/overlap.py``) on
    llama3_2_1b and minitron_4b at full width in stream mode through the
    engine, overlap off against on in one call: checks (a)-(e) of
    :func:`_overlap_case`.  Returns each case's overlap-on run's launches
    (path ``overlap_<arch>``)."""
    cases = {arch: _overlap_case(arch)
             for arch in ("llama3_2_1b", "minitron_4b")}
    RESULTS["overlap"] = {"card": card_line(), "cases": cases}
    return {f"overlap_{arch}": c["on"]["launches"]
            for arch, c in cases.items()}


# ---------------------------------------------------------------------------
# phase degraded: the degraded checkpoint restore
# ---------------------------------------------------------------------------

def _restore_run(args, label, want_logits) -> dict:
    """``serve.main`` restoring from a checkpoint: the run's launches, its
    tokens and logits bitwise equal to ``want_logits``, each decode step
    and warm-up launching alike, and every restored leaf of at least
    ``--min-bytes`` moved host to device compressed."""
    import torch
    from repro_torch.launch import serve
    serve.reset_launch_counts()          # this run starts here ...
    out = serve.main(args)
    out["path_launches"] = serve.launch_counts()   # ... and ends here
    check(torch.equal(out["logits"].view(torch.int32),
                      want_logits.view(torch.int32)),
          f"degraded {label}: logits not bitwise equal to a clean run")
    steps = out["step_launches"]
    check(all(st == steps[0] for st in steps)
          and all(w == steps[0] for w in out["warmup_launches"].values()),
          f"degraded {label}: decode steps launched differently")
    restore = out["restore"]
    sizes = _leaf_bytes()
    big = [n for n in restore["dense_records"] if sizes[n] >= MIN_BYTES]
    check(not big, f"degraded {label}: leaves of >= {MIN_BYTES} bytes moved "
          f"dense host to device: {big}")
    return out


def phase_degraded(fused):
    """The degraded restore (``policy="degraded"``) of llama3_2_1b at full
    width.  The ckpt phase's fused tree is saved as steps 0 and 1, then
    (a) one byte of one record of step 1's pack is flipped: ``serve.main
    --ckpt`` quarantines exactly that record, restores it from step 0 and
    serves logits bitwise equal to ``fused`` (phase serve's fresh run, to
    which a clean restore is held bitwise by phase ckpt) with health
    ``degraded``; (c) a strict ``load_for_serving`` raises and
    ``serve.main --strict`` exits 1 with health ``failed``; the byte is
    flipped back and (b) a decode fault injected through
    ``runtime/faults.py`` on a record the restore decodes does the same as
    (a); (d) every restored leaf of at least ``--min-bytes`` moves host to
    device compressed.  Then (a) again on a stream-layout checkpoint
    served in stream mode, so kernel 1 decodes the fallback record in
    every step's prefetch."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint.ckpt import CheckpointError, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.codec_api import Codec, use_codec
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.lm import abstract_params
    from repro_torch.runtime import faults
    from repro_torch.runtime.streaming import assign_weight_modes
    cfg = get_config("llama3_2_1b")
    base = ["--batch", str(BATCH), "--prompt-len", str(PROMPT), "--tokens",
            str(TOKENS), "--min-bytes", str(MIN_BYTES)]
    tmp = Path(tempfile.mkdtemp(prefix="enec-degraded-"))
    res, launches = {}, {}
    try:
        codec = Codec()
        t0 = time.perf_counter()
        with use_codec(codec):
            for layout in ("fused", "stream"):
                params = assign_weight_modes(
                    build_model(cfg).init(seed=0, device="cuda"),
                    mode=layout, min_bytes=MIN_BYTES, shards=2, codec=codec)
                mgr = CheckpointManager(tmp / layout, serving_layout=layout,
                                        serving_min_bytes=MIN_BYTES,
                                        serving_shards=2, codec=codec,
                                        device="cuda")
                for step in (0, 1):
                    mgr.save(step, {"params": params}, blocking=True)
                del params, mgr
                torch.cuda.empty_cache()
        res["save_s"] = time.perf_counter() - t0
        root = tmp / "fused"
        victim = "params/period/0/mlp/w_down"
        name, _, pos = faults.flip_pack_byte(root, victim, step=1)
        check(name == victim, f"degraded: flipped {name}")
        want_q = [(victim, "step 0 (fused record)")]
        # (a) one flipped byte
        out = _restore_run(base + ["--mode", "fused", "--ckpt", str(root)],
                           "flipped byte", fused["logits"])
        got_q = [(q["name"], q["fallback"])
                 for q in out["restore"]["quarantined"]]
        check(got_q == want_q and out["health"] == "degraded",
              f"degraded (a): quarantined {got_q}, health {out['health']}")
        check("CRC" in out["restore"]["quarantined"][0]["cause"],
              f"degraded (a): cause {out['restore']['quarantined'][0]}")
        launches["degraded"] = out["path_launches"]
        res["flipped"] = {k: out[k] for k in ("restore", "health",
                                               "tpot_s", "ttft_s")}
        # (c) strict
        try:
            CheckpointManager(root, codec=Codec(), device="cuda") \
                .load_for_serving(abstract_params(cfg), mode="fused",
                                  prefix="params", min_bytes=MIN_BYTES,
                                  shards=2)
        except CheckpointError as e:
            check("CRC" in str(e), f"degraded (c): strict raised {e}")
            res["strict_error"] = str(e)
        else:
            fail("degraded (c): a strict restore of the damaged step passed")
        try:
            serve.main(base + ["--mode", "fused", "--ckpt", str(root),
                               "--strict"])
        except SystemExit as e:
            check(e.code == 1 and serve.HEALTH.state == "failed",
                  f"degraded (c): --strict exit {e.code}, health "
                  f"{serve.HEALTH.state}")
            res["strict_exit"] = e.code
        else:
            fail("degraded (c): serve --strict served a damaged restore")
        torch.cuda.empty_cache()
        faults.flip_pack_byte(root, victim, step=1)      # and back
        # (b) a decode fault on a record the restore decodes (a const
        # record: fused records are adopted as they are)
        target = "params/final_norm"
        with faults.inject(faults.FaultSpec(kind="decode", match=target,
                                            times=1)) as inj:
            out = _restore_run(base + ["--mode", "fused", "--ckpt",
                                       str(root)], "decode fault",
                               fused["logits"])
        got_q = [(q["name"], q["fallback"])
                 for q in out["restore"]["quarantined"]]
        check(got_q == [(target, "step 0 (const record)")]
              and inj.stats()[0]["fired"] == 1
              and out["health"] == "degraded",
              f"degraded (b): quarantined {got_q}, {inj.stats()}")
        res["decode_fault"] = {k: out[k] for k in ("restore", "health")}
        torch.cuda.empty_cache()
        # (a) on the stream layout: kernel 1 decodes the fallback record
        root = tmp / "stream"
        faults.flip_pack_byte(root, victim, step=1)
        out = _restore_run(base + ["--mode", "stream", "--ckpt", str(root)],
                           "stream layout", fused["logits"])
        got_q = [(q["name"], q["fallback"])
                 for q in out["restore"]["quarantined"]]
        check(got_q == [(victim, "step 0 (stream record)")]
              and out["health"] == "degraded"
              and out["path_launches"]["enec_decode"] > 0,
              f"degraded stream: quarantined {got_q}, launches "
              f"{out['path_launches']}")
        launches["degraded_stream"] = out["path_launches"]
        res["stream"] = {k: out[k] for k in ("restore", "health", "tpot_s",
                                              "step_launches")}
        res["stream"]["step_launches"] = out["step_launches"][0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"degraded: (a) {victim} flipped at step 1 -> quarantined, restored "
        f"from step 0, logits bitwise equal, health degraded (fused "
        f"layout, and the stream layout with kernel 1 decoding the "
        f"fallback each step); (b) a decode fault on {target} the same; (c) "
        f"strict raised and --strict exited 1, health failed; (d) h2d "
        f"{res['flipped']['restore']['h2d_compressed_bytes'] / 1e6:.3f} MB "
        f"compressed, {res['flipped']['restore']['h2d_dense_bytes']} B "
        f"dense; saves {res['save_s']:.1f} s; launches {launches} on "
        f"{card_line()}")
    RESULTS["degraded"] = res
    return launches


# ---------------------------------------------------------------------------
# phase serve_minitron: minitron_4b at full width
# ---------------------------------------------------------------------------

def phase_serve_minitron():
    """``launch.serve.main --arch minitron_4b`` at full width in fused,
    stream and dense modes: equal greedy tokens, bitwise-equal logits, the
    launches per decode step read from the code (the untied head is a
    second flat stream beside the embed)."""
    import torch
    from repro_torch.launch import serve
    card = card_line()
    runs, launches = {}, {}
    for mode in ("fused", "stream", "dense"):
        serve.reset_launch_counts()      # this path's run starts here ...
        out = serve.main(["--arch", "minitron_4b", "--batch", str(BATCH),
                          "--prompt-len", str(PROMPT), "--tokens",
                          str(TOKENS), "--mode", mode])
        launches[f"minitron_{mode}"] = serve.launch_counts()   # ... ends
        out["path_launches"] = launches[f"minitron_{mode}"]
        runs[mode] = out
        torch.cuda.empty_cache()
    ref = runs["fused"]
    check(tuple(ref["logits"].shape) == (TOKENS, BATCH, MINITRON_VOCAB),
          f"minitron logits shape {tuple(ref['logits'].shape)}")
    check(bool(torch.isfinite(ref["logits"]).all()), "non-finite logits")
    for mode in ("stream", "dense"):
        check(torch.equal(runs[mode]["tokens"], ref["tokens"]),
              f"minitron {mode} greedy tokens differ from fused")
        check(torch.equal(runs[mode]["logits"].view(torch.int32),
                          ref["logits"].view(torch.int32)),
              f"minitron {mode} logits not bitwise equal to fused")
    for mode, out in runs.items():
        step = out["step_launches"][0]
        _check_overlap_schedule(f"minitron {mode}", mode, out)
        _check_engine_run(f"minitron {mode}", out,
                          run_step_launches("minitron_4b", mode, out))
        enc = out["path_launches"]["enec_encode"]
        check(enc == out["encode_dispatches"] == out["encode_buckets"],
              f"minitron {mode}: {enc} encode launches, set-up reports "
              f"{out['encode_dispatches']} dispatches of "
              f"{out['encode_buckets']} buckets")
        check((enc > 0) == (mode != "dense"),
              f"minitron {mode}: {enc} encode launches in set-up")
        log(f"serve minitron_4b {mode}: set-up {out['setup_s']:.3f} s "
            f"({out['encode_buckets']} encode buckets), TTFT "
            f"{out['ttft_s'] * 1e3:.2f} ms, TPOT {out['tpot_s'] * 1e3:.2f} "
            f"ms (captured step; device {out['step_device_ms']:.3f} ms a "
            f"replay; captures {_capture_ms(out)} ms), "
            f"{out['tok_s']:.2f} tok/s, wire ratio "
            f"{out['wire_ratio']:.4f}, hbm ratio "
            f"{out['stream_stats']['hbm_ratio']:.4f}, launches/step {step}, "
            f"launches in this run {out['path_launches']}, mode_mix "
            f"{out['mode_mix']} on {card}")
    log(f"serve minitron_4b: fused/stream/dense tokens equal, logits bitwise "
        f"equal; seq0 {ref['tokens'][0].tolist()}")
    RESULTS["serve_minitron"] = {
        "card": card,
        "modes": {m: {k: o[k] for k in ("ttft_s", "tpot_s", "tok_s",
                                        "step_device_ms", "setup_s",
                                        "wire_ratio", "encode_buckets",
                                        "path_launches", "prefill_launches",
                                        "mode_mix", "step_s", "capture_s")}
                  | {"step_launches": o["step_launches"][0],
                     "hbm_ratio": o["stream_stats"]["hbm_ratio"],
                     "raw_bytes": o["stream_stats"]["raw_bytes"],
                     "device_bytes": o["stream_stats"]["device_bytes"]}
                  for m, o in runs.items()}}
    return launches


# ---------------------------------------------------------------------------
# phase moe: phi3_5_moe at published widths, experts from a store
# ---------------------------------------------------------------------------

MOE_ARCH = "phi3_5_moe_42b_a6_6b"
# depth cut 32 -> 8: the bitwise checks need the dense tree on the card,
# 83.7 GB at 32 layers, and the set-up holds the dense and compressed
# trees together (~21.3 + 20 GB at 8 layers, ~80 GB at 16); check (f)
# needs the depth: at 4 layers the bounded store's peak is above dense's
MOE_LAYERS = 8
MOE_GEOMS = 2            # expert leaf geometries: (D, F) and (F, D)


def moe_step_launches(n_layers: int, n_experts: int, bpl: dict) -> dict:
    """Kernel launches of one MoE decode step without a store, read from
    the code: a layer runs its 4 attention matmuls, the f32 router (a
    stream in the compressing modes, materialized by kernel 1, then the
    dense-tile entry) and 3 products of EVERY expert (the expert stacks
    are streams materialized per layer in stream and fused modes); the
    embed and the untied head are flat streams, and the head one
    dense-tile launch.  The streamed leaves of a layer (8 in stream mode,
    the router and the 3 expert stacks in fused mode) are prefetched by
    one batched decode of ``bpl[mode]`` launches (the schedule's
    ``buckets_per_layer``; ``runtime/overlap.py``), once ``bpl`` has the
    mode."""
    zero = dict.fromkeys(KERNELS, 0)
    dense_tiles = n_layers * (1 + 3 * n_experts) + 1
    return {"dense": zero | {"dense_tile_matmul": dense_tiles + 4 * n_layers},
            "stream": zero | {"enec_decode": n_layers * bpl.get("stream", 0)
                              + 2,
                              "dense_tile_matmul": dense_tiles
                              + 4 * n_layers},
            "fused": zero | {"enec_decode": n_layers * bpl.get("fused", 0)
                             + 2,
                             "decompress_matmul": 4 * n_layers,
                             "dense_tile_matmul": dense_tiles}}


def _mem_available_gb() -> float:
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) / 2**20
    return float("nan")


def _moe_engine_run(label, model, params, codec, store=None) -> dict:
    """One engine run of the phase's traffic (4 requests x prompt 64 x 16
    new tokens, 4 slots, all submitted together): each request's logits,
    TTFT, TPOT, device ms a step, the launches of the run and of each
    step, the peak device memory from the engine's creation to its end,
    and with a store its counters, each fetch's decode launches and h2d
    bytes (``fetches``), miss-decode seconds and h2d bytes a step."""
    import torch
    from repro_torch.kernels import enec_decode
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import Engine, EngineConfig
    cfg = model.cfg
    ecfg = EngineConfig(max_slots=BATCH, queue_depth=2 * BATCH,
                        max_prompt_len=PROMPT, max_new_tokens=TOKENS,
                        collect_logits=True)
    fetches = []
    if store is not None:
        fetch = store.fetch_step

        def traced(names, layer, routed):
            routed = sorted({int(r) for r in routed})
            miss = [(n, layer, j) for n in names for j in routed
                    if (n, layer, j) not in store._lru]
            d0 = enec_decode.LAUNCHES.n
            h0 = codec.transfer_stats()["h2d_bytes"]
            out = fetch(names, layer, routed)
            fetches.append({
                "routed": len(routed), "missed": len(miss),
                "launches": enec_decode.LAUNCHES.n - d0,
                "buckets": store.last_fetch["buckets"] if miss else 0,
                "geoms": len({store.meta(n)["expert_shape"]
                              for n, _, _ in miss}),
                "h2d": codec.transfer_stats()["h2d_bytes"] - h0,
                "stream_bytes": sum(store._headers[k].stream_nbytes
                                    for k in miss)})
            return out

        store.fetch_step = traced
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prompts = _prompts(cfg.vocab_size)
    engine = Engine(model, params, ecfg, codec=codec, expert_store=store)
    serve.reset_launch_counts()          # this run starts here ...
    reqs = [engine.submit(prompts[i], TOKENS, name=f"r{i}")
            for i in range(BATCH)]
    engine.run_until_idle()
    torch.cuda.synchronize()
    launches = serve.launch_counts()      # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    if store is not None:
        # drop the instance attribute (a bound method stored on its own
        # instance would be a reference cycle holding the store's cache on
        # the card until the cycle collector ran)
        del store.fetch_step
    for i, req in enumerate(reqs):
        check(req.state == "done" and len(req.logits) == TOKENS,
              f"{label}: r{i} {req.state} with {len(req.logits)} tokens")
    steady = [(t, ms) for t, ms, c in zip(engine.step_times_s,
                                          engine.step_device_ms,
                                          engine.step_captured) if not c]
    out = {"logits": [[t.clone() for t in r.logits] for r in reqs],
           "tokens": [list(r.tokens) for r in reqs],
           "ttft_ms": 1e3 * sum(r.ttft_s() for r in reqs) / len(reqs),
           "tpot_ms": 1e3 * sum(t for t, _ in steady) / len(steady),
           "device_ms": sum(ms for _, ms in steady) / len(steady),
           "step_ms": [1e3 * t for t in engine.step_times_s],
           "step_device_ms": engine.step_device_ms,
           "steps": len(engine.step_times_s), "prefills": len(reqs),
           "launches": launches, "step_launches": engine.step_launches,
           "warmup_launches": engine.captured.warmup_launches,
           "prefill_launches": engine.prefill_launches,
           "eager": engine.captured.eager,
           "compiled_buckets": engine.stats()["engine"]["compiled_buckets"],
           "peak_gb": peak / 1e9, "mem_available_gb": _mem_available_gb()}
    if store is not None:
        st = store.stats()
        out.update(experts=st, fetches=fetches,
                   hit_rate=st["hits"] / max(1, st["hits"] + st["misses"]),
                   miss_decode_ms=1e3 * sum(engine.step_decode_s)
                   / len(engine.step_decode_s),
                   h2d_gb_step=sum(engine.step_h2d_bytes)
                   / len(engine.step_h2d_bytes) / 1e9,
                   step_decode_ms=[1e3 * s for s in engine.step_decode_s],
                   step_h2d_gb=[b / 1e9 for b in engine.step_h2d_bytes])
    del engine, reqs
    return out


def _check_moe_launches(label, run, want_step, n_layers):
    """Without a store: every replay's and warm-up's launches equal one
    step's read from the code, and the run launched the prefills', steps'
    and warm-ups' kernels and nothing else.  With one: the run's decode,
    fused and dense-tile launches follow from its forwards (prefills and
    steps: the router of every layer, the embed and the head) and its
    fetches (one decode launch per bucket, at most one per leaf geometry
    touched; three dense-tile launches per routed expert); every miss
    moved its record's stream bytes host to device, and nothing else."""
    if want_step is not None:
        check(all(st == want_step for st in run["step_launches"]),
              f"{label}: launches a step {run['step_launches'][:1]} != "
              f"{want_step}")
        check(all(w == want_step for w in run["warmup_launches"].values()),
              f"{label}: warm-up launches != one step's")
        total = {k: run["prefill_launches"][k]
                 + sum(st[k] for st in run["step_launches"])
                 + sum(w[k] for w in run["warmup_launches"].values())
                 for k in KERNELS}
        check(total == run["launches"], f"{label}: launched "
              f"{run['launches']}, prefills + steps + warm-ups {total}")
        return
    fetches = run["fetches"]
    forwards = run["prefills"] + run["steps"]
    check(len(fetches) == forwards * n_layers,
          f"{label}: {len(fetches)} fetches for {forwards} forwards")
    for f in fetches:
        check(f["launches"] == f["buckets"] <= f["geoms"]
              if f["missed"] else f["launches"] == 0,
              f"{label}: a fetch of {f['missed']} misses over "
              f"{f['geoms']} geometries took {f['launches']} decode "
              f"launches ({f['buckets']} buckets)")
        check(f["h2d"] == f["stream_bytes"],
              f"{label}: a fetch moved {f['h2d']} bytes host to device, "
              f"its misses' streams are {f['stream_bytes']}")
    want = dict.fromkeys(KERNELS, 0) | {
        "enec_decode": forwards * (n_layers + 2)
        + sum(f["launches"] for f in fetches),
        "decompress_matmul": forwards * 4 * n_layers,
        "dense_tile_matmul": forwards * (n_layers + 1)
        + sum(3 * f["routed"] for f in fetches)}
    check(run["launches"] == want, f"{label}: launched {run['launches']}, "
          f"the forwards and fetches account for {want}")


def _moe_kernel_times(store, codec) -> dict:
    """Kernel 1 on one layer's routed experts (the 8 experts of a decode
    step at batch 4, all three leaves, as one fetch stages them), kernel
    2's dense-tile entry on one 4096 x 6400 expert at M = 4 and 16, and
    kernel 4 on the set-up's stacked encode of one expert leaf (L*E
    slices), each held against its plain version on every block
    of its launch and timed beside its bound; 2' also beside
    torch.matmul."""
    import torch
    from repro_torch.core import codec as block_codec
    from repro_torch.core.dtypes import to_container
    from repro_torch.kernels import enec_decode, enec_encode, ref
    from repro_torch.kernels.decompress_matmul import dense_matmul_cuda
    from repro_torch.runtime.experts import _expert_block_elems
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    names = store.names()
    routed = min(2 * BATCH, store.meta(names[0])["n_experts"])
    keys = [(n, 0, j) for n in names for j in range(routed)]
    plan = codec.plan_decode([store._stage(k) for k in keys])
    dec = {"records": len(keys), "buckets": len(plan.buckets), "ms": 0.0,
           "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0}
    for members in plan._groups:
        flat = block_codec.BlockStreams(*(torch.cat(f) for f in zip(
            *[m["flat"] for m in members])))
        nb = [m["flat"].mask.shape[0] for m in members]
        b_vec = torch.cat([torch.full((n,), m["ct"].params.b,
                                      dtype=torch.int32, device="cuda")
                           for n, m in zip(nb, members)])
        l_vec = torch.cat([torch.full((n,), m["ct"].params.l,
                                      dtype=torch.int32, device="cuda")
                           for n, m in zip(nb, members)])
        ct0 = members[0]["ct"]
        args = (flat, ct0.block_elems, ct0.fmt, ct0.params, b_vec, l_vec)
        got = enec_decode.decode_blocks_cuda(*args)
        dec["ms"] += cuda_ms(lambda: enec_decode.decode_blocks_cuda(*args),
                             10, flush)
        dec["bound_ms"] += 1e3 * (needed_bytes(flat) + got.numel()
                                  * got.element_size()) / HBM_BYTES_PER_S
        # the plain decoder record by record (its intermediates are several
        # times a bucket's output), each against its rows of the launch
        off = 0
        for n in nb:
            part = flat.map(lambda a, o=off, k=n: a[o:o + k])
            pargs = (part, ct0.block_elems, ct0.fmt, ct0.params,
                     b_vec[off:off + n], l_vec[off:off + n])
            check(torch.equal(got[off:off + n],
                              enec_decode.decode_blocks_plain(*pargs)),
                  "moe: kernel 1 on the routed experts differs from the "
                  "plain decoder")
            dec["plain_ms"] += cuda_ms(
                lambda: enec_decode.decode_blocks_plain(*pargs), 1, flush)
            off += n
        del got, flat
    expert = store.materialize_leaf(names[0])[0, 0]      # (4096, 6400)
    gen = torch.Generator(device="cuda").manual_seed(7)
    mm = {}
    for m in (BATCH, 16):
        x = torch.randn((m, expert.shape[0]), generator=gen,
                        device="cuda").bfloat16()
        got = dense_matmul_cuda(x, expert)
        want = ref.tiled_matmul_ref(x, expert)
        err = float((got - want).abs().max())
        check(err <= MATMUL_ATOL, f"moe: kernel 2' on an expert at M = {m} "
              f"errs {err} from the plain version")
        k, n = expert.shape
        mm[m] = {"ms": cuda_ms(lambda: dense_matmul_cuda(x, expert), 20,
                               flush),
                 "plain_ms": cuda_ms(lambda: ref.tiled_matmul_ref(x, expert),
                                     3, flush),
                 "library_ms": cuda_ms(lambda: torch.matmul(x, expert), 20,
                                       flush),
                 "bound_ms": 1e3 * max((k * n * 2 + m * k * 2 + m * n * 4)
                                       / HBM_BYTES_PER_S,
                                       2 * m * k * n / BF16_FLOPS),
                 "bound_by": "bytes", "max_abs_err": err}
    del flush_buf, expert, x
    # kernel 4: the set-up's stacked encode of one expert leaf (L*E slices)
    leaf = store.materialize_leaf(names[0])
    n_elems = leaf[0, 0].numel()
    plan = codec.plan_encode([leaf.reshape((-1,) + leaf.shape[2:])],
                             stacked=True,
                             block_elems=_expert_block_elems(codec, n_elems))
    del leaf
    (blocks, fmt, p, b_vec), = codec.encode_launches(plan)
    bits = to_container(blocks, fmt).contiguous()
    streams = enec_encode.encode_blocks_cuda(bits, fmt, p, b_vec)
    plain = (lambda: enec_encode.encode_blocks_plain(bits, fmt, p, b_vec))
    want = plain()
    check(all(torch.equal(a, b) for a, b in zip(streams, want)),
          "moe: kernel 4 on an expert leaf differs from the plain encoder")
    del want
    enc = _time_encode_launch(blocks, fmt, p, b_vec, needed_bytes(streams))
    enc["plain_ms"] = cuda_ms(plain, 1)
    enc.update(blocks=int(blocks.shape[0]), max_abs_err=0)
    return {"decode": dec, "dense_tile": mm, "encode": enc}


def _moe_attention_times(params) -> dict:
    """Kernel 2's fused entry on layer 0's 4 attention leaves of the fused
    tree (4096 x 4096 / 1024, M = BATCH): within MATMUL_ATOL of the plain
    version, timed beside the plain version, its bound (the compressed
    tile streams at true length, x and out once) and torch.matmul on the
    dense bf16 weight; each leaf and their sum."""
    import torch
    from repro_torch.kernels.decompress_matmul import (
        decompress_matmul_cuda, decompress_matmul_plain)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    gen = torch.Generator(device="cuda").manual_seed(11)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    rows, total = {}, dict.fromkeys(keys, 0.0)
    total["max_abs_err"] = 0.0
    for name in ("wq", "wk", "wv", "wo"):
        h = params["period"][0]["attn"][name].layer(0)
        k, n = h.k, h.n
        w = h.materialize()
        x = torch.randn((BATCH, k), generator=gen,
                        device="cuda").bfloat16()
        got = decompress_matmul_cuda(x, h.ct, k, n)
        err = float((got - decompress_matmul_plain(x, h.ct, k, n)).abs()
                    .max())
        check(err <= MATMUL_ATOL, f"moe: kernel 2 on attention {name} errs "
              f"{err} from the plain version")
        row = {"k": k, "n": n, "max_abs_err": err,
               "ms": cuda_ms(lambda: decompress_matmul_cuda(x, h.ct, k, n),
                             20, flush),
               "plain_ms": cuda_ms(lambda: decompress_matmul_plain(
                   x, h.ct, k, n), 3, flush),
               "library_ms": cuda_ms(lambda: torch.matmul(x, w), 20, flush),
               "bound_ms": 1e3 * max(
                   (needed_bytes(h.ct.streams) + BATCH * k * 2
                    + BATCH * n * 4) / HBM_BYTES_PER_S,
                   2 * BATCH * k * n / BF16_FLOPS),
               "bound_by": "bytes"}
        rows[name] = row
        for key in keys:
            total[key] += row[key]
        total["max_abs_err"] = max(total["max_abs_err"], err)
    del flush_buf
    return {"leaves": rows, "total": total}


def _rebudget(store, budget) -> None:
    """Empty ``store``'s cache and give it ``budget`` bytes (``None``:
    unbounded): the phase serves its budgets from one store's records."""
    store.budget_bytes = 0
    store._trim()
    store.budget_bytes = budget


def _moe_store_capture_refused(store) -> str:
    """(c) a store fetch inside a CUDA graph capture raises."""
    import torch
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
            store.fetch_step(store.names(), 0, [0])
    except RuntimeError as e:
        check("capture" in str(e), f"moe: the fetch refused with {e}")
        torch.cuda.synchronize()
        return str(e)
    fail("moe: an expert store fetch ran inside a CUDA graph capture")


def phase_moe():
    """phi3_5_moe at published widths (d_model 4096, 32/8 heads, 16
    experts top-2, moe_d_ff 6400, vocab 32064, untied head), cut to
    ``MOE_LAYERS`` layers, served through the engine in dense, stream and
    fused mode (each bucket's step a CUDA graph) and, fused, with an expert
    store at budgets 0, one step's working set and unbounded (every step
    eager).  Checks (a) each request's logits bitwise equal across the six
    runs and to the request served alone in dense and at budget 0; (b) the
    captured modes' replays bitwise equal to the eager bucket-4 step, with
    a replay's launches read from the code; (c) a store fetch refuses a
    capture; (d) each fetch takes at most one decode launch per leaf
    geometry it touches and moves its misses' stream bytes host to device;
    (e) a checkpoint with per-expert records, restored into a bounded
    store, serves the same bits with no dense h2d of an expert; (f) the
    peak device memory of the bounded store runs below the dense run's, and
    the unbounded store's at most the budget-0 run's plus its cache (it
    ends holding every routed expert decoded, the dense expert bytes; its
    peak against dense is logged, not held), all logged beside
    MemAvailable."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.codec_api import Codec, use_codec
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.lm import abstract_params
    from repro_torch.runtime.experts import (ExpertStore,
                                             install_expert_store)
    from repro_torch.runtime.overlap import build_schedule
    from repro_torch.runtime.streaming import assign_weight_modes
    # the earlier phases' trees are gone, none of them held by a cycle
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left_gb = torch.cuda.memory_allocated() / 1e9
    log(f"moe: {left_gb:.3f} GB allocated from the earlier phases")
    check(left_gb < 1.0, f"moe: the earlier phases left {left_gb:.3f} GB "
          f"allocated on the card")
    card = card_line()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    model = build_model(cfg)
    bpl = {}
    prompts = _prompts(cfg.vocab_size)
    max_len = PROMPT + TOKENS
    runs, res, launches = {}, {}, {}

    def summary(run) -> dict:
        return {k: v for k, v in run.items()
                if k not in ("logits", "fetches", "step_launches")}

    for mode in ("dense", "stream", "fused"):
        codec = Codec()
        with use_codec(codec):
            t0 = time.perf_counter()
            params = assign_weight_modes(
                model.init(seed=0, device="cuda"), mode=mode,
                min_bytes=MIN_BYTES, shards=2, codec=codec)
            setup_s = _sync_s(t0)
            if mode != "dense":
                # (the schedule holds the tree: keep only its numbers)
                sched = build_schedule(params["period"], MOE_LAYERS)
                slots, bpl[mode] = sched.slots, sched.buckets_per_layer
                del sched
                check(len(slots) == (8 if mode == "stream" else 4),
                      f"moe {mode}: prefetch slots {slots}")
            if mode == "fused":
                attention = _moe_attention_times(params)
            run = _moe_engine_run(f"moe {mode}", model, params, codec)
            run["setup_s"] = setup_s
            want_step = moe_step_launches(MOE_LAYERS, cfg.n_experts, bpl)
            _check_moe_launches(f"moe {mode}", run, want_step[mode],
                                MOE_LAYERS)
            check(run["compiled_buckets"] == [BATCH],
                  f"moe {mode}: buckets {run['compiled_buckets']}")
            bucket_outs, bucket_secs = eager_bucket_loop(model, params,
                                                         prompts, max_len)
            for i in range(BATCH):
                check(_bits_equal(run["logits"][i], bucket_outs[i]),
                      f"moe {mode}: r{i}'s bucket-{BATCH} replays differ "
                      f"from the eager bucket-{BATCH} step")
            run["eager_bucket_tpot_ms"] = 1e3 * sum(bucket_secs) / len(
                bucket_secs)
            if mode == "dense":
                alone = [one_shot_alone(model, params, p, max_len)
                         for p in prompts]
                for i, (outs, _) in enumerate(alone):
                    check(_bits_equal(run["logits"][i], outs),
                          f"moe dense: r{i} differs from it served alone")
            del params, bucket_outs
        launches[f"moe_{mode}"] = run["launches"]
        runs[mode] = run
        torch.cuda.empty_cache()
        log(f"moe {mode}: set-up {setup_s:.2f} s, TTFT {run['ttft_ms']:.2f} "
            f"ms, TPOT {run['tpot_ms']:.3f} ms (captured; eager bucket-"
            f"{BATCH} step {run['eager_bucket_tpot_ms']:.3f} ms), device "
            f"{run['device_ms']:.3f} ms a replay, peak "
            f"{run['peak_gb']:.2f} GB, MemAvailable "
            f"{run['mem_available_gb']:.1f} GB; launches a step "
            f"{run['step_launches'][0]} on {card}")

    ref = runs["dense"]["logits"]
    for mode in ("stream", "fused"):
        for i in range(BATCH):
            check(_bits_equal(runs[mode]["logits"][i], ref[i]),
                  f"moe {mode}: r{i} not bitwise equal to dense")

    # the store runs: one tree (experts installed into a store before the
    # fused mode assignment), served at three budgets from a cold cache
    codec = Codec()
    with use_codec(codec):
        t0 = time.perf_counter()
        store = ExpertStore(budget_bytes=None, codec=codec, device="cuda")
        before = serve.launch_counts()
        params, _ = install_expert_store(model.init(seed=0, device="cuda"),
                                         store=store, min_bytes=MIN_BYTES)
        install_s = _sync_s(t0)
        install_launches = {k: v - before[k]
                            for k, v in serve.launch_counts().items()}
        params = assign_weight_modes(params, mode="fused",
                                     min_bytes=MIN_BYTES, shards=2,
                                     codec=codec)
        setup_s = _sync_s(t0)
        torch.cuda.empty_cache()
        per_expert = sum(store.expert_nbytes(n) for n in store.names())
        ws = 2 * BATCH * per_expert * MOE_LAYERS     # <= 8 experts a layer
        budgets = {"store_0": 0, "store_ws": ws, "store_unbounded": None}
        guard = _moe_store_capture_refused(store)
        for name, budget in budgets.items():
            _rebudget(store, budget)
            store.reset_stats()
            codec.reset_transfer_stats()
            run = _moe_engine_run(f"moe {name}", model, params, codec, store)
            run["setup_s"] = setup_s
            run["budget_bytes"] = budget
            _check_moe_launches(f"moe {name}", run, None, MOE_LAYERS)
            check(run["eager"] and run["compiled_buckets"] == [BATCH],
                  f"moe {name}: eager {run['eager']}, buckets "
                  f"{run['compiled_buckets']}")
            check(budget is None or run["experts"]["resident_bytes"]
                  <= budget, f"moe {name}: resident bytes over budget")
            launches[f"moe_{name}"] = run["launches"]
            runs[name] = run
            log(f"moe {name}: budget {budget} B, TTFT {run['ttft_ms']:.2f} "
                f"ms, TPOT {run['tpot_ms']:.3f} ms (eager), device "
                f"{run['device_ms']:.3f} ms a step, hit rate "
                f"{run['hit_rate']:.4f} ({run['experts']['hits']} hits, "
                f"{run['experts']['misses']} misses, "
                f"{run['experts']['evictions']} evictions), miss-decode "
                f"{run['miss_decode_ms']:.3f} ms a step, h2d "
                f"{run['h2d_gb_step']:.4f} GB a step, peak "
                f"{run['peak_gb']:.2f} GB, MemAvailable "
                f"{run['mem_available_gb']:.1f} GB on {card}")
        # (a) at budget 0, each request served alone
        _rebudget(store, 0)
        alone0 = [one_shot_alone(model, params, p, max_len)[0]
                  for p in prompts]
        for i in range(BATCH):
            check(_bits_equal(alone0[i], ref[i]),
                  f"moe store_0: r{i} served alone differs from dense")
        # the transfer's yardstick: a pinned copy of one step's misses
        step_bytes = int(max(runs["store_0"]["step_h2d_gb"][1:]) * 1e9)
        src = torch.empty(step_bytes, dtype=torch.uint8, pin_memory=True)
        dst = torch.empty(step_bytes, dtype=torch.uint8, device="cuda")
        pinned_ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), 3)
        del src, dst
        kernels = _moe_kernel_times(store, codec)
        kernels["fused_attention"] = attention
        # (e) save with per-expert records, restore into a bounded store
        tmp = tempfile.mkdtemp(prefix="moe_ckpt_")
        try:
            mgr = CheckpointManager(tmp, serving_layout="fused",
                                    serving_min_bytes=MIN_BYTES,
                                    serving_shards=2, expert_records=True,
                                    codec=codec, device="cuda")
            t0 = time.perf_counter()
            mgr.save(0, {"params": params}, blocking=True)
            save_s = time.perf_counter() - t0
            disk = sum(p.stat().st_size for p in Path(tmp).rglob("*")
                       if p.is_file())
            del params, store
            torch.cuda.empty_cache()
            codec.reset_transfer_stats()
            t0 = time.perf_counter()
            store2 = ExpertStore(budget_bytes=ws, codec=codec,
                                 device="cuda")
            params, _ = mgr.load_for_serving(
                abstract_params(cfg), mode="fused", prefix="params",
                min_bytes=MIN_BYTES, shards=2, expert_store=store2)
            restore_s = _sync_s(t0)
            h2d = codec.link_stats()["h2d"]
            dense_experts = [n for n in mgr.last_dense_records
                             if "/moe/e_" in n]
            check(not dense_experts, f"moe ckpt: the restore moved expert "
                  f"records {dense_experts[:3]} dense host to device")
            check(store2.stats()["resident_bytes"] == 0
                  and not store2._headers,
                  "moe ckpt: the restore staged a cold expert")
            run = _moe_engine_run("moe ckpt", model, params, codec, store2)
            _check_moe_launches("moe ckpt", run, None, MOE_LAYERS)
            for i in range(BATCH):
                check(_bits_equal(run["logits"][i], ref[i]),
                      f"moe ckpt: r{i} not bitwise equal to dense")
            res["ckpt"] = {"save_s": save_s, "restore_s": restore_s,
                           "bytes_on_disk": disk,
                           "restore_h2d_compressed_bytes":
                           h2d["compressed_bytes"],
                           "restore_h2d_dense_bytes": h2d["dense_bytes"],
                           "dense_records": list(mgr.last_dense_records),
                           "run": summary(run)}
            del params, store2, mgr
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"moe ckpt: saved {res['ckpt']['bytes_on_disk'] / 1e9:.2f} GB in "
        f"{res['ckpt']['save_s']:.1f} s, restored in "
        f"{res['ckpt']['restore_s']:.1f} s (h2d "
        f"{res['ckpt']['restore_h2d_compressed_bytes'] / 1e9:.3f} GB "
        f"compressed, {res['ckpt']['restore_h2d_dense_bytes']} B dense, "
        f"from {res['ckpt']['dense_records']}, no expert), served bitwise "
        f"equal at the working-set budget")
    for name in budgets:
        for i in range(BATCH):
            check(_bits_equal(runs[name]["logits"][i], ref[i]),
                  f"moe {name}: r{i} not bitwise equal to dense")
    # (f) the bounded stores' serving peak below the dense run's.  The
    # unbounded store ends holding every routed expert decoded (the dense
    # expert bytes), so its peak is that cache plus one fetch's staged
    # streams: it is held to the budget-0 run's peak plus its cache (the
    # store holds no expert twice), and its peak against dense is logged
    dense_peak = runs["dense"]["peak_gb"]
    for name in ("store_0", "store_ws"):
        check(runs[name]["peak_gb"] < dense_peak,
              f"moe {name}: peak {runs[name]['peak_gb']:.2f} GB not below "
              f"dense {dense_peak:.2f} GB")
    unbounded = runs["store_unbounded"]
    cache_gb = unbounded["experts"]["resident_bytes"] / 1e9
    check(unbounded["peak_gb"] <= runs["store_0"]["peak_gb"] + cache_gb,
          f"moe store_unbounded: peak {unbounded['peak_gb']:.3f} GB over "
          f"the budget-0 run's {runs['store_0']['peak_gb']:.3f} GB plus its "
          f"{cache_gb:.3f} GB cache")
    tokens = runs["dense"]["tokens"]
    check(all(runs[n]["tokens"] == tokens for n in runs),
          "moe: greedy tokens differ between runs")
    check(all(bool(torch.isfinite(t).all()) and t.shape == (cfg.vocab_size,)
              for r in ref for t in r), "moe: non-finite or mis-shaped "
          "logits")
    log(f"moe: (a) {BATCH} requests bitwise equal across dense / stream / "
        f"fused / store 0 / working set / unbounded and served alone "
        f"(dense, budget 0); (b) replays equal the eager step; (c) a fetch "
        f"refuses a capture; (d) fetch launches and h2d bytes; (e) ckpt; "
        f"(f) peak GB dense {dense_peak:.2f}, store 0 "
        f"{runs['store_0']['peak_gb']:.2f}, working set "
        f"{runs['store_ws']['peak_gb']:.2f}, unbounded "
        f"{unbounded['peak_gb']:.2f} ({cache_gb:.2f} of it cached experts; "
        f"{'below' if unbounded['peak_gb'] < dense_peak else 'NOT below'} "
        f"dense); pinned copy of one "
        f"step's misses ({step_bytes / 1e9:.3f} GB) {pinned_ms:.3f} ms; "
        f"kernel 1 on a layer's 8 routed experts {kernels['decode']}; "
        f"kernel 2' on an expert {kernels['dense_tile']}; kernel 2 fused "
        f"on a layer's 4 attention leaves at M = {BATCH} "
        f"{kernels['fused_attention']['total']}; kernel 4 on an "
        f"expert leaf {kernels['encode']}; set-up: store "
        f"install {install_s:.2f} s ({install_launches}), all "
        f"{setup_s:.2f} s; seq0 {tokens[0]} on {card}")
    RESULTS["moe"] = {
        "card": card, "layers": MOE_LAYERS, "guard": guard,
        "runs": {n: summary(r) for n, r in runs.items()},
        "step_launches": want_step, "buckets_per_layer": bpl,
        "pinned_copy": {
            "bytes": step_bytes, "ms": pinned_ms},
        "kernels": kernels, "install_s": install_s,
        "install_launches": install_launches, "store_setup_s": setup_s,
        "working_set_bytes": ws} | res
    return launches


# ---------------------------------------------------------------------------
# phase families: xLSTM, PaliGemma and Jamba through the engine
# ---------------------------------------------------------------------------

# the recurrent and prefix families at published widths; Jamba's depth is
# cut 32 -> 8 (one period of its program): its dense tree is 106 GB at 32
# layers, and a set-up holds the dense tree and its compressed copy
# together (~26.6 + ~20 GB at 8 layers); xLSTM's 12 -> 8 (two periods)
# and PaliGemma's 18 -> 9 keep the script inside its time limit since
# phase train_mesh joined it (no check depends on the depth)
FAMILY_ARCHS = ("xlstm_125m", "paligemma_3b", "jamba_v0_1_52b")
FAMILY_LAYERS = {"jamba_v0_1_52b": 8, "xlstm_125m": 8, "paligemma_3b": 9}
PREFIX_EMBEDS = 256          # PaliGemma's image prefix (its prefix_embed)
# the leaves each sequence block and FFN multiplies by, one kernel-2
# launch a product in a decode step (``layers.weight_matmul``); an MoE
# layer's count is 1 + 3 x E (:func:`family_step_launches`)
FAMILY_MATMUL_LEAVES = {
    "attn": ("wq", "wk", "wv", "wo"), "mlp": ("w_gate", "w_up", "w_down"),
    "mamba": ("in_proj", "x_proj", "dt_proj", "out_proj"),
    "mlstm": ("wq", "wk", "wv", "wi", "wf", "wo_gate", "out_proj"),
    "slstm": ("w_in", "r_in", "out_proj"),
    "moe": ("router", "e_gate", "e_up", "e_down")}
FAMILY_PRODUCTS = {k: len(v) for k, v in FAMILY_MATMUL_LEAVES.items()}
# the products whose rows the model gives in f32 (mLSTM's gates, Mamba's
# dt, the router); every other product takes bf16 rows
F32_ROWS = frozenset({"wi", "wf", "dt_proj", "router"})
# the decode attention's heads (heads, KV heads, head_dim) in each served
# family with attention, at the cells' cache and a 1500-position one
DECODE_ATTN_HEADS = {"llama3_2_1b": (32, 8, 64), "minitron_4b": (24, 8, 128),
                     "paligemma_3b": (8, 1, 256),
                     "jamba_v0_1_52b": (32, 8, 128)}
DECODE_ATTN_CACHES = (PROMPT + TOKENS, 1500)


def family_cfg(arch: str):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in FAMILY_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_LAYERS[arch])
    return cfg


def family_step_launches(cfg, bpl: dict) -> dict:
    """Kernel launches of one decode step of each served mode, read from
    the code (``models/lm.py``): the attention and MLP products are the
    fused entry's in fused mode and the dense-tile entry's otherwise
    (streamed leaves decode first); the recurrent blocks' products, the
    MoE router and all 3 x E expert products (every expert on every row:
    a captured step has no host sync to skip unrouted ones) and the head
    are dense-tile launches in every mode; kernel 1 decodes the flat
    streams (the embed, and an untied head) and, in stream and fused mode,
    each period's streamed leaves: ``bpl[mode]`` launches a period, one
    prefetch of the schedule's buckets (``runtime/overlap.py``) or, for a
    stack of one period, which runs serially, one launch a streamed leaf
    (0 when the mode streams nothing in the layer loop)."""
    from repro_torch.models.lm import block_program
    program = block_program(cfg)
    periods = cfg.n_layers // len(program)
    fusable = periods * sum(FAMILY_PRODUCTS["attn"] * (d.seq == "attn")
                            + FAMILY_PRODUCTS["mlp"] * (d.ffn == "mlp")
                            for d in program)
    other = periods * sum(
        (FAMILY_PRODUCTS[d.seq] if d.seq != "attn" else 0)
        + ((1 + 3 * cfg.n_experts) if d.ffn == "moe" else 0)
        for d in program)
    flat = 1 + (not cfg.tie_embeddings)
    zero = dict.fromkeys(KERNELS, 0)
    return {"dense": zero | {"dense_tile_matmul": fusable + other + 1},
            "stream": zero | {"enec_decode": flat + periods
                              * bpl.get("stream", 0),
                              "dense_tile_matmul": fusable + other + 1},
            "fused": zero | {"enec_decode": flat + periods
                             * bpl.get("fused", 0),
                             "decompress_matmul": fusable,
                             "dense_tile_matmul": other + 1}}


def _family_engine_run(label, model, params, codec, schedule, want_step):
    """One engine run: ``schedule`` lists (steps before, request ids), all
    4 requests x prompt 64 x 16 new tokens.  Checks each replay's and
    warm-up's launches against ``want_step`` and that the run launched the
    prefills', steps' and warm-ups' kernels and nothing else; returns the
    requests' logits, TTFT, TPOT, device ms a replay, busy share, peak GB,
    the launches and the engine."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import Engine, EngineConfig
    cfg = model.cfg
    ecfg = EngineConfig(max_slots=BATCH, queue_depth=2 * BATCH,
                        max_prompt_len=PROMPT, max_new_tokens=TOKENS,
                        collect_logits=True)
    prompts = _prompts(cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(model, params, ecfg, codec=codec)
    serve.reset_launch_counts()          # this run starts here ...
    reqs = []
    for steps_before, idx in schedule:
        for _ in range(steps_before):
            engine.step()
        reqs += [engine.submit(prompts[i], TOKENS, name=f"r{i}")
                 for i in idx]
    engine.run_until_idle()
    torch.cuda.synchronize()
    launches = serve.launch_counts()     # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    for i, req in enumerate(reqs):
        check(req.state == "done" and len(req.logits) == TOKENS,
              f"{label}: r{i} {req.state} with {len(req.logits)} tokens")
    check(engine.step_launches
          and all(st == want_step for st in engine.step_launches),
          f"{label}: launches a step {engine.step_launches[:1]} != "
          f"{want_step}")
    check(all(w == want_step
              for w in engine.captured.warmup_launches.values()),
          f"{label}: warm-up launches != one step's")
    total = {k: engine.prefill_launches[k]
             + sum(st[k] for st in engine.step_launches)
             + sum(w[k] for w in engine.captured.warmup_launches.values())
             for k in KERNELS}
    check(total == launches, f"{label}: launched {launches}, prefills + "
          f"steps + warm-ups {total}")
    steady = [(t, ms) for t, ms, c in zip(engine.step_times_s,
                                          engine.step_device_ms,
                                          engine.step_captured) if not c]
    check(steady and all(ms is not None and ms > 0 for _, ms in steady),
          f"{label}: a replay without a device time")
    tpot = 1e3 * sum(t for t, _ in steady) / len(steady)
    dev_ms = sum(ms for _, ms in steady) / len(steady)
    return {"logits": [[t.clone() for t in r.logits] for r in reqs],
            "tokens": [list(r.tokens) for r in reqs],
            "ttft_ms": 1e3 * sum(r.ttft_s() for r in reqs) / len(reqs),
            "tpot_ms": tpot, "device_ms": dev_ms,
            "busy_share": dev_ms / tpot, "peak_gb": peak / 1e9,
            "launches": launches,
            "launches_per_step": engine.step_launches[0],
            "compiled_buckets": engine.stats()["engine"]["compiled_buckets"],
            "step_buckets": engine.step_buckets,
            "capture_ms": {b: 1e3 * t
                           for b, t in engine.captured.capture_s.items()},
            "engine": engine}


def _xlstm_handoff(model, params) -> dict:
    """(d) xLSTM's recurrent state after a batch-1 prefill and 16 decode
    steps against a prefill of the same 80 tokens, teacher-forced: bitwise
    where the bits match, else the largest gap (the reference's own test
    holds it within 1e-4)."""
    import torch
    prompt = torch.as_tensor(_prompts(model.cfg.vocab_size)[0],
                             dtype=torch.int64, device="cuda")[None, :]
    max_len = PROMPT + TOKENS + 1
    logits, cache = model.prefill_fn(params, {"tokens": prompt}, max_len)
    fed = []
    for _ in range(TOKENS):
        tok = torch.argmax(logits, -1)
        fed.append(tok)
        logits, cache = model.decode_fn(params, cache, tok)
    tf_logits, tf_cache = model.prefill_fn(
        params, {"tokens": torch.cat([prompt, torch.stack(fed, 1)], 1)},
        max_len)
    gaps, equal = {}, True
    for pos, (e, tf_e) in enumerate(zip(cache["entries"],
                                        tf_cache["entries"])):
        for k in e:
            a, b = e[k], tf_e[k]
            equal &= torch.equal(a, b)
            fin = a > -1e29            # the stabilisers' initial -1e30
            gaps[f"{pos}/{k}"] = float((a - b)[fin].abs().max()) \
                if fin.any() else 0.0
    logits_equal = torch.equal(logits.view(torch.int32),
                               tf_logits.view(torch.int32))
    worst = max(gaps.values())
    check(equal or worst <= 1e-4, f"xlstm handoff: state off by {worst}")
    return {"state_bitwise": bool(equal), "logits_bitwise": logits_equal,
            "max_state_gap": worst,
            "logits_gap": float((logits - tf_logits).abs().max())}


def _prefix_logits(model, params) -> "torch.Tensor":
    """(e) PaliGemma's prefill with 256 seeded prefix embeddings (the
    stubbed SigLIP frontend's output) before each prompt."""
    import torch
    gen = torch.Generator().manual_seed(2)
    pe = torch.randn((BATCH, PREFIX_EMBEDS, model.cfg.d_model),
                     generator=gen).to("cuda", torch.bfloat16)
    tokens = torch.as_tensor(_prompts(model.cfg.vocab_size),
                             dtype=torch.int64, device="cuda")
    logits, cache = model.prefill_fn(
        params, {"tokens": tokens, "prefix_embeds": pe},
        PREFIX_EMBEDS + PROMPT + 1)
    check(int(cache["lengths"][0]) == PREFIX_EMBEDS + PROMPT,
          f"prefix prefill lengths {cache['lengths'].tolist()}")
    return logits


def _matmul_row(label, x, w_bytes, k, n, kernel, plain, library, flush,
                f32: bool, relative: bool = False, reps=(20, 3, 20)) -> dict:
    """One product held within MATMUL_ATOL of its plain version (times the
    larger of 1 and the output's magnitude when ``relative``: f32 operands
    round the two sums' orders apart) and timed beside it, torch.matmul
    and its bound (``w_bytes`` of weight, x and the f32 out once; the
    products at the peak of their type) over ``reps`` calls of the
    kernel, the plain version and the library."""
    import torch
    m = x.shape[0]
    got, want = kernel(), plain()
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max())) if relative else 1.0
    check(err <= MATMUL_ATOL * scale, f"{label} at M = {m} errs {err} from "
          f"the plain version (tolerance {MATMUL_ATOL} x {scale})")
    bitwise = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
    del got, want
    flops = F32_FLOPS if f32 else BF16_FLOPS
    bound = 1e3 * max((w_bytes + x.numel() * x.element_size() + m * n * 4)
                      / HBM_BYTES_PER_S, 2 * m * k * n / flops)
    return {"k": k, "n": n, "m": m, "max_abs_err": err, "scale": scale,
            "bitwise": bitwise,
            "ms": cuda_ms(kernel, reps[0], flush),
            "plain_ms": cuda_ms(plain, reps[1], flush),
            "library_ms": cuda_ms(library, reps[2], flush),
            "bound_ms": bound,
            "bound_by": "bytes" if bound > 1e3 * 2 * m * k * n / flops
            else "operations"}


def _dense(leaf):
    from repro_torch.runtime.weights import is_handle
    return leaf.materialize() if is_handle(leaf) else leaf


def _dense_tile_checks(label, leaves, head, ms, head_ms) -> dict:
    """Kernel 2' on layer 0 of each distinct weight shape among
    ``leaves`` ((name, stacked leaf, f32 rows) triples) at each M of
    ``ms``, and on ``head`` ((name, weight) or None) at each M of
    ``head_ms``, each against ``kernels/ref.py:tiled_matmul_ref``."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decompress_matmul import dense_matmul_cuda
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    shapes = {}
    for name, leaf, f32 in leaves:
        w = _dense(leaf)[0]
        if w.ndim == 3:                  # (E, K, N): expert 0
            w = w[0]
        shapes.setdefault((tuple(w.shape), w.dtype, f32), (name, w, f32, ms))
    if head is not None:
        shapes["head"] = head + (False, head_ms)
    rows = {}
    for name, w, f32, m_list in shapes.values():
        k, n = w.shape
        for m in m_list:
            x = torch.randn((m, k), generator=gen, device="cuda")
            x = x if f32 else x.bfloat16()
            wl = w if w.dtype == x.dtype else w.to(x.dtype)
            rows[f"{name} M={m}"] = _matmul_row(
                f"{label}: kernel 2' on {name} {k} x {n}", x,
                w.numel() * w.element_size(), k, n,
                lambda: dense_matmul_cuda(x, w),
                lambda: ref.tiled_matmul_ref(x, w),
                lambda: torch.matmul(x, wl), flush_buf.zero_, f32)
            del wl
    del flush_buf
    return rows


def _fused_checks(label, tree, ms) -> dict:
    """Fused kernel 2 on layer 0 of each distinct fused leaf shape of
    ``tree`` at each M of ``ms``, each against ``decompress_matmul_plain``
    (the plain decode, then the tiled matmul); bound: the tile streams at
    true length, x and out once."""
    import torch
    from repro_torch.kernels.decompress_matmul import (
        decompress_matmul_cuda, decompress_matmul_plain)
    from repro_torch.runtime.weights import FusedWeight
    from repro_torch.runtime.streaming import tree_leaves
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(17)
    shapes = {}
    for path, leaf in tree_leaves(tree):
        if isinstance(leaf, FusedWeight):
            shapes.setdefault((leaf.k, leaf.n), (path, leaf.layer(0)))
    rows = {}
    for path, h in shapes.values():
        k, n = h.k, h.n
        w = h.materialize()
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
            rows[f"{path} M={m}"] = _matmul_row(
                f"{label}: kernel 2 on {path} {k} x {n}", x,
                needed_bytes(h.ct.streams), k, n,
                lambda: decompress_matmul_cuda(x, h.ct, k, n),
                lambda: decompress_matmul_plain(x, h.ct, k, n),
                lambda: torch.matmul(x, w), flush_buf.zero_, False)
        del w
    del flush_buf
    return rows


def _family_dense_tile_checks(cfg, params) -> dict:
    """Kernel 2' on layer 0 of each distinct weight shape of the dense
    tree (every product of the recurrent blocks, attention, MLP, router
    and expert) at M = BATCH (a decode step) and PROMPT (a prefill), and
    on the head at M = BATCH (a prefill takes the last position's
    logits)."""
    leaves = [(f"{block}/{name}", p[block][name], name in F32_ROWS)
              for p in params["period"]
              for block, names in FAMILY_MATMUL_LEAVES.items()
              for name in (names if block in p else ())]
    head = _dense(params["embed"]).T if cfg.tie_embeddings \
        else _dense(params["head"])
    return _dense_tile_checks(
        f"families {cfg.name}", leaves,
        ("head" + " (embed.T)" * cfg.tie_embeddings, head), (BATCH, PROMPT),
        (BATCH,))


def _family_fused_checks(cfg, params) -> dict:
    """Fused kernel 2 on each distinct fused leaf shape of the periods at
    M = BATCH and PROMPT."""
    return _fused_checks(f"families {cfg.name}", params["period"],
                         (BATCH, PROMPT))


def _einsum_decode_attention(q, k_cache, v_cache, lengths):
    """The control: decode attention with the library's batched products
    (``einsum``) and sums, the form ``layers.decode_attention`` replaced."""
    import math

    import torch
    from repro_torch.models import layers
    scores = layers._chunk_scores(q, k_cache, 1.0 / math.sqrt(q.shape[3]))
    k_pos = torch.arange(k_cache.shape[1], device=q.device)
    scores = scores + torch.where(k_pos < lengths[:, None, None, None],
                                  0.0, -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = p / p.sum(dim=-1, keepdim=True)
    return layers._chunk_out(probs.to(layers.ACT_DTYPE), v_cache,
                             q.shape[2])


def _graph_ms(fn, stream) -> float:
    """Device ms of one replay of ``fn`` captured as a CUDA graph on
    ``stream``, as the engine's step runs it (an eager call's window
    holds the host's enqueue of each of its kernels).  Every call shares
    one stream: cuBLAS keeps a workspace for each stream it has run on."""
    import torch
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                 # warm-up, outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    ms = cuda_ms(graph.replay, 20, spin=True)
    del graph
    return ms


def _decode_attention_rows(card) -> dict:
    """``layers.decode_attention`` at each attention family's heads and
    both caches of DECODE_ATTN_CACHES: every row of a batch of 4 (ragged
    lengths) bitwise equal to the row alone.  The einsum control's rows
    that differ alone are logged, not held (the witness that the library
    picks its summation order by the batch's shape); both forms timed at
    batch 4, each a replay of its CUDA graph (:func:`_graph_ms`)."""
    import torch
    from repro_torch.models.layers import decode_attention
    gen = torch.Generator(device="cuda").manual_seed(5)
    forms = {"fixed": decode_attention, "einsum": _einsum_decode_attention}
    stream = torch.cuda.Stream()
    before = torch.cuda.memory_allocated()
    rows = {}
    for arch, (h, kv, hd) in DECODE_ATTN_HEADS.items():
        for s_len in DECODE_ATTN_CACHES:
            q = torch.randn((BATCH, 1, h, hd), generator=gen,
                            device="cuda").bfloat16()
            k, v = (torch.randn((BATCH, s_len, kv, hd), generator=gen,
                                device="cuda").bfloat16() for _ in "kv")
            lengths = torch.tensor([s_len - 3, 40, 7, s_len], device="cuda")
            row = {}
            for name, fn in forms.items():
                full = fn(q, k, v, lengths)
                row[f"{name}_rows_differing"] = [
                    i for i in range(BATCH) if not torch.equal(
                        fn(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                           lengths[i:i + 1]).view(torch.int32),
                        full[i:i + 1].view(torch.int32))]
                row[f"{name}_ms"] = _graph_ms(lambda: fn(q, k, v, lengths),
                                              stream)
            check(not row["fixed_rows_differing"],
                  f"decode attention at {arch}'s heads, cache {s_len}: rows "
                  f"{row['fixed_rows_differing']} differ alone")
            rows[f"{arch} {h}/{kv}x{hd} S={s_len}"] = row
    del q, k, v, lengths, full
    torch.cuda.synchronize()
    left_gb = (torch.cuda.memory_allocated() - before) / 1e9
    check(left_gb < 0.1, f"decode attention witness left {left_gb:.3f} GB "
          f"allocated on the card")
    log(f"families: decode attention rows independent of the batch at "
        f"every shape; the einsum control's rows differing alone and both "
        f"forms' device ms a graph replay at batch 4: {rows}; {left_gb:.3f} "
        f"GB left allocated, on {card}")
    return rows


def _family_case(arch: str, card: str) -> tuple:
    """One family in dense, stream and fused modes: checks (a)-(e) of
    :func:`phase_families`; returns the results and each run's
    launches."""
    import torch
    from repro_torch.core.codec_api import Codec, use_codec
    from repro_torch.models import build_model
    from repro_torch.runtime.overlap import build_schedule, overlap_enabled
    from repro_torch.runtime.streaming import (assign_weight_modes,
                                               stream_stats, tree_leaves)
    from repro_torch.runtime.weights import StreamedWeight
    cfg = family_cfg(arch)
    model = build_model(cfg)
    prompts = _prompts(cfg.vocab_size)
    max_len = PROMPT + TOKENS
    bpl, runs, res, launches = {}, {}, {}, {}
    staggered = [(0, [0]), (2, [1]), (2, [2, 3])]
    for mode in ("dense", "stream", "fused"):
        codec = Codec()
        with use_codec(codec):
            t0 = time.perf_counter()
            params = assign_weight_modes(
                model.init(seed=0, device="cuda"), mode=mode,
                min_bytes=MIN_BYTES, shards=2, codec=codec)
            setup_s = _sync_s(t0)
            torch.cuda.empty_cache()
            n_periods = cfg.n_layers // len(params["period"])
            if overlap_enabled("auto", params["period"], n_periods):
                bpl[mode] = build_schedule(params["period"],
                                           n_periods).buckets_per_layer
            else:       # serial: each streamed leaf decodes as it runs
                bpl[mode] = sum(isinstance(leaf, StreamedWeight) for _, leaf
                                in tree_leaves(params["period"]))
            want = family_step_launches(cfg, bpl)[mode]
            label = f"families {arch} {mode}"
            together = _family_engine_run(f"{label} together", model,
                                          params, codec,
                                          [(0, range(BATCH))], want)
            check(together["compiled_buckets"] == [BATCH],
                  f"{label}: buckets {together['compiled_buckets']}")
            profile = _replay_profile(together.pop("engine"))
            stag = _family_engine_run(f"{label} staggered", model, params,
                                      codec, staggered, want)
            stag.pop("engine")
            check(stag["compiled_buckets"] == [1, 2, 4],
                  f"{label}: staggered buckets {stag['compiled_buckets']}")
            # (b) the bucket-4 replays against the eager step
            bucket_outs, bucket_secs = eager_bucket_loop(model, params,
                                                         prompts, max_len)
            for i in range(BATCH):
                check(_bits_equal(together["logits"][i], bucket_outs[i]),
                      f"{label}: r{i}'s bucket-{BATCH} replays differ from "
                      f"the eager bucket-{BATCH} step")
                check(_bits_equal(stag["logits"][i],
                                  together["logits"][i]),
                      f"{label}: r{i} staggered differs from together")
            del bucket_outs
            extra = {}
            if mode == "dense":
                # (a) each request alone, by the eager one-shot loop
                alone = [one_shot_alone(model, params, p, max_len)
                         for p in prompts]
                for i, (outs, _) in enumerate(alone):
                    check(_bits_equal(together["logits"][i], outs),
                          f"{label}: r{i} differs from it served alone")
                extra["eager_alone_tpot_ms"] = 1e3 * sum(
                    sum(s) for _, s in alone) / sum(len(s) for _, s in alone)
                del alone
                if cfg.family == "ssm":
                    extra["handoff"] = _xlstm_handoff(model, params)
            if cfg.prefix_embed:
                extra["prefix_logits"] = _prefix_logits(model, params)
            checks = {"dense": _family_dense_tile_checks,
                      "fused": _family_fused_checks}.get(mode)
            kernel_rows = checks(cfg, params) if checks else {}
            stats = stream_stats(params)
            del params
        torch.cuda.empty_cache()
        launches[f"families_{arch}_{mode}"] = together["launches"]
        run = {k: v for k, v in together.items() if k != "logits"}
        run.update(setup_s=setup_s, profile=profile,
                   staggered={k: v for k, v in stag.items()
                              if k != "logits"},
                   eager_bucket_tpot_ms=1e3 * sum(bucket_secs)
                   / len(bucket_secs), want_step=want,
                   hbm_ratio=stats["hbm_ratio"],
                   streamed=stats["streamed_tensors"],
                   fused=stats["fused_tensors"], kernel_checks=kernel_rows)
        runs[mode] = (together["logits"], together["tokens"], extra)
        res[mode] = run | {k: v for k, v in extra.items()
                           if k != "prefix_logits"}
        log(f"families {arch} {mode}: set-up {setup_s:.2f} s, TTFT "
            f"{run['ttft_ms']:.2f} ms, TPOT {run['tpot_ms']:.3f} ms "
            f"(captured; eager bucket-{BATCH} step "
            f"{run['eager_bucket_tpot_ms']:.3f} ms), device "
            f"{run['device_ms']:.3f} ms a replay (busy share "
            f"{run['busy_share']:.3f}), peak {run['peak_gb']:.2f} GB, "
            f"launches a step {run['launches_per_step']}, a replay's "
            f"profile {profile}, hbm ratio {stats['hbm_ratio']:.4f}"
            + (f", handoff {extra['handoff']}" if "handoff" in extra else "")
            + f" on {card}")
        if kernel_rows:
            kname = {"dense": "2' dense-tile", "fused": "2 fused"}[mode]
            log(f"families {arch} {mode}: kernel {kname} held against its "
                f"plain version at every distinct shape (max_abs_err, "
                f"bitwise; ms / plain / library / bound): " + "; ".join(
                    f"{name} {r['k']}x{r['n']}: {r['max_abs_err']:.3g}, "
                    f"{r['bitwise']}; {r['ms']:.4f} / {r['plain_ms']:.3f} / "
                    f"{r['library_ms']:.4f} / {r['bound_ms']:.4f}"
                    for name, r in kernel_rows.items()) + f" on {card}")
    ref_logits, ref_tokens, ref_extra = runs["dense"]
    for mode in ("stream", "fused"):
        logits, tokens, extra = runs[mode]
        check(tokens == ref_tokens, f"families {arch} {mode}: greedy tokens "
              f"differ from dense")
        for i in range(BATCH):
            check(_bits_equal(logits[i], ref_logits[i]),
                  f"families {arch} {mode}: r{i} not bitwise equal to dense")
        if cfg.prefix_embed:
            check(torch.equal(extra["prefix_logits"].view(torch.int32),
                              ref_extra["prefix_logits"].view(torch.int32)),
                  f"families {arch} {mode}: prefix prefill differs from "
                  f"dense")
    check(all(bool(torch.isfinite(t).all()) and t.shape == (cfg.vocab_size,)
              for r in ref_logits for t in r),
          f"families {arch}: non-finite or mis-shaped logits")
    if cfg.prefix_embed:
        pl = ref_extra["prefix_logits"]
        check(bool(torch.isfinite(pl).all())
              and pl.shape == (BATCH, cfg.vocab_size),
              f"families {arch}: prefix logits {tuple(pl.shape)}")
    log(f"families {arch}: (a) {BATCH} requests bitwise equal across dense /"
        f" stream / fused and to each served alone; (b) bucket-{BATCH} "
        f"replays equal the eager step, the staggered join (buckets 1, 2, "
        f"4) equal to together; (c) launches a replay as read from the code"
        + ("; (d) state handoff" if cfg.family == "ssm" else "")
        + ("; (e) prefix prefill bitwise across modes"
           if cfg.prefix_embed else "")
        + f"; seq0 {ref_tokens[0]}")
    return {"layers": cfg.n_layers, "buckets_per_layer": bpl,
            "modes": res, "card": card}, launches


def phase_families():
    """xlstm_125m, paligemma_3b and jamba_v0_1_52b at published widths,
    cut to ``FAMILY_LAYERS`` layers, each from seeded
    synthetic weights, in dense, stream and fused mode through the engine
    (each bucket's step a CUDA graph): 4 requests x prompt 64 x 16 new
    tokens, submitted together (bucket 4) and staggered (buckets 1, 2, 4).
    Checks (a) each request's logits bitwise equal across the three modes
    and to the request served alone by the eager one-shot loop; (b) the
    bucket-4 replays bitwise equal to the eager step, and the staggered
    run to the together run; (c) each replay's launches equal one step's
    read from the code (:func:`family_step_launches`); (d) xLSTM's
    recurrent state after a prefill and 16 steps equal to a teacher-forced
    prefill of the same tokens; (e) PaliGemma's prefill with 256 prefix
    embeddings bitwise equal across the modes; (f) kernel 2' at every
    distinct weight shape of the dense tree and the head, and fused
    kernel 2 at every fused leaf shape, within MATMUL_ATOL of their plain
    versions (:func:`_family_dense_tile_checks`,
    :func:`_family_fused_checks`); (g) the decode attention's rows
    independent of the batch (:func:`_decode_attention_rows`).  Each
    model and mode logs
    TTFT, captured TPOT, device ms a replay, busy share, peak GB, and the
    kernel launches and ms a step by kernel (a profile of 5 replays)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left_gb = torch.cuda.memory_allocated() / 1e9
    log(f"families: {left_gb:.3f} GB allocated from the earlier phases")
    check(left_gb < 1.0, f"families: the earlier phases left {left_gb:.3f} "
          f"GB allocated on the card")
    card = card_line()
    cases, launches = {}, {}
    for arch in FAMILY_ARCHS:
        cases[arch], got = _family_case(arch, card)
        launches.update(got)
    # after the families: the cuBLAS workspace of its stream stays
    attention = _decode_attention_rows(card)
    RESULTS["families"] = {"card": card, "cases": cases,
                           "decode_attention": attention}
    return launches


# ---------------------------------------------------------------------------
# phase api: the quickstart flow of the tree-level codec API
# ---------------------------------------------------------------------------

def phase_api():
    """``examples/quickstart.py``'s flow on the card over the ten Table III
    weight sets (``data/synthetic_weights.py``): ``search_for_array`` on
    each set, ``Codec.compress_tree`` of all ten (one encode launch per
    bucket), every record to the wire and back, ``decompress_tree`` bitwise
    equal to the sets, ``tree_ratio``.  Each set's ratio and wire record
    must equal the port's plain CPU path's, which
    tests/test_torch_core_api.py holds byte-identical to the JAX package's.
    The sets are 1-8 Mi elements, so the compress / decompress rates are
    set by launches and host work, not by the card's bandwidth."""
    import numpy as np
    import torch
    from repro_torch.core import (Codec, format_for, search_for_array,
                                  tree_ratio, wire)
    from repro_torch.data.synthetic_weights import PAPER_MODELS, generate
    from repro_torch.launch import serve
    card = card_line()
    host = {s.name: generate(s, device="cpu") for s in PAPER_MODELS}
    tree = {n: x.to("cuda") for n, x in host.items()}
    searched = {}
    for n, x in host.items():
        signed = {2: torch.int16, 4: torch.int32}[x.element_size()]
        unsigned = {2: np.uint16, 4: np.uint32}[x.element_size()]
        searched[n] = search_for_array(
            x.view(signed).numpy().view(unsigned),
            format_for(x.dtype)).astuple()
    codec = Codec()
    raw = sum(x.numel() * x.element_size() for x in tree.values())
    codec.compress_tree(tree)            # a warm-up: the kernels' first use
    torch.cuda.synchronize()
    serve.reset_launch_counts()          # this path's run starts here ...
    plan = codec.plan_encode(tree)
    t0 = time.perf_counter()
    ctree = codec.execute(plan)
    compress_s = _sync_s(t0)
    enc_launches = serve.launch_counts()
    check(enc_launches["enec_encode"] == len(plan.buckets),
          f"api: {enc_launches['enec_encode']} encode launches for "
          f"{len(plan.buckets)} buckets")
    records = {n: wire.to_wire(c) for n, c in ctree.items()}
    back = {n: wire.from_wire(r, codec=codec, device="cuda")
            for n, r in records.items()}
    dplan = codec.plan_decode(back)
    serve.reset_launch_counts()
    t0 = time.perf_counter()
    out = codec.execute(dplan)
    decompress_s = _sync_s(t0)
    dec_launches = serve.launch_counts()    # ... and ends here
    check(dec_launches["enec_decode"] == len(dplan.buckets),
          f"api: {dec_launches['enec_decode']} decode launches for "
          f"{len(dplan.buckets)} buckets")
    for n, x in tree.items():
        check(torch.equal(out[n].view(torch.uint8), x.view(torch.uint8)),
              f"api: {n} not bitwise equal after the wire round trip")
    ratio = tree_ratio(ctree)
    cpu_codec = Codec()
    cpu_tree = cpu_codec.compress_tree(host)
    cpu_ratio = tree_ratio(cpu_tree)
    for n in tree:
        check(records[n] == wire.to_wire(cpu_tree[n]),
              f"api: {n}'s record differs from the plain CPU path's")
    check(ratio == cpu_ratio, f"api: tree_ratio {ratio} != CPU {cpu_ratio}")
    per_set = {n: c.ratio() for n, c in ctree.items()}
    res = {"card": card, "ratios": per_set, "tree_ratio": ratio,
           "searched_params": searched,
           "params": {n: c.params.astuple() if c.params else None
                      for n, c in ctree.items()},
           "raw_bytes": raw, "compress_s": compress_s,
           "decompress_s": decompress_s,
           "compress_gb_s": raw / compress_s / 1e9,
           "decompress_gb_s": raw / decompress_s / 1e9,
           "encode_buckets": len(plan.buckets),
           "decode_buckets": len(dplan.buckets)}
    RESULTS["api"] = res
    log(f"api: ten Table III sets ({raw / 1e6:.1f} MB) compress_tree in "
        f"{compress_s * 1e3:.2f} ms ({res['compress_gb_s']:.2f} GB/s, "
        f"{len(plan.buckets)} encode launches), decompress_tree "
        f"{decompress_s * 1e3:.2f} ms ({res['decompress_gb_s']:.2f} GB/s, "
        f"{len(dplan.buckets)} decode launches): sets of 1-8 Mi elements, "
        f"so both rates are set by launches and host work; ratios "
        f"{ {n: round(r, 6) for n, r in per_set.items()} }, tree_ratio "
        f"{ratio}, records and ratios equal to the plain CPU path's, the "
        f"wire round trip bitwise; host-searched params {searched} on "
        f"{card}")
    return {"api": dec_launches | {"enec_encode": enc_launches[
        "enec_encode"]}}


# ---------------------------------------------------------------------------
# phase whisper: the encoder-decoder through prefill_fn and a captured step
# ---------------------------------------------------------------------------

WHISPER_ARCH = "whisper_tiny"
WHISPER_FRAMES = 4096       # the reference's ENC_FRAMES_STUB
WHISPER_MAX_LEN = PROMPT + TOKENS + 8   # the staggered rows' extra steps
# when each request joins the staggered run: row 0 at step 0, row 1 at 2,
# rows 2 and 3 at 4 (buckets 1, 2, 4)
WHISPER_JOINS = ((0, [0]), (2, [1]), (4, [2, 3]))
# the decoder's products a step, by subtree: self attention, cross
# attention (its memory K/V are cached), MLP
WHISPER_STEP_LEAVES = {"attn": ("wq", "wk", "wv", "wo"),
                       "xattn": ("wq", "wo"),
                       "mlp": ("w_gate", "w_up", "w_down")}


def whisper_step_launches(params, n_layers: int) -> dict:
    """One decode step's launches, read from the code and the tree: each
    product of a layer through ``weight_matmul`` (a fused leaf: kernel 2;
    a streamed leaf: kernel 1 at resolve, then 2'; a dense or raw leaf:
    2'), the embed and the untied head materialized once a step when
    streamed (kernel 1), and the head's one 2' launch (``lm_logits``)."""
    from repro_torch.runtime.weights import FusedWeight, StreamedWeight
    n = dict.fromkeys(KERNELS, 0)
    for sub, names in WHISPER_STEP_LEAVES.items():
        for name in names:
            leaf = params["dec_stack"][sub][name]
            if isinstance(leaf, FusedWeight):
                n["decompress_matmul"] += n_layers
                continue
            if isinstance(leaf, StreamedWeight):
                n["enec_decode"] += n_layers
            n["dense_tile_matmul"] += n_layers
    for name in ("embed", "head"):
        n["enec_decode"] += isinstance(params[name], StreamedWeight)
    n["dense_tile_matmul"] += 1
    return n


def _whisper_alone(model, params, frames, prompts):
    """Each request served alone by the eager one-shot loop, the
    reference's way of serving whisper (``runtime/steps.py``'s prefill and
    decode steps): a batch-1 prefill of frames and prompt, then the decode
    step.  Returns each request's logits per token, its prefill's cache
    (for the slot runs), the prefills' seconds."""
    import torch
    from repro_torch.runtime.steps import build_decode_step, build_prefill_step
    prefill = build_prefill_step(model, WHISPER_MAX_LEN)
    decode = build_decode_step(model)
    outs, caches, ttft = [], [], []
    for r, prompt in enumerate(prompts):
        tokens = torch.as_tensor(prompt, dtype=torch.int64, device="cuda")
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"frames": frames[r][None],
                                         "tokens": tokens[None]})
        ttft.append(_sync_s(t0))
        caches.append((logits, {k: v.clone() for k, v in cache.items()}))
        tok = torch.argmax(logits, -1)
        row = [logits[0]]
        for _ in range(TOKENS - 1):
            logits, cache = decode(params, cache, tok)
            tok = torch.argmax(logits, -1)
            row.append(logits[0])
        outs.append(row)
    return outs, caches, ttft


def _whisper_slots(model, params, caches, joins, captured: bool):
    """The step on fixed buffers (``encdec.decode_step``), requests
    joining at the steps of ``joins`` ((step, rows) pairs) and each step's
    bucket the next power of two over the rows joined; captured (one CUDA
    graph a bucket, ``runtime/captured.py``) or eager.  Returns each row's
    logits over its first TOKENS tokens, the host seconds a step, and the
    CapturedStep (None when eager)."""
    import torch
    from repro_torch.models import encdec
    from repro_torch.runtime.captured import CapturedStep
    state = model.init_step_state(BATCH, WHISPER_MAX_LEN,
                                  enc_len=WHISPER_FRAMES, device="cuda")
    step = CapturedStep(lambda b: model.decode_step(params, state, b),
                        "cuda", BATCH) if captured else None
    outs = [[] for _ in range(BATCH)]
    pending = dict(joins)
    joined, secs, i = [], [], 0
    while len(joined) < BATCH or any(len(o) < TOKENS for o in outs):
        for r in pending.pop(i, []):
            logits, cache = caches[r]
            encdec.load_prefill(state, cache, r)
            state["tokens"][r] = torch.argmax(logits[0], -1)
            outs[r].append(logits[0])
            joined.append(r)
        bucket = 1 << (len(joined) - 1).bit_length()
        saved = (state["tokens"].clone(), state["lengths"].clone())

        def load():
            state["tokens"].copy_(saved[0])
            state["lengths"].copy_(saved[1])

        t0 = time.perf_counter()
        if step is None:
            model.decode_step(params, state, bucket)
        else:
            step.run(bucket, load)
        state["tokens"].tolist()
        secs.append(time.perf_counter() - t0)
        for r in joined:
            if len(outs[r]) < TOKENS:
                outs[r].append(state["logits"][r].clone())
        i += 1
    return outs, secs, step


def _whisper_kernel_checks(label, mode, params) -> dict:
    """Dense mode: kernel 2' on each distinct shape of the encoder's and
    the decoder's products at M = BATCH (a decode step), PROMPT (a
    prefill) and WHISPER_FRAMES (the encoder, and the cross attention's
    memory K / V), and on the untied head at M = BATCH; fused mode: kernel
    2 on each distinct fused leaf shape at the same Ms; each against its
    plain version (:func:`_dense_tile_checks`, :func:`_fused_checks`)."""
    stacks = {s: params[s] for s in ("enc_stack", "dec_stack")}
    ms = (BATCH, PROMPT, WHISPER_FRAMES)
    if mode == "fused":
        return _fused_checks(label, stacks, ms)
    if mode != "dense":
        return {}
    leaves = [(f"{s}/{sub}/{name}", leaf, False)
              for s, tree in stacks.items()
              for sub in ("attn", "xattn", "mlp") if sub in tree
              for name, leaf in tree[sub].items()]
    return _dense_tile_checks(label, leaves, ("head", _dense(params["head"])),
                              ms, (BATCH,))


def _whisper_mode(model, cfg, mode, frames, prompts) -> tuple:
    import torch
    from repro_torch.core.codec_api import Codec, use_codec
    from repro_torch.kernels import build
    from repro_torch.runtime.streaming import assign_weight_modes, mode_mix
    label = f"whisper {mode}"
    torch.cuda.reset_peak_memory_stats()
    codec = Codec()
    with use_codec(codec):
        t0 = time.perf_counter()
        params = assign_weight_modes(model.init(seed=0, device="cuda"),
                                     mode=mode, min_bytes=MIN_BYTES,
                                     shards=2, codec=codec)
        setup_s = _sync_s(t0)
        want = whisper_step_launches(params, cfg.n_layers)
        build.restore(dict.fromkeys(build.counts(), 0))
        alone, caches, ttft = _whisper_alone(model, params, frames, prompts)
        together, tpot, step = _whisper_slots(
            model, params, caches, [(0, list(range(BATCH)))], True)
        launches = build.counts()
        replay = step.graphs[BATCH].launches
        before = build.counts()
        eager, eager_secs, _ = _whisper_slots(
            model, params, caches, [(0, list(range(BATCH)))], False)
        # the eager run is TOKENS - 1 steps and launches nothing else
        eager_run = {k: v - before.get(k, 0)
                     for k, v in build.counts().items()}
        stag, _, stag_step = _whisper_slots(model, params, caches,
                                            WHISPER_JOINS, True)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        kernel_rows = _whisper_kernel_checks(label, mode, params)
    replay = {k: replay.get(k, 0) for k in KERNELS}
    eager_run = {k: eager_run.get(k, 0) for k in KERNELS}
    check(replay == want, f"{label}: a replay's launches {replay} != one "
          f"step's read from the code {want}")
    check(eager_run == {k: v * (TOKENS - 1) for k, v in want.items()},
          f"{label}: {TOKENS - 1} eager steps launched {eager_run}, the "
          f"code says {want} a step")
    check(stag_step.buckets == [1, 2, BATCH],
          f"{label}: staggered buckets {stag_step.buckets}")
    for r in range(BATCH):
        check(_bits_equal(together[r], eager[r]), f"{label}: r{r}'s "
              f"bucket-{BATCH} replays differ from the eager step")
        check(_bits_equal(together[r], alone[r]),
              f"{label}: r{r} in the batch differs from it served alone")
        check(_bits_equal(stag[r], alone[r]),
              f"{label}: r{r} staggered differs from it served alone")
    for row in alone:
        check(all(bool(torch.isfinite(t).all()) for t in row),
              f"{label}: non-finite logits")
    res = {"setup_s": setup_s, "mode_mix": mode_mix(params),
           "ttft_ms": 1e3 * sum(ttft) / len(ttft),
           "tpot_ms": 1e3 * sum(tpot[1:]) / len(tpot[1:]),
           "tpot_eager_ms": 1e3 * sum(eager_secs) / len(eager_secs),
           "capture_s": step.capture_s, "launches_per_step": replay,
           "peak_gb": peak_gb, "kernel_checks": kernel_rows}
    log(f"{label}: TTFT {res['ttft_ms']:.2f} ms, TPOT captured "
        f"{res['tpot_ms']:.3f} / eager {res['tpot_eager_ms']:.3f} ms, "
        f"peak {res['peak_gb']:.2f} GB, set-up {setup_s:.2f}s, launches a "
        f"step {dict((k, v) for k, v in replay.items() if v)}")
    return res, launches, alone


def _check_mesh_whisper_ref(alone) -> None:
    """Phase mesh's one-device whisper steps (its first ``MESH_BATCH``
    requests prefilled together, ``MESH_TOKENS`` tokens), the yardstick
    of its mesh run, bitwise equal to the same requests served alone
    here (nothing to hold when phase mesh did not run)."""
    ref = MESH_WHISPER_REF.get("logits")
    if ref is None:
        return
    for r in range(MESH_BATCH):
        check(_bits_equal([ref[t, r] for t in range(MESH_TOKENS)],
                          [t.cpu() for t in alone[r][:MESH_TOKENS]]),
              f"whisper: phase mesh's one-device steps differ from r{r} "
              f"served alone")
    log(f"whisper: phase mesh's one-device yardstick (rows "
        f"{MESH_BATCH} together, {MESH_TOKENS} tokens) bitwise equal to "
        f"each request alone")


def phase_whisper():
    """whisper_tiny at full width (4 + 4 layers, d_model 384, vocab 51865)
    from seeded weights, served as the reference serves it: 4 requests x
    prompt 64 x 16 tokens, frames (4, 4096, 384) bf16, each request
    prefilled alone through ``prefill_fn``, then the step on fixed buffers
    (``encdec.decode_step``) captured at buckets 1, 2 and 4, in dense,
    stream and fused modes.  Checks: logits bitwise equal across the
    modes; the bucket-4 replays bitwise equal to the eager step; each row
    in the batch (together and staggered) bitwise equal to the request
    served alone; launches a replay (read from the counters) equal to an
    eager step's and to the code's count; kernels 2' (dense mode) and 2
    (fused mode) against their plain versions at whisper's shapes
    (:func:`_whisper_kernel_checks`).  Logs TTFT, TPOT and peak GB."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(WHISPER_ARCH)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randn((BATCH, WHISPER_FRAMES, cfg.d_model),
                         generator=gen, device="cuda").to(torch.bfloat16)
    prompts = _prompts(cfg.vocab_size)
    card = card_line()
    modes, launches, first = {}, {}, None
    for mode in ("dense", "stream", "fused"):
        modes[mode], launches[f"whisper_{mode}"], alone = _whisper_mode(
            model, cfg, mode, frames, prompts)
        if first is None:
            first = alone
            _check_mesh_whisper_ref(alone)
        for r in range(BATCH):
            check(_bits_equal(alone[r], first[r]),
                  f"whisper {mode}: r{r} differs from dense")
        del alone
    torch.cuda.empty_cache()
    RESULTS["whisper"] = {"card": card, "frames": WHISPER_FRAMES,
                          "modes": modes}
    log(f"whisper: logits bitwise equal across modes, to the eager step "
        f"and to each request alone ({card})")
    return launches


# ---------------------------------------------------------------------------
# phase train: single-device training through launch/train.py
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_RESUME = 6, 3
TRAIN_TOKENS = 8 * 128      # the launcher's default global batch x seq
TRAIN_VOCAB = 128256
# the products checked at M = TRAIN_TOKENS, (K, N): four of a layer's 7
# (every distinct shape) and the tied head (embed.T)
TRAIN_SHAPES = {"wq": (2048, 2048), "wk": (2048, 512),
                "w_gate": (2048, 8192), "w_down": (8192, 2048),
                "head (embed.T)": (2048, TRAIN_VOCAB)}
PLAIN_BYTES = 2 << 30       # the plain version's (M, 128, N) f32 partials


def train_step_launches(n_layers: int, policy) -> dict:
    """Kernel 2' launches of one train step, read from the code: every
    product (7 a layer and the tied head) forward, and its dX and dW
    backward (``kernels/ops.py:TiledMatmul``); under the remat policy
    ``nothing`` also the recompute of each layer's products but ``w_down``
    (its output feeds only the period's output, so checkpoint's early stop
    ends the recompute before it launches, as the reference's recompute
    drops it); ``dots`` launches no kept product again, and None is remat
    off (``models/remat.py``)."""
    recompute = n_layers * (len(LEAVES) - 1) if policy == "nothing" else 0
    return dict.fromkeys(KERNELS, 0) | {
        "dense_tile_matmul": 3 * (n_layers * len(LEAVES) + 1) + recompute}


def config_policy(cfg):
    """The remat policy a config trains under (None: remat off)."""
    return cfg.remat_policy if cfg.remat else None


def _plain_by_columns(a, b):
    """``tiled_matmul_ref`` over column strips of ``b`` (a column's bits
    depend on that column alone), each strip's partials within
    PLAIN_BYTES."""
    import torch
    from repro_torch.kernels.ref import tiled_matmul_ref
    cols = max(128, PLAIN_BYTES // (a.shape[0] * 128 * 4) // 128 * 128)
    return torch.cat([tiled_matmul_ref(a, b[:, j:j + cols])
                      for j in range(0, b.shape[1], cols)], 1)


def _train_backward_checks(m: int = TRAIN_TOKENS, shapes=None,
                           label: str = "train") -> dict:
    """The autograd Function on the card at M = ``m`` (TRAIN_TOKENS), for
    each product of ``shapes`` (TRAIN_SHAPES): its forward, dX and dW
    bitwise equal to kernel 2' on the same (forward) or transposed
    operands (dX = dY @
    W.T, dW = X.T @ dY, cast to the operand's dtype); kernel 2' there
    against the plain version (``_matmul_row``: the forward's bf16
    products within MATMUL_ATOL, the backward's f32 sums of the same
    products in another order within MATMUL_ATOL of the larger of 1 and
    the output's magnitude), timed beside its bound, the plain version and
    torch.matmul at the same shapes (f32 backward, TF32 off)."""
    import importlib
    import torch
    from repro_torch.kernels import ops
    # the module (``repro_torch.kernels`` exports a function of its name)
    dm = importlib.import_module("repro_torch.kernels.decompress_matmul")
    gen = torch.Generator(device="cuda").manual_seed(3)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = {}
    for name, (k, n) in (shapes or TRAIN_SHAPES).items():
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / math.sqrt(k)).bfloat16()
        if name.startswith("head"):      # the tied head: embed's strides
            w = w.T.contiguous().T
        dy = torch.randn((m, n), generator=gen, device="cuda")
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = ops.tiled_matmul(xa, wa)
        check(torch.equal(y.detach(), dm.dense_matmul_cuda(x, w)),
              f"{label} {name} forward: the Function's result differs from "
              f"kernel 2'")
        grads = torch.autograd.grad(y, (xa, wa), dy)
        del xa, wa, y
        row = {}
        for part, got, a, b in (("fwd", None, x, w),
                                ("dx", grads[0], dy, w.T),
                                ("dw", grads[1], x.T.contiguous(), dy)):
            if got is not None:
                check(torch.equal(got, dm.dense_matmul_cuda(a, b)
                                  .to(got.dtype)),
                      f"{label} {name} {part}: the Function's result differs "
                      f"from kernel 2' on the transposed operands")
            f32 = a.dtype == torch.float32 or b.dtype == torch.float32
            bf = b.float() if f32 else b
            af = a.float() if f32 else a
            row[part] = _matmul_row(
                f"{label} {name} {part}", a, b.numel() * b.element_size(),
                a.shape[1], b.shape[1], lambda: dm.dense_matmul_cuda(a, b),
                lambda: _plain_by_columns(a, b),
                lambda: torch.matmul(af, bf), flush_buf.zero_, f32,
                relative=f32, reps=(5, 1, 5))
            del af, bf
        del grads, dy
        rows[name] = row
        log(f"{label} {name} ({k} x {n}, M {m}): " + ", ".join(
            f"{part} {r['ms']:.3f} ms (matmul {r['library_ms']:.3f}, bound "
            f"{r['bound_ms']:.3f}, err {r['max_abs_err']:.2e} / scale "
            f"{r['scale']:.1f})" for part, r in row.items()))
    del flush_buf
    return rows


def _train_memory(out, save_over_gb: float) -> dict:
    """The device memory of the last run's state and, over it, the peak
    of each part of a train step (forward and backward; AdamW's apply with
    the gradients held; the whole step, ``runtime/steps.py``), in GB,
    beside ``save_over_gb``: the peak over the state of the blocking
    checkpoint save of ``{"params", "opt"}`` that the 3-step run made
    (:func:`_save_peak`; the same sizes of state).  Updates the state in
    place (AdamW's moments)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.api import tree_leaves, tree_map_with_path
    from repro_torch.data import pipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import build_train_step
    cfg = get_config("llama3_2_1b")
    model = build_model(cfg)
    params, opt = out["params"], out["opt_state"]
    opt_cfg = adamw.AdamWConfig(schedule=adamw.warmup_cosine(20, TRAIN_STEPS))
    data = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                               global_batch=8)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in pipeline.batch_at(data, TRAIN_STEPS).items()}

    def gb(tree):
        return sum(t.numel() * t.element_size()
                   for _, t in tree_leaves(tree)) / 1e9

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = fn()
        torch.cuda.synchronize()
        return got, (torch.cuda.max_memory_allocated() - base) / 1e9

    def fwd_bwd():
        leaves = tree_map_with_path(
            lambda _, p: p.detach().requires_grad_(True), params)
        flat = list(tree_leaves(leaves))
        with torch.enable_grad():
            loss, _ = model.loss_fn(leaves, batch)
            got = dict(zip([q for q, _ in flat], torch.autograd.grad(
                loss, [p for _, p in flat])))
        return tree_map_with_path(lambda q, _: got[q], params)

    res = {"params_gb": gb(params), "m_gb": gb(opt.m), "v_gb": gb(opt.v),
           "resident_gb": torch.cuda.memory_allocated() / 1e9}
    grads, res["fwd_bwd_over_gb"] = peak(fwd_bwd)
    res["grads_gb"] = gb(grads)
    _, res["apply_over_gb"] = peak(
        lambda: adamw.apply(opt_cfg, params, opt, grads))
    del grads
    step = build_train_step(model, opt_cfg)
    _, res["step_over_gb"] = peak(lambda: step(params, opt, batch))
    res["save_over_gb"] = save_over_gb
    log("train memory (GB): " + ", ".join(f"{k} {v:.2f}"
                                          for k, v in res.items()))
    return res


def _saves_skipped(skipped: list):
    """Patch the checkpoint's save so that a run writes none: for the runs
    whose final checkpoint no later check restores (each save of llama's
    12.5 GB training state takes ≈ 25-35 s on the host).  Each skipped
    save's step is appended to ``skipped``; returns the unpatch."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    save = CheckpointManager.save

    def skip(self, step, *args, **kw):
        skipped.append(step)

    CheckpointManager.save = skip
    return lambda: setattr(CheckpointManager, "save", save)


def _save_peak(marks: list):
    """Patch the checkpoint's save so that each save appends the peak of
    device memory over what was allocated before it, in GB (the cache
    emptied first, as ``_train_memory`` measures each part); returns the
    unpatch."""
    import torch
    from repro_torch.checkpoint.ckpt import CheckpointManager
    save = CheckpointManager.save

    def measured(self, *args, **kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        save(self, *args, **kw)
        torch.cuda.synchronize()
        marks.append((torch.cuda.max_memory_allocated() - base) / 1e9)

    CheckpointManager.save = measured
    return lambda: setattr(CheckpointManager, "save", save)


def _flat_state(out) -> list:
    from repro_torch.runtime.streaming import tree_leaves
    return list(tree_leaves({"params": out["params"],
                             "opt": out["opt_state"]}))


DIGEST_CHUNK = 1 << 26       # elements a pass: bounds the int64 temporaries


def leaf_digest(t) -> tuple:
    """Two integer sums of a tensor's bit patterns on its device: of the
    words, and of the words weighted by their index mod 65521 (plus one),
    so that a changed or moved word shows.  Integer sums wrap the same in
    any order: the digest is exact, and equal digests of two runs mean
    equal bits here."""
    import torch
    words = t.reshape(-1).view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32}[t.element_size()])
    total = weighted = 0
    for start in range(0, words.numel(), DIGEST_CHUNK):
        w = words[start:start + DIGEST_CHUNK].to(torch.int64)
        idx = torch.arange(start, start + w.numel(), device=w.device)
        total += int(w.sum())
        weighted += int((w * (idx % 65521 + 1)).sum())
    return total, weighted


def shard_digests(out, shape) -> list:
    """For each rank of a ``(data, model)`` mesh of ``shape``, the digest
    of every leaf of the whole training state ``out`` cut to that rank's
    shard (``elastic.train_pspecs``): what the rank holds after training
    to the same state on that mesh."""
    import math
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import abstract_params
    from repro_torch.configs import get_config
    from repro_torch.runtime import elastic, sharding
    out_ = []
    for rank in range(math.prod(shape)):
        mesh = Mesh(shape, ("data", "model"), rank=rank)
        specs = dict(sharding.spec_leaves(elastic.train_pspecs(
            abstract_params(get_config("llama3_2_1b")), mesh)))
        out_.append({path: leaf_digest(sharding.local_shard(t, specs[path],
                                                             mesh))
                     for path, t in _flat_state(out)})
    return out_


def phase_train():
    """llama3_2_1b at full width trained through ``launch/train.py``'s own
    code path at its defaults (global batch 8, seq 128, lr 3e-4,
    ``warmup_cosine(20, steps)``; while the step is under the 20 warm-up
    steps the schedule does not depend on ``--steps``): 6 steps
    uninterrupted; 3 steps, checkpointed; the same run resumed from that
    checkpoint to 6.  Only the 3-step run's checkpoint is written: the
    uninterrupted run's and the resumed run's final saves would never be
    read, so they are skipped (:func:`_saves_skipped`), and the 3-step
    run's save is the one whose peak the memory line reports.  Checks: the
    resumed run's params and AdamW state at step 6 bitwise equal to the
    uninterrupted run's; finite losses and gradient norms; kernel 2'
    launches a step equal to the code's count (forward, backward and the
    recompute of the config's remat policy, ``nothing``;
    ``train_step_launches``); the autograd Function's forward and backward
    against the plain version (:func:`_train_backward_checks`).  Logs
    seconds a step, the uninterrupted run's peak GB, and the step's and
    the save's own (:func:`_train_memory`)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import train
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    card = card_line()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    log(f"train: {shutil.disk_usage(tmp).free / 1e9:.1f} GB free under "
        f"{tmp}")
    base = ["--arch", "llama3_2_1b"]
    try:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9   # earlier phases' own
        build.restore(dict.fromkeys(build.counts(), 0))
        skipped = []
        unpatch = _saves_skipped(skipped)
        t0 = time.perf_counter()
        try:
            whole = train.main(base + ["--steps", str(TRAIN_STEPS),
                                       "--ckpt", str(tmp / "whole")])
        finally:
            unpatch()
        whole_s = _sync_s(t0)
        launches = build.counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(skipped == [TRAIN_STEPS]
              and not list((tmp / "whole").glob("step_*")),
              f"train: the uninterrupted run saved {skipped}")
        hist = whole["history"]
        check([h["step"] for h in hist] == list(range(TRAIN_STEPS)),
              f"train: steps {[h['step'] for h in hist]}")
        check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                  for h in hist), f"train: non-finite loss or grad norm "
              f"{hist}")
        policy = config_policy(get_config("llama3_2_1b"))
        want = train_step_launches(N_LAYERS, policy)["dense_tile_matmul"]
        check(launches["dense_tile_matmul"] == TRAIN_STEPS * want,
              f"train: 2' launched {launches['dense_tile_matmul']} times in "
              f"{TRAIN_STEPS} steps, the code says {want} a step")
        check(launches["decompress_matmul"] == 0
              and launches["enec_decode"] == 0,
              f"train: unexpected launches {launches}")
        save_gb = []
        unpatch = _save_peak(save_gb)
        t0 = time.perf_counter()
        try:
            first = train.main(base + ["--steps", str(TRAIN_RESUME),
                                       "--ckpt", str(tmp / "resume")])
        finally:
            unpatch()
        first_s = _sync_s(t0)
        check(len(save_gb) == 1, f"train: the 3-step run saved "
              f"{len(save_gb)} times")
        digest = shard_digests(first, TRAIN_MESH_FIRST)
        del first
        unpatch = _saves_skipped(skipped)
        t0 = time.perf_counter()
        try:
            resumed = train.main(base + ["--steps", str(TRAIN_STEPS),
                                         "--ckpt", str(tmp / "resume")])
        finally:
            unpatch()
        resumed_s = _sync_s(t0)
        check(skipped == [TRAIN_STEPS] * 2, f"train: saves skipped "
              f"{skipped}")
        check([h["step"] for h in resumed["history"]]
              == list(range(TRAIN_RESUME, TRAIN_STEPS)),
              f"train: resumed steps {resumed['history']}")
        for (pa, a), (pb, b) in zip(_flat_state(whole), _flat_state(resumed)):
            check(pa == pb and a.dtype == b.dtype and torch.equal(
                a.view(torch.int16) if a.element_size() == 2
                else a.view(torch.int32),
                b.view(torch.int16) if b.element_size() == 2
                else b.view(torch.int32)),
                f"train: {pa} of the resumed run differs from the "
                f"uninterrupted run")
        for h, r in zip(hist[TRAIN_RESUME:], resumed["history"]):
            check(h["loss"] == r["loss"] and h["grad_norm"] == r["grad_norm"],
                  f"train: step {h['step']} resumed {r} != {h}")
        del resumed
        memory = _train_memory(whole, save_gb[0])
        del whole
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    backward = _train_backward_checks()
    torch.cuda.empty_cache()
    dts = [h["dt_s"] for h in hist]
    res = {"card": card, "policy": policy, "history": hist,
           "s_per_step": dts,
           "s_per_step_mean": sum(dts[1:]) / len(dts[1:]),
           "peak_gb": peak, "held_gb": held, "memory": memory,
           "whole_s": whole_s,
           "first_s": first_s, "resumed_s": resumed_s, "launches_per_step": want,
           "backward": backward, "digest_first": digest}
    RESULTS["train"] = res
    log(f"train: {TRAIN_STEPS} steps, resumed run bitwise equal; "
        f"{res['s_per_step_mean']:.3f} s a step (steps 1-5; step 0 "
        f"{dts[0]:.3f} s), peak {peak:.2f} GB in the uninterrupted run "
        f"({held:.2f} held before the phase; the save's own in the memory "
        f"line), 2' launches a step {want} (remat {policy}); "
        f"runs {whole_s:.1f} / {first_s:.1f} / {resumed_s:.1f} s ({card})")
    return {"train": launches}


# ---------------------------------------------------------------------------
# phase mesh: the serving mesh over torch.distributed ranks
# ---------------------------------------------------------------------------

MESH_BATCH, MESH_TOKENS = 2, 3    # phase serve's first 2 requests, 3 tokens
MESH_WIDTHS = (2, 4)
MESH_ARGS = ["--batch", str(MESH_BATCH), "--prompt-len", str(PROMPT),
             "--tokens", str(MESH_TOKENS)]
# the sequence-sharded K/V ring (A = 2): 2 requests x prompt 2040 x 8
# tokens, a 2048-position ring of 2 x 1024, the prompt and the decoded
# positions crossing the ranks' boundary; once per decode-attention route
PROMPT_SP, SP_TOKENS = 2040, 8
SP_ARGS = ["--mode", "fused", "--batch", "2", "--prompt-len",
           str(PROMPT_SP), "--tokens", str(SP_TOKENS)]
SP_ROUTES = {"sp_scores": False, "sp_flash": True}   # decode_score_shard
# expert-parallel MoE serving (the runs labelled ep_*): phi3_5_moe at its
# published widths (D 4096, F 6400, 16 experts, top-2), depth cut 32 -> 2
# in the mesh worker as phase moe cuts it (the config's n_layers): the A
# ranks share one card, and each builds the whole tree before it keeps
# its share
EP_LAYERS = 2
EP_ARGS = ["--arch", MOE_ARCH]
# the Mamba states on the mesh (the run labelled jamba_dense): jamba at its
# published widths (d_inner 8192, d_state 16: h and conv both halve at
# A = 2) cut to one period, 8 layers, as phase families cuts it.  Dense
# mode: both ranks build the whole tree on the one card before they cut
# their share, 2 x 26.71 GB (phase families' dense peak at 8 layers, U4)
# against ≈ 2 x 31.7 GB in stream or fused mode
JAMBA_ARCH, JAMBA_MESH_LAYERS = "jamba_v0_1_52b", 8
JAMBA_MESH_ARGS = ["--arch", JAMBA_ARCH, "--mode", "dense"]
# the encoder memory on the mesh (the run labelled whisper_stream, the
# mesh steps of runtime/steps.py: serve refuses an encoder-decoder):
# whisper_tiny at full width, WHISPER_FRAMES 4096 memory positions, 2 x
# 2048 at A = 2, phase whisper's first MESH_BATCH requests and frames
WHISPER_MESH_MODE = "stream"
# the sLSTM h on the mesh (the run labelled xlstm_stream): xlstm_125m at
# its published widths and depth (12 layers, 3 periods of 3 mLSTM + 1
# sLSTM, D 768: each rank holds 384 of each sLSTM h's 768 columns) in
# stream mode, so kernel 1 decodes every streamed leaf on each rank
XLSTM_ARCH = "xlstm_125m"
XLSTM_MESH_ARGS = ["--arch", XLSTM_ARCH, "--mode", "stream", "--shards",
                   "2"]
# each torch.distributed.run: its ranks' serve.main runs, by label
MESH_RUNS = {2: {"stream_on": ["--mode", "stream", "--overlap", "on"],
                 "stream_off": ["--mode", "stream", "--overlap", "off"],
                 "fused": ["--mode", "fused"],
                 "restore": ["--mode", "stream", "--ckpt", "{ckpt}"],
                 **{label: SP_ARGS for label in SP_ROUTES},
                 "ep_dense": EP_ARGS + ["--mode", "dense"],
                 "ep_stream": EP_ARGS + ["--mode", "stream"],
                 "ep_fused": EP_ARGS + ["--mode", "fused"],
                 "jamba_dense": JAMBA_MESH_ARGS,
                 "xlstm_stream": XLSTM_MESH_ARGS,
                 # not serve.main: the mesh steps (_mesh_whisper)
                 f"whisper_{WHISPER_MESH_MODE}": []},
             4: {"stream_on": ["--mode", "stream", "--overlap", "on"],
                 # a (data 2, model 2) mesh: experts on model, each
                 # matrix's output columns on data
                 "ep_dense_2x2": EP_ARGS + ["--mode", "dense", "--tp", "2"]}}
# the A = 4 world's llama run, and its single-device side, cut to 4 of
# llama's 16 layers for the script's time limit (every stream of a layer
# still shards 4 ways; the checks read the depth)
MESH_DEPTH = {(4, "stream_on"): 4, (2, "jamba_dense"): JAMBA_MESH_LAYERS}
MESH_LEAF = (8192, 2048)          # llama's w_down: shard_local_decode
MESH_TIME_LIMIT_S = 420


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_leaf_checks(mesh) -> dict:
    """One full-width llama leaf compressed with ``--shards A`` on the
    card: a rank's placed slice gathered back (``gather_ct``: gloo
    broadcasts of CUDA tensors) equal to the whole streams, and the pieces
    ``shard_local_decode`` gives the ranks (kernel 1 on each rank's own
    blocks) together bitwise equal to one decode of the whole."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.codec_api import Codec
    from repro_torch.runtime import collectives as col
    A = mesh.shape["model"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    w = (torch.randn(MESH_LEAF, generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    codec = Codec()
    ct = codec.compress_array(w, shards=A)
    placed = col.place_ct(ct, mesh)
    gathered = col.gather_ct(placed, mesh, codec=codec)
    streams_equal = all(torch.equal(a, b) for a, b in
                        zip(gathered.streams, ct.streams))
    piece = col.shard_local_decode(placed, mesh, codec=codec).cpu()
    pieces = [torch.empty_like(piece) for _ in range(dist.get_world_size())]
    dist.all_gather(pieces, piece)      # the CPU copies: a check, not a path
    whole = codec.decompress_array(ct).reshape(-1).cpu()
    return {"mode": ct.mode, "shards": ct.shards,
            "streams_equal": streams_equal,
            "pieces_equal": torch.equal(
                torch.cat(pieces[:A]).view(torch.int16),
                whole.view(torch.int16)),
            "link": codec.link_stats()["d2d_allgather"],
            "stream_nbytes": col.stream_nbytes(ct)}


def _serve_route(argv, score_shard: bool, layers=None) -> dict:
    """``serve.main(argv)`` with the config's ``decode_score_shard`` set as
    given (serve has no flag for it: the config selects the decode
    attention's route, as in the reference) and, given ``layers``, its
    depth cut to that many layers."""
    import dataclasses
    from repro_torch.launch import serve
    config = serve.get_config
    cut = {} if layers is None else {"n_layers": layers}
    serve.get_config = lambda arch: dataclasses.replace(
        config(arch), decode_score_shard=score_shard, **cut)
    try:
        return serve.main(argv)
    finally:
        serve.get_config = config


def mesh_worker(spec_path: str) -> None:
    """One rank of a ``torch.distributed.run`` world of phase mesh: its
    ``serve.main --tp A`` runs, each result saved for the parent (the
    ``SP_ROUTES`` runs with the route's ``decode_score_shard``)."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    spec = json.loads(Path(spec_path).read_text())
    A, out_dir = spec["A"], Path(spec["out"])
    build.build_all()
    mesh = make_host_mesh(model=A)
    rank = mesh.rank
    res = {"rank": rank, "backend": dist.get_backend(),
           "cards": torch.cuda.device_count(), "device": str(mesh.device),
           "built": {k: v["cached"] for k, v in build.BUILD_LOG.items()},
           "leaf": _mesh_leaf_checks(mesh), "runs": {}}
    for label, args in spec["runs"].items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        serve.reset_launch_counts()
        if label.startswith("whisper_"):
            out = _whisper_steps(label.split("_", 1)[1], mesh)
            res["runs"][label] = {
                **out, "path_launches": serve.launch_counts(),
                "peak_bytes": torch.cuda.max_memory_allocated()}
            continue
        tp = [] if "--tp" in args else ["--tp", str(A)]
        out = _serve_route(MESH_ARGS + args + tp,
                           SP_ROUTES.get(label, False),
                           EP_LAYERS if label.startswith("ep_")
                           else MESH_DEPTH.get((A, label)))
        res["runs"][label] = {
            "logits": out["logits"].cpu(), "tokens": out["tokens"],
            "path_launches": serve.launch_counts(),
            **{k: out[k] for k in (
                "step_launches", "step_gather_bytes", "gather_nbytes",
                "links", "mesh", "overlap", "tpot_s", "ttft_s", "step_s",
                "resident_bytes", "restore", "mode_mix", "ring_bytes",
                "kv_layout", "step_kv_bytes", "step_ep_bytes",
                "expert_placement", "state_bytes", "state_leaf_bytes",
                "state_layout")},
            "peak_bytes": torch.cuda.max_memory_allocated()}
        del out
    torch.save(res, out_dir / f"{spec['tag']}_rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _whisper_steps(mode: str, mesh=None) -> dict:
    """Phase whisper's first ``MESH_BATCH`` requests (its seeded weights,
    frames and prompts) in ``mode`` through the steps of
    ``runtime/steps.py`` on ``mesh`` (None: one device): one prefill of
    the rows together, then ``MESH_TOKENS - 1`` decode steps.  Returns the
    logits (MESH_TOKENS, MESH_BATCH, V) on the host, the bytes of the
    cache's ``mem_k`` + ``mem_v`` and its memory layout, and each step's
    seconds and gathered bytes (dense: the cross attention's; compressed:
    the stream shards')."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.codec_api import Codec, use_codec
    from repro_torch.models import build_model
    from repro_torch.runtime import collectives
    from repro_torch.runtime.steps import (build_decode_step,
                                           build_prefill_step)
    from repro_torch.runtime.streaming import assign_weight_modes
    cfg = get_config(WHISPER_ARCH)
    model = build_model(cfg)
    dev = torch.device("cuda") if mesh is None else mesh.device
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn((BATCH, WHISPER_FRAMES, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)[:MESH_BATCH]
    tokens = torch.as_tensor(_prompts(cfg.vocab_size)[:MESH_BATCH],
                             dtype=torch.int64, device=dev)
    codec = Codec()
    with use_codec(codec):
        params = assign_weight_modes(model.init(seed=0, device=dev),
                                     mode=mode, min_bytes=MIN_BYTES,
                                     shards=2, codec=codec)
        if mesh is not None:
            params = collectives.place_serving_tree(params, mesh)
        prefill = build_prefill_step(model, WHISPER_MAX_LEN, mesh)
        decode = build_decode_step(model, mesh)
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"frames": frames, "tokens": tokens})
        ttft = _sync_s(t0)
        memory = cache.get("mem_layout")
        out = [logits.cpu()]
        secs, dense, compressed = [], [], []
        for _ in range(MESH_TOKENS - 1):
            link = dict(codec.link_stats()["d2d_allgather"])
            t0 = time.perf_counter()
            logits, cache = decode(params, cache, torch.argmax(logits, -1))
            secs.append(_sync_s(t0))
            after = codec.link_stats()["d2d_allgather"]
            dense.append(after["dense_bytes"] - link["dense_bytes"])
            compressed.append(after["compressed_bytes"]
                              - link["compressed_bytes"])
            out.append(logits.cpu())
    return {"logits": torch.stack(out), "ttft_s": ttft, "step_s": secs,
            "step_dense_bytes": dense, "step_gather_bytes": compressed,
            "mem_bytes": sum(cache[k].numel() * cache[k].element_size()
                             for k in ("mem_k", "mem_v")),
            "mem_layout": None if memory is None else {
                "sharded": memory.sharded, "axes": list(memory.axes),
                "positions": memory.local_length, "offset": memory.offset,
                "why": memory.why},
            "mesh": None if mesh is None else dict(mesh.shape)}


def _mesh_world(A: int, runs: dict, out_dir: Path,
                worker: str = "--mesh-worker", tag: str = "") -> list:
    """Start A ranks on this card through ``torch.distributed.run``, each
    running ``worker`` on ``runs``; a failed rank fails the phase."""
    import os
    import signal
    import torch
    tag = tag or f"A{A}"
    spec = out_dir / f"{tag}.json"
    spec.write_text(json.dumps({"A": A, "out": str(out_dir), "runs": runs,
                                "tag": tag}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", str(A), "--master-addr", "127.0.0.1",
           "--master-port", str(_free_port()), str(ROOT / "chip_smoke.py"),
           worker, str(spec)]
    t0 = time.perf_counter()
    # its own process group, so a world past its time limit goes whole
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=MESH_TIME_LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        fail(f"mesh A={A}: the ranks ran past {MESH_TIME_LIMIT_S} s and "
             f"were killed:\n{stdout[-4000:]}\n{stderr[-4000:]}")
    secs = time.perf_counter() - t0
    for line in stdout.splitlines():
        if line.startswith(("[serve] serving mesh", "[mesh]",
                            "[serve] batch=", "[serve] serve links",
                            "[launch.train]", "[train]")):
            log(f"{tag} rank 0: {line}")
    check(proc.returncode == 0, f"mesh A={A}: torch.distributed.run exited "
          f"{proc.returncode}:\n{stdout[-4000:]}\n{stderr[-4000:]}")
    log(f"{tag}: {len(runs)} runs on {A} ranks in {secs:.1f} s")
    return [torch.load(out_dir / f"{tag}_rank{r}.pt", weights_only=False)
            for r in range(A)], secs


def phase_mesh():
    """The serving mesh (``serve --tp A``, ``launch/mesh.py``,
    ``runtime/collectives.py``) on full-width llama3_2_1b: ``A`` ranks of
    ``python -m torch.distributed.run`` on this one card (gloo: NCCL
    refuses two ranks on one device), each holding only its own stream
    shards and gathering the others' as compressed bytes when a layer uses
    them.  A = 2: stream mode with the prefetch on and off, fused mode and
    a restore of a stream checkpoint saved with ``--shards 2``, and fused
    mode over a sequence-sharded K/V ring in both decode-attention routes
    (``SP_ARGS``, :func:`_check_mesh_sp`); A = 4: stream mode (its
    single-device side ``--shards 4``, run here; both cut to
    ``MESH_DEPTH`` layers).  Expert-parallel MoE
    serving (``ep_*``, :func:`_check_mesh_ep`): phi3_5_moe at its
    published widths cut to ``EP_LAYERS`` layers, dense / stream / fused
    at A = 2 and dense on the (data 2, model 2) mesh of the A = 4 world,
    each rank holding only its own experts (and in dense mode its output
    columns), against single-device runs of the same depth, modes and
    shards made here; kernel 2' on column halves of the expert products
    bitwise the whole product's (:func:`_ep_column_checks`).  The
    recurrent states and the encoder memory (A = 2): jamba at its
    published widths cut to ``JAMBA_MESH_LAYERS`` layers in dense mode,
    each rank holding half of every Mamba ``h`` (by d_state) and ``conv``
    (by channels) (:func:`_check_mesh_jamba`); xlstm_125m at its
    published widths and depth in stream mode, each rank holding half of
    every sLSTM ``h``'s D (:func:`_check_mesh_xlstm`); whisper_tiny
    through the mesh steps, each rank holding 2048 of the memory's 4096
    positions (:func:`_check_mesh_whisper`); each against a single-device
    run of the same depth, mode and requests made here.
    Checks: every rank's logits bitwise equal to phase serve's
    single-device run of the same mode and shards (its first
    ``MESH_BATCH`` requests and ``MESH_TOKENS`` tokens; the A = 4 run and
    the restore against their own single-device runs here); no dense byte
    gathered, a step's compressed bytes ``(A - 1)`` x the placed streams'
    ``stream_nbytes``; kernel 1 and 2 launches a step equal to the
    single-device step's; each rank's h2d bytes of the placed records
    about 1/A of the single-device restore's, summing to them; one llama
    leaf's ``shard_local_decode`` pieces together bitwise the whole
    decode; no rank compiled a kernel.  Logs the backend and card count,
    each rank's peak and resident GB beside the single-device stream
    run's, and TPOT with its transport."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch import serve
    card = card_line()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    res = {"card": card, "worlds": {}}
    launches = {}
    try:
        singles = {}
        for label, args in (
                ("stream_shards4", ["--mode", "stream", "--shards", "4"]),
                ("save", ["--mode", "stream", "--save-ckpt",
                          str(tmp / "ckpt")]),
                ("restore", ["--mode", "stream", "--ckpt",
                             str(tmp / "ckpt")]),
                ("sp", SP_ARGS + ["--shards", "2"]),
                # the expert-parallel runs' yardsticks: one device at the
                # same depth, modes and shards
                ("ep_dense", EP_ARGS + ["--mode", "dense"]),
                ("ep_stream", EP_ARGS + ["--mode", "stream", "--shards",
                                         "2"]),
                ("ep_fused", EP_ARGS + ["--mode", "fused", "--shards",
                                        "2"]),
                # the Mamba states' run's yardstick, at the same depth
                ("jamba_dense", JAMBA_MESH_ARGS),
                # the sLSTM h's run's yardstick
                ("xlstm_stream", XLSTM_MESH_ARGS)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            depth = (EP_LAYERS if label.startswith("ep_") else
                     MESH_DEPTH[4, "stream_on"] if label == "stream_shards4"
                     else MESH_DEPTH.get((2, label)))
            out = _serve_route(MESH_ARGS + args, False, depth)
            singles[label] = {
                "logits": out["logits"].cpu(), "restore": out["restore"],
                "step_launches": out["step_launches"][0],
                "tpot_s": out["tpot_s"], "ttft_s": out["ttft_s"],
                "resident_bytes": out["resident_bytes"],
                "ring_bytes": out["ring_bytes"], "overlap": out["overlap"],
                "experts": out["expert_placement"],
                "state_bytes": out["state_bytes"],
                "state_leaf_bytes": out["state_leaf_bytes"],
                "peak_bytes": torch.cuda.max_memory_allocated()}
            del out
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # the encoder memory's run's yardstick: the same steps on one
        # device (phase whisper holds it against each request alone)
        label = f"whisper_{WHISPER_MESH_MODE}"
        singles[label] = {**_whisper_steps(WHISPER_MESH_MODE),
                          "peak_bytes": torch.cuda.max_memory_allocated()}
        MESH_WHISPER_REF["logits"] = singles[label]["logits"]
        torch.cuda.empty_cache()
        want = {("fused", 2): SERVE_REFS["fused"],
                ("stream", 2): SERVE_REFS["stream"],
                ("stream", 4): singles["stream_shards4"],
                ("restore", 2): singles["restore"]}
        for label in ("save", "restore"):
            check(torch.equal(
                singles[label]["logits"].view(torch.int32),
                SERVE_REFS["stream"]["logits"].view(torch.int32)),
                f"mesh: the single-device {label} run differs from phase "
                f"serve's stream run")
        res["ep_columns"] = _ep_column_checks(card)
        for A in MESH_WIDTHS:
            runs = {k: [a.replace("{ckpt}", str(tmp / "ckpt")) for a in v]
                    for k, v in MESH_RUNS[A].items()}
            ranks, secs = _mesh_world(A, runs, tmp)
            res["worlds"][A] = _check_mesh_world(A, ranks, want, singles,
                                                 secs, card)
            launches.update({f"mesh_A{A}_{label}": r["path_launches"]
                             for label, r in ranks[0]["runs"].items()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    res["single"] = {k: {kk: vv for kk, vv in v.items()
                         if kk not in ("logits", "restore")}
                     for k, v in singles.items()}
    RESULTS["mesh"] = res
    return launches


def _check_mesh_world(A, ranks, want, singles, secs, card) -> dict:
    import torch
    r0 = ranks[0]
    check(all(all(r["built"].values()) for r in ranks),
          f"mesh A={A}: a rank compiled kernels: {[r['built'] for r in ranks]}")
    check(r0["backend"] == "gloo" or r0["cards"] >= A,
          f"mesh A={A}: backend {r0['backend']} with {r0['cards']} cards")
    for r in ranks:
        leaf = r["leaf"]
        check(leaf["mode"] == "enec" and leaf["streams_equal"]
              and leaf["pieces_equal"],
              f"mesh A={A} rank {r['rank']}: leaf checks {leaf}")
        check(leaf["link"]["compressed_bytes"]
              == (A - 1) * leaf["stream_nbytes"]
              and leaf["link"]["dense_bytes"] == 0,
              f"mesh A={A} rank {r['rank']}: leaf ledger {leaf['link']}")
    out = {"backend": r0["backend"], "cards": r0["cards"], "seconds": secs,
           "runs": {}}
    for label in r0["runs"]:
        if label in SP_ROUTES:
            out["runs"][label] = _check_mesh_sp(A, label, ranks,
                                                singles["sp"], card)
            continue
        if label.startswith("ep_"):
            out["runs"][label] = _check_mesh_ep(A, label, ranks, singles,
                                                card)
            continue
        if label == "jamba_dense":
            out["runs"][label] = _check_mesh_jamba(A, label, ranks,
                                                   singles[label], card)
            continue
        if label.startswith("whisper_"):
            out["runs"][label] = _check_mesh_whisper(A, label, ranks,
                                                     singles[label], card)
            continue
        if label == "xlstm_stream":
            out["runs"][label] = _check_mesh_xlstm(A, label, ranks,
                                                   singles[label], card)
            continue
        mode = "restore" if label == "restore" else label.split("_")[0]
        ref = want[mode, A]
        per_rank = []
        for r in ranks:
            run = r["runs"][label]
            tag = f"mesh A={A} {label} rank {r['rank']}"
            check(run["mesh"] == {"data": 1, "model": A},
                  f"{tag}: mesh {run['mesh']}")
            check(tuple(run["logits"].shape) == (MESH_TOKENS, MESH_BATCH,
                                                 128256)
                  and bool(torch.isfinite(run["logits"]).all()),
                  f"{tag}: logits {tuple(run['logits'].shape)}")
            check(torch.equal(run["logits"].view(torch.int32),
                              ref["logits"].view(torch.int32)),
                  f"{tag}: logits not bitwise equal to one device's")
            link = run["links"]["d2d_allgather"]
            check(link["dense_bytes"] == 0 and run["gather_nbytes"] > 0,
                  f"{tag}: d2d_allgather {link}")
            check(run["step_gather_bytes"]
                  == [(A - 1) * run["gather_nbytes"]] * (MESH_TOKENS - 1),
                  f"{tag}: gathered {run['step_gather_bytes']} a step, "
                  f"want (A - 1) x {run['gather_nbytes']}")
            # the step's launches as read from the code (its prefetch
            # schedule), and, on the same schedule, one device's step
            code = run_step_launches("llama3_2_1b", mode if mode != "restore"
                                     else "stream", run,
                                     MESH_DEPTH.get((A, label)))
            same = label != "stream_off"
            for st in run["step_launches"]:
                for k in ("enec_decode", "decompress_matmul",
                          "dense_tile_matmul"):
                    check(st[k] == code[k] and (
                        not same or st[k] == ref["step_launches"][k]),
                          f"{tag}: {k} {st[k]} launches a step, the code "
                          f"says {code[k]}, one device's step "
                          f"{ref['step_launches'][k]}")
            per_rank.append({
                "tpot_ms": 1e3 * run["tpot_s"], "ttft_ms": 1e3 * run["ttft_s"],
                "peak_gb": run["peak_bytes"] / 1e9,
                "resident_gb": run["resident_bytes"] / 1e9,
                "gather_mb_per_step": run["step_gather_bytes"][0] / 1e6,
                "links": run["links"]})
        if label == "restore":
            _check_mesh_restore(A, ranks, singles["restore"]["restore"])
        single = singles["stream_shards4" if A == 4 else "save"]
        out["runs"][label] = {"ranks": per_rank,
                              "step_launches": r0["runs"][label][
                                  "step_launches"][0]}
        log(f"mesh A={A} {label}: {A} ranks bitwise equal to one device; "
            f"TPOT {[round(p['tpot_ms'], 1) for p in per_rank]} ms (eager "
            f"step, gloo through the host: the ranks share one card, not "
            f"an NVLink figure; one device captured "
            f"{1e3 * single['tpot_s']:.2f} ms), gathered "
            f"{per_rank[0]['gather_mb_per_step']:.1f} MB a step, peak GB "
            f"{[round(p['peak_gb'], 2) for p in per_rank]} / resident "
            f"{[round(p['resident_gb'], 2) for p in per_rank]} against one "
            f"device's {single['peak_bytes'] / 1e9:.2f} / "
            f"{single['resident_bytes'] / 1e9:.2f}; backend "
            f"{r0['backend']}, {r0['cards']} card(s) ({card})")
    return out


def _check_mesh_sp(A, label, ranks, single, card) -> dict:
    """A run over the sequence-sharded ring: each rank holds its 2048 / A
    positions from ``rank x 2048 / A``, its ring bytes 1/A of the
    single-device run's; its logits bitwise that run's; kernel 1 / 2 / 2'
    launches a step the code's and one device's; every step's decode
    attention gathered the same dense bytes (the route's); the streams'
    gathers compressed bytes as in the fused run."""
    import torch
    per_rank = []
    for r in ranks:
        run = r["runs"][label]
        tag = f"mesh A={A} {label} rank {r['rank']}"
        positions = (PROMPT_SP + SP_TOKENS) // A
        check(run["kv_layout"] == {"sharded": True, "axes": ["model"],
                                   "positions": positions,
                                   "offset": positions * r["rank"],
                                   "why": ""},
              f"{tag}: KV layout {run['kv_layout']}")
        check(A * run["ring_bytes"] == single["ring_bytes"] > 0,
              f"{tag}: ring {run['ring_bytes']} B, one device's "
              f"{single['ring_bytes']} B")
        check(tuple(run["logits"].shape) == (SP_TOKENS, 2, 128256)
              and bool(torch.isfinite(run["logits"]).all()),
              f"{tag}: logits {tuple(run['logits'].shape)}")
        check(torch.equal(run["logits"].view(torch.int32),
                          single["logits"].view(torch.int32)),
              f"{tag}: logits not bitwise equal to one device's")
        kv = run["step_kv_bytes"]
        check(len(kv) == SP_TOKENS - 1 and len(set(kv)) == 1 and kv[0] > 0,
              f"{tag}: decode attention gathered {kv} B a step")
        link = run["links"]["d2d_allgather"]
        check(link["dense_bytes"] == sum(kv)
              and run["step_gather_bytes"]
              == [(A - 1) * run["gather_nbytes"]] * (SP_TOKENS - 1),
              f"{tag}: d2d_allgather {link}, streams "
              f"{run['step_gather_bytes']} a step")
        code = run_step_launches("llama3_2_1b", "fused", run)
        for st in run["step_launches"]:
            for k in ("enec_decode", "decompress_matmul",
                      "dense_tile_matmul"):
                check(st[k] == code[k] == single["step_launches"][k],
                      f"{tag}: {k} {st[k]} launches a step, the code says "
                      f"{code[k]}, one device's step "
                      f"{single['step_launches'][k]}")
        per_rank.append({
            "tpot_ms": 1e3 * run["tpot_s"], "ttft_ms": 1e3 * run["ttft_s"],
            "peak_gb": run["peak_bytes"] / 1e9,
            "ring_mb": run["ring_bytes"] / 1e6,
            "kv_mb_per_step": kv[0] / 1e6,
            "gather_mb_per_step": run["step_gather_bytes"][0] / 1e6})
    log(f"mesh A={A} {label}: {A} ranks bitwise equal to one device over a "
        f"sequence-sharded ring ({per_rank[0]['ring_mb']:.2f} MB a rank, "
        f"one device {single['ring_bytes'] / 1e6:.2f} MB); decode "
        f"attention gathered {per_rank[0]['kv_mb_per_step']:.4f} MB a step "
        f"(streams {per_rank[0]['gather_mb_per_step']:.1f} MB); TPOT "
        f"{[round(p['tpot_ms'], 1) for p in per_rank]} ms (eager, gloo "
        f"through the host; one device captured "
        f"{1e3 * single['tpot_s']:.2f} ms), TTFT "
        f"{[round(p['ttft_ms'], 1) for p in per_rank]} ms, peak GB "
        f"{[round(p['peak_gb'], 2) for p in per_rank]} against one "
        f"device's {single['peak_bytes'] / 1e9:.2f} ({card})")
    return {"ranks": per_rank,
            "step_launches": ranks[0]["runs"][label]["step_launches"][0]}


def _ep_column_checks(card) -> dict:
    """Kernel 2' on a rank's output columns of phi3.5's expert products
    (``e_gate`` (4096, 6400) and ``e_down`` (6400, 4096)) at the mesh's
    decode rows: each half, copied out and as a strided view, bitwise the
    whole product's columns (the expert layout's premise)."""
    import torch
    from repro_torch.kernels.decompress_matmul import dense_matmul_cuda
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for name, (k, n) in (("e_gate", (4096, 6400)), ("e_down", (6400, 4096))):
        x = torch.randn((MESH_BATCH, k), generator=gen,
                        device="cuda").bfloat16()
        w = (torch.randn((k, n), generator=gen, device="cuda")
             * k ** -0.5).bfloat16()
        whole = dense_matmul_cuda(x, w)
        equal = []
        for lo, hi in ((0, n // 2), (n // 2, n)):
            for part in (w[:, lo:hi].contiguous(), w[:, lo:hi]):
                equal.append(torch.equal(
                    dense_matmul_cuda(x, part).view(torch.int32),
                    whole[:, lo:hi].view(torch.int32)))
        check(all(equal), f"mesh ep: kernel 2' on {name}'s column halves "
              f"not bitwise the whole product's columns: {equal}")
        out[name] = {"k": k, "n": n, "m": MESH_BATCH, "bitwise": equal}
    log(f"mesh ep: kernel 2' on each half of e_gate's and e_down's output "
        f"columns bitwise the whole product's, copied out and strided "
        f"(M = {MESH_BATCH}; {card})")
    return out


def _check_mesh_ep(A, label, ranks, singles, card) -> dict:
    """An expert-parallel run of phi3_5_moe cut to ``EP_LAYERS`` layers:
    every rank's logits bitwise the single-device run's of the same mode
    and shards; no expert stack left placed to gather, so a step gathers
    (A - 1) x the other placed streams (attention, embed, head) and no
    expert byte; each rank holds 1/A of the expert bytes (its experts,
    and in dense mode its output columns) and the ranks hold them all;
    the MoE blocks' exchanged activation bytes a step the layout's
    formula; kernel 1 and kernel 2 launches a step one device's, kernel
    2' 3 products fewer for each expert the rank does not own."""
    import torch
    from types import SimpleNamespace
    from repro_torch.configs import get_config
    from repro_torch.runtime import sharding
    mode = label.split("_")[1]
    single = singles[f"ep_{mode}"]
    whole = single["experts"]["bytes"]
    cfg = get_config(MOE_ARCH)
    per_rank, held = [], []
    for r in ranks:
        run = r["runs"][label]
        tag = f"mesh A={A} {label} rank {r['rank']}"
        coords = {"model": r["rank"] % run["mesh"]["model"]}
        layout = sharding.expert_layout(
            SimpleNamespace(shape=run["mesh"], coords=coords),
            cfg.n_experts, cfg.d_model, cfg.moe_d_ff, dense=mode == "dense")
        share = layout.expert_count * layout.data_count
        check(share == A and layout.local_experts * layout.expert_count
              == cfg.n_experts, f"{tag}: layout {layout.describe()}")
        check(tuple(run["logits"].shape) == (MESH_TOKENS, MESH_BATCH,
                                             cfg.vocab_size)
              and bool(torch.isfinite(run["logits"]).all()),
              f"{tag}: logits {tuple(run['logits'].shape)}")
        check(torch.equal(run["logits"].view(torch.int32),
                          single["logits"].view(torch.int32)),
              f"{tag}: logits not bitwise equal to one device's")
        placement = run["expert_placement"]
        check(placement["placed"] == 0
              and run["step_gather_bytes"] == [(run["mesh"]["model"] - 1)
                                               * run["gather_nbytes"]]
              * (MESH_TOKENS - 1)
              and run["links"]["d2d_allgather"]["dense_bytes"] == 0,
              f"{tag}: {placement['placed']} expert stacks placed to "
              f"gather; gathered {run['step_gather_bytes']} a step, the "
              f"other placed streams {run['gather_nbytes']}")
        check(placement["bytes"] * share == whole
              and placement["layout"] == layout.describe(),
              f"{tag}: holds {placement['bytes']} of one device's {whole} "
              f"expert bytes, not 1/{share}, as {placement['layout']}")
        held.append(placement["bytes"])
        want_ep = EP_LAYERS * layout.exchange_bytes(MESH_BATCH, 1, 4)
        check(run["step_ep_bytes"] == [want_ep] * (MESH_TOKENS - 1),
              f"{tag}: MoE exchanges {run['step_ep_bytes']} B a step, the "
              f"layout's formula {want_ep}")
        fewer = 3 * EP_LAYERS * (cfg.n_experts - layout.local_experts)
        one = single["step_launches"]
        for st in run["step_launches"]:
            check(st["enec_decode"] == one["enec_decode"]
                  and st["decompress_matmul"] == one["decompress_matmul"]
                  and st["dense_tile_matmul"] == one["dense_tile_matmul"]
                  - fewer, f"{tag}: launches a step {st}, one device's "
                  f"{one}, 2' fewer by {fewer} expected")
        per_rank.append({
            "tpot_ms": 1e3 * run["tpot_s"], "ttft_ms": 1e3 * run["ttft_s"],
            "peak_gb": run["peak_bytes"] / 1e9,
            "resident_gb": run["resident_bytes"] / 1e9,
            "expert_gb": placement["bytes"] / 1e9,
            "gather_mb_per_step": run["step_gather_bytes"][0] / 1e6,
            "ep_mb_per_step": run["step_ep_bytes"][0] / 1e6,
            "launches_per_step": run["step_launches"][0]})
    placement = ranks[0]["runs"][label]["expert_placement"]
    check(sum(held) * share == whole * len(ranks),
          f"mesh A={A} {label}: ranks hold {held} of {whole} expert bytes")
    would = (ranks[0]["runs"][label]["mesh"]["model"] - 1) \
        * placement["stream_nbytes"]
    out = {"layout": placement["layout"], "ranks": per_rank,
           "expert_gb_whole": whole / 1e9,
           "expert_gb_gathered_before": would / 1e9,
           "single": {"tpot_ms": 1e3 * single["tpot_s"],
                      "ttft_ms": 1e3 * single["ttft_s"],
                      "peak_gb": single["peak_bytes"] / 1e9,
                      "resident_gb": single["resident_bytes"] / 1e9,
                      "launches_per_step": single["step_launches"]}}
    log(f"mesh A={A} {label}: {len(ranks)} ranks bitwise equal to one "
        f"device ({MOE_ARCH}, {EP_LAYERS} layers; rank 0: "
        f"{placement['layout']}); experts held "
        f"{[round(p['expert_gb'], 3) for p in per_rank]} GB a rank of "
        f"{whole / 1e9:.3f}, none gathered (the rule before gathered "
        f"{would / 1e9:.3f} GB a step); streams gathered "
        f"{per_rank[0]['gather_mb_per_step']:.1f} MB a step; MoE "
        f"activations exchanged {per_rank[0]['ep_mb_per_step']:.4f} MB a "
        f"step; TPOT {[round(p['tpot_ms'], 1) for p in per_rank]} ms (eager, "
        f"gloo through the host; one device captured "
        f"{1e3 * single['tpot_s']:.2f} ms), TTFT "
        f"{[round(p['ttft_ms'], 1) for p in per_rank]} ms (one device "
        f"{1e3 * single['ttft_s']:.1f}), peak GB "
        f"{[round(p['peak_gb'], 2) for p in per_rank]} / resident "
        f"{[round(p['resident_gb'], 2) for p in per_rank]} against one "
        f"device's {single['peak_bytes'] / 1e9:.2f} / "
        f"{single['resident_bytes'] / 1e9:.2f}; launches a step "
        f"{per_rank[0]['launches_per_step']} against one device's "
        f"{single['step_launches']} ({card})")
    return out


def _check_mesh_jamba(A, label, ranks, single, card) -> dict:
    """jamba_v0_1_52b at published widths cut to ``JAMBA_MESH_LAYERS``
    layers, dense, on A ranks: every rank's logits bitwise the
    single-device run's; each holds 1/A of the Mamba states (``h`` by
    d_state 16, ``conv`` by its 8192 channels), its blocks the layout's,
    and 1/A of the experts; a decode step gathers the layout's bytes for
    its Mamba layers (the 67-position ring stays whole, so no attention
    byte); kernel 2' launches a step one device's less 3 for each expert
    a rank does not own."""
    import torch
    from types import SimpleNamespace
    from repro_torch.configs import get_config
    from repro_torch.models.lm import block_program
    from repro_torch.models.ssm import mamba_dims
    from repro_torch.runtime import sharding
    cfg = get_config(JAMBA_ARCH)
    program = block_program(cfg)
    periods = JAMBA_MESH_LAYERS // len(program)
    n_mamba = periods * sum(d.seq == "mamba" for d in program)
    n_moe = periods * sum(d.ffn == "moe" for d in program)
    d_inner, _ = mamba_dims(cfg.d_model, cfg.ssm_state)
    per_rank = []
    for r in ranks:
        run = r["runs"][label]
        tag = f"mesh A={A} {label} rank {r['rank']}"
        mesh = SimpleNamespace(shape=run["mesh"],
                               coords={"model": r["rank"] % A})
        layout = sharding.state_layout(mesh, d_inner, cfg.ssm_state)
        check(layout.h_axis == layout.conv_axis == "model"
              and run["state_layout"]["describe"] == layout.describe(),
              f"{tag}: state layout {run['state_layout']}, want "
              f"{layout.describe()}")
        check(tuple(run["logits"].shape) == (MESH_TOKENS, MESH_BATCH,
                                             cfg.vocab_size)
              and bool(torch.isfinite(run["logits"]).all()),
              f"{tag}: logits {tuple(run['logits'].shape)}")
        check(torch.equal(run["logits"].view(torch.int32),
                          single["logits"].view(torch.int32)),
              f"{tag}: logits not bitwise equal to one device's")
        check(run["state_bytes"] * A == single["state_bytes"] > 0,
              f"{tag}: Mamba states {run['state_bytes']} B, one device's "
              f"{single['state_bytes']} B")
        check(run["expert_placement"]["bytes"] * A
              == single["experts"]["bytes"],
              f"{tag}: holds {run['expert_placement']['bytes']} of "
              f"{single['experts']['bytes']} expert bytes")
        want = n_mamba * layout.step_gather_bytes(MESH_BATCH)
        check(run["kv_layout"]["sharded"] is False
              and run["step_kv_bytes"] == [want] * (MESH_TOKENS - 1),
              f"{tag}: gathered {run['step_kv_bytes']} dense B a step, the "
              f"layout's {want} for {n_mamba} Mamba layers")
        fewer = 3 * n_moe * (cfg.n_experts - cfg.n_experts // A)
        one = single["step_launches"]
        for st in run["step_launches"]:
            check(st["enec_decode"] == one["enec_decode"]
                  and st["decompress_matmul"] == one["decompress_matmul"]
                  and st["dense_tile_matmul"] == one["dense_tile_matmul"]
                  - fewer, f"{tag}: launches a step {st}, one device's "
                  f"{one}, 2' fewer by {fewer} expected")
        per_rank.append({
            "tpot_ms": 1e3 * run["tpot_s"], "ttft_ms": 1e3 * run["ttft_s"],
            "peak_gb": run["peak_bytes"] / 1e9,
            "resident_gb": run["resident_bytes"] / 1e9,
            "state_mb": run["state_bytes"] / 1e6,
            "state_gather_mb_per_step": run["step_kv_bytes"][0] / 1e6,
            "ep_mb_per_step": run["step_ep_bytes"][0] / 1e6,
            "layout": run["state_layout"]["describe"],
            "launches_per_step": run["step_launches"][0]})
    out = {"ranks": per_rank, "layers": JAMBA_MESH_LAYERS,
           "single": {"tpot_ms": 1e3 * single["tpot_s"],
                      "ttft_ms": 1e3 * single["ttft_s"],
                      "peak_gb": single["peak_bytes"] / 1e9,
                      "resident_gb": single["resident_bytes"] / 1e9,
                      "state_mb": single["state_bytes"] / 1e6,
                      "launches_per_step": single["step_launches"]}}
    log(f"mesh A={A} {label}: {len(ranks)} ranks bitwise equal to one "
        f"device ({JAMBA_ARCH}, {JAMBA_MESH_LAYERS} layers, dense); Mamba "
        f"states {[round(p['state_mb'], 4) for p in per_rank]} MB a rank "
        f"of one device's {single['state_bytes'] / 1e6:.4f} (rank 0: "
        f"{per_rank[0]['layout']}); gathered for the Mamba states "
        f"{per_rank[0]['state_gather_mb_per_step']:.6f} MB a step "
        f"({n_mamba} layers); MoE activations exchanged "
        f"{per_rank[0]['ep_mb_per_step']:.4f} MB a step; TPOT "
        f"{[round(p['tpot_ms'], 1) for p in per_rank]} ms (eager, gloo "
        f"through the host: the ranks share one card; one device captured "
        f"{1e3 * single['tpot_s']:.2f} ms), TTFT "
        f"{[round(p['ttft_ms'], 1) for p in per_rank]} ms (one device "
        f"{1e3 * single['ttft_s']:.1f}), peak GB "
        f"{[round(p['peak_gb'], 2) for p in per_rank]} / resident "
        f"{[round(p['resident_gb'], 2) for p in per_rank]} against one "
        f"device's {single['peak_bytes'] / 1e9:.2f} / "
        f"{single['resident_bytes'] / 1e9:.2f}; launches a step "
        f"{per_rank[0]['launches_per_step']} against one device's "
        f"{single['step_launches']} ({card})")
    return out


def _check_mesh_xlstm(A, label, ranks, single, card) -> dict:
    """xlstm_125m at published widths and depth, stream mode, on A ranks:
    every rank's logits bitwise the single-device run's; each holds its
    D / A columns of every sLSTM ``h`` (the layout's block) and all of
    ``c`` / ``n`` / ``m`` (the mLSTM's and the sLSTM's); a decode step
    gathers the layout's dense bytes (the bf16 ``h`` of each sLSTM layer)
    and ``(A - 1)`` x the placed streams' compressed bytes; kernel 1 and
    2' launches a step are one device's."""
    import torch
    from types import SimpleNamespace
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(XLSTM_ARCH)
    program = lm.block_program(cfg)
    n_slstm = cfg.n_layers // len(program) * sum(
        d.seq == "slstm" for d in program)
    whole = single["state_leaf_bytes"]
    per_rank = []
    for r in ranks:
        run = r["runs"][label]
        tag = f"mesh A={A} {label} rank {r['rank']}"
        mesh = SimpleNamespace(shape=run["mesh"],
                               coords={"model": r["rank"] % A})
        layout = lm.state_layout(cfg, mesh)
        d0, d1 = layout.slstm_block
        check(layout.slstm_axis == "model" and d1 - d0 == cfg.d_model // A
              and run["state_layout"]["describe"] == layout.describe()
              and run["state_layout"]["slstm_block"] == [d0, d1],
              f"{tag}: state layout {run['state_layout']}, want "
              f"{layout.describe()}")
        check(tuple(run["logits"].shape) == (MESH_TOKENS, MESH_BATCH,
                                             cfg.vocab_size)
              and bool(torch.isfinite(run["logits"]).all()),
              f"{tag}: logits {tuple(run['logits'].shape)}")
        check(torch.equal(run["logits"].view(torch.int32),
                          single["logits"].view(torch.int32)),
              f"{tag}: logits not bitwise equal to one device's")
        held = run["state_leaf_bytes"]
        check(held["h"] * A == whole["h"]
              == n_slstm * MESH_BATCH * cfg.d_model * 4
              and all(held[k] == whole[k] > 0 for k in ("c", "n", "m")),
              f"{tag}: holds {held} B of the states, one device {whole}")
        want = lm.state_gather_bytes(cfg, layout, MESH_BATCH)
        check(want == n_slstm * (A - 1) * MESH_BATCH * cfg.d_model * 2
              and run["step_kv_bytes"] == [want] * (MESH_TOKENS - 1),
              f"{tag}: gathered {run['step_kv_bytes']} dense B a step, the "
              f"layout's {want} for {n_slstm} sLSTM layers")
        check(run["gather_nbytes"] > 0 and run["step_gather_bytes"]
              == [(A - 1) * run["gather_nbytes"]] * (MESH_TOKENS - 1),
              f"{tag}: gathered {run['step_gather_bytes']} compressed B a "
              f"step, want (A - 1) x {run['gather_nbytes']}")
        one = single["step_launches"]
        for st in run["step_launches"]:
            check(all(st[k] == one[k] for k in (
                "enec_decode", "decompress_matmul", "dense_tile_matmul"))
                  and st["enec_decode"] > 0,
                  f"{tag}: launches a step {st}, one device's {one}")
        per_rank.append({
            "tpot_ms": 1e3 * run["tpot_s"], "ttft_ms": 1e3 * run["ttft_s"],
            "peak_gb": run["peak_bytes"] / 1e9,
            "resident_gb": run["resident_bytes"] / 1e9,
            "h_bytes": held["h"], "state_bytes": run["state_bytes"],
            "state_gather_bytes_per_step": run["step_kv_bytes"][0],
            "gather_mb_per_step": run["step_gather_bytes"][0] / 1e6,
            "layout": run["state_layout"]["describe"],
            "launches_per_step": run["step_launches"][0]})
    out = {"ranks": per_rank, "layers": cfg.n_layers,
           "single": {"tpot_ms": 1e3 * single["tpot_s"],
                      "ttft_ms": 1e3 * single["ttft_s"],
                      "peak_gb": single["peak_bytes"] / 1e9,
                      "resident_gb": single["resident_bytes"] / 1e9,
                      "h_bytes": whole["h"],
                      "state_bytes": single["state_bytes"],
                      "launches_per_step": single["step_launches"]}}
    log(f"mesh A={A} {label}: {len(ranks)} ranks bitwise equal to one "
        f"device ({XLSTM_ARCH}, {cfg.n_layers} layers, stream); sLSTM h "
        f"{[p['h_bytes'] for p in per_rank]} B a rank of one device's "
        f"{whole['h']} (rank 0: {per_rank[0]['layout']}); gathered for "
        f"the sLSTM h {per_rank[0]['state_gather_bytes_per_step']} dense B "
        f"and {per_rank[0]['gather_mb_per_step']:.3f} MB of streams a step "
        f"({n_slstm} sLSTM layers); TPOT "
        f"{[round(p['tpot_ms'], 1) for p in per_rank]} ms (eager, gloo "
        f"through the host: the ranks share one card; one device captured "
        f"{1e3 * single['tpot_s']:.2f} ms), TTFT "
        f"{[round(p['ttft_ms'], 1) for p in per_rank]} ms (one device "
        f"{1e3 * single['ttft_s']:.1f}), peak GB "
        f"{[round(p['peak_gb'], 3) for p in per_rank]} / resident "
        f"{[round(p['resident_gb'], 3) for p in per_rank]} against one "
        f"device's {single['peak_bytes'] / 1e9:.3f} / "
        f"{single['resident_bytes'] / 1e9:.3f}; launches a step "
        f"{per_rank[0]['launches_per_step']} against one device's "
        f"{single['step_launches']} ({card})")
    return out


def _check_mesh_whisper(A, label, ranks, single, card) -> dict:
    """whisper_tiny through the mesh steps on A ranks: every rank's logits
    bitwise the single-device steps'; each rank holds its 4096 / A of the
    memory's positions from ``rank x 4096 / A``, 1/A of one device's
    ``mem_k`` / ``mem_v`` bytes; every decode step gathers the same dense
    bytes (the cross attention's scores and per-chunk partials, and the
    decoder's attention over its whole ring: none) and the streams'
    compressed shards."""
    import torch
    positions = WHISPER_FRAMES // A
    per_rank = []
    for r in ranks:
        run = r["runs"][label]
        tag = f"mesh A={A} {label} rank {r['rank']}"
        check(run["mem_layout"] == {"sharded": True, "axes": ["model"],
                                    "positions": positions,
                                    "offset": positions * r["rank"],
                                    "why": ""},
              f"{tag}: memory layout {run['mem_layout']}")
        check(run["mem_bytes"] * A == single["mem_bytes"] > 0,
              f"{tag}: memory {run['mem_bytes']} B, one device's "
              f"{single['mem_bytes']} B")
        check(tuple(run["logits"].shape) == tuple(single["logits"].shape)
              and bool(torch.isfinite(run["logits"]).all()),
              f"{tag}: logits {tuple(run['logits'].shape)}")
        check(torch.equal(run["logits"].view(torch.int32),
                          single["logits"].view(torch.int32)),
              f"{tag}: logits not bitwise equal to one device's")
        dense = run["step_dense_bytes"]
        check(len(set(dense)) == 1 and dense[0] > 0
              and all(b > 0 for b in run["step_gather_bytes"]),
              f"{tag}: gathered {dense} dense, {run['step_gather_bytes']} "
              f"compressed B a step")
        per_rank.append({
            "tpot_ms": 1e3 * sum(run["step_s"]) / len(run["step_s"]),
            "ttft_ms": 1e3 * run["ttft_s"], "peak_gb": run["peak_bytes"] / 1e9,
            "mem_mb": run["mem_bytes"] / 1e6,
            "mem_gather_mb_per_step": dense[0] / 1e6,
            "gather_mb_per_step": run["step_gather_bytes"][0] / 1e6})
    check(all(s == 0 for s in single["step_dense_bytes"]),
          f"mesh {label}: one device gathered {single['step_dense_bytes']}")
    tpot = 1e3 * sum(single["step_s"]) / len(single["step_s"])
    log(f"mesh A={A} {label}: {len(ranks)} ranks bitwise equal to one "
        f"device ({WHISPER_ARCH}, {WHISPER_FRAMES} frames, "
        f"{WHISPER_MESH_MODE}); memory "
        f"{[round(p['mem_mb'], 3) for p in per_rank]} MB a rank of one device's {single['mem_bytes'] / 1e6:.3f}; the "
        f"cross attention gathered {per_rank[0]['mem_gather_mb_per_step']:.4f}"
        f" MB a step (streams {per_rank[0]['gather_mb_per_step']:.3f} MB); "
        f"TPOT {[round(p['tpot_ms'], 1) for p in per_rank]} ms (eager, gloo "
        f"through the host; one device eager {tpot:.2f} ms), TTFT "
        f"{[round(p['ttft_ms'], 1) for p in per_rank]} ms (one device "
        f"{1e3 * single['ttft_s']:.1f}), peak GB "
        f"{[round(p['peak_gb'], 2) for p in per_rank]} against one "
        f"device's {single['peak_bytes'] / 1e9:.2f} ({card})")
    return {"ranks": per_rank,
            "single": {"tpot_ms": tpot, "ttft_ms": 1e3 * single["ttft_s"],
                       "peak_gb": single["peak_bytes"] / 1e9,
                       "mem_mb": single["mem_bytes"] / 1e6}}


def _check_mesh_restore(A, ranks, single) -> None:
    """Each rank uploaded only its own shards of the placed records: over
    the ranks those records' h2d bytes are the single-device restore's,
    each rank's about 1/A (the exact high streams differ by shard)."""
    placed = ranks[0]["runs"]["restore"]["restore"]["placed_records"]
    # the 7 layer stacks and the embedding, each adopted as it was saved
    check(len(placed) == len(LEAVES) + 1,
          f"mesh A={A} restore: placed records {placed}")
    one = single["record_h2d"]
    total = sum(one[n] for n in placed)
    mine = [sum(r["runs"]["restore"]["restore"]["record_h2d"][n]
                for n in placed) for r in ranks]
    check(sum(mine) == total, f"mesh A={A} restore: h2d of the placed "
          f"records {mine} over the ranks, one device {total}")
    check(all(abs(m * A - total) <= 0.02 * total for m in mine),
          f"mesh A={A} restore: h2d a rank {mine}, one device {total}")
    RESULTS.setdefault("mesh_restore", {})[A] = {
        "placed_records": len(placed), "h2d_one_device": total,
        "h2d_per_rank": mine}
    log(f"mesh A={A} restore: {len(placed)} placed records, h2d a rank "
        f"{[round(m / 1e6, 1) for m in mine]} MB, one device "
        f"{total / 1e6:.1f} MB")


# ---------------------------------------------------------------------------
# phase train_mesh: the training mesh over torch.distributed ranks
# ---------------------------------------------------------------------------

TRAIN_MESH_A = 2
TRAIN_MESH_FIRST = (1, 2)      # phase train records its shards' digests
# each rank's ``launch/train.py`` runs, in order: 3 steps on (1, 2) saved at
# step 3, then that checkpoint resumed on (2, 1) to step 6 and on the pod
# mesh (pod 2, data 1, model 1) to step 6, whose final saves no check reads
# and are skipped (``_saves_skipped``)
TRAIN_MESH_RUNS = {"1x2": ["--mesh", "1x2", "--steps", str(TRAIN_RESUME)],
                   "2x1": ["--mesh", "2x1", "--steps", str(TRAIN_STEPS)],
                   "pod2x1x1": ["--steps", str(TRAIN_STEPS)]}
TRAIN_MESH_SAVES = {"1x2": True, "2x1": False, "pod2x1x1": False}
# the runs on a pod mesh, made by the worker and given to ``train.main`` as
# ``mesh=`` (``--mesh`` is DxM, as the reference's launcher's), and the
# run each must equal bit for bit: (P, D, M) trains as (P·D, M)
TRAIN_MESH_POD = {"pod2x1x1": (2, 1, 1)}
TRAIN_MESH_POD_TWIN = {"pod2x1x1": "2x1"}
POD_AXES = ("pod", "data", "model")
TRAIN_MESH_RTOL = 1e-3


def _memory_marks(train, marks: list):
    """Patch ``train``'s step builder and the checkpoint's save so each
    step and each save appends ``(label, peak, held)`` bytes: the peak
    since the previous mark and what is allocated at the mark ("setup":
    from the start of the run to its first step).  At each mark the rank
    also hands its cached blocks back to the card: the ranks share one
    card, and rank 0's save needs the room another rank's allocator would
    otherwise keep (with a card a rank nothing needs this)."""
    import torch
    from repro_torch.checkpoint.ckpt import CheckpointManager

    def mark(label):
        torch.cuda.synchronize()
        marks.append((label, torch.cuda.max_memory_allocated(),
                      torch.cuda.memory_allocated()))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    build_step, save = train.build_train_step, CheckpointManager.save

    def marked_build(*args, **kw):
        step = build_step(*args, **kw)

        def marked_step(*a):
            mark("setup" if not marks else "between")
            out = step(*a)
            mark("step")
            return out
        return marked_step

    def marked_save(self, *args, **kw):
        mark("before save")
        save(self, *args, **kw)
        mark("save")

    train.build_train_step, CheckpointManager.save = marked_build, \
        marked_save
    return lambda: setattr(train, "build_train_step", build_step) or \
        setattr(CheckpointManager, "save", save)


def _allreduce_check(out) -> dict:
    """One step's whole gradient tree of this rank's rows (batch
    TRAIN_STEPS, the state of ``out``) through ``compressed_allreduce``
    over the one axis of more than one rank that the rows are on ("data"
    on (2, 1), "pod" on the pod mesh), each leaf's codec params searched
    on the exponent histogram of every rank's gradient (summed over the
    axis): bitwise equal to the plain rank-ordered sum of the dense
    gradients.  Logs the
    d2d_psum bytes, compressed and dense, the gradient ratio as shipped
    (the static stream layout) and at the exact wire size beside
    ``wire_bytes_saved``'s estimate, and the launches (one encode and one
    decode a leaf)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import params as params_mod
    from repro_torch.core.api import tree_leaves
    from repro_torch.core.codec import to_blocks
    from repro_torch.core.codec_api import Codec
    from repro_torch.core.dtypes import format_for, to_bits
    from repro_torch.core.stats import exponent_histogram_device
    from repro_torch.data import pipeline
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import gather_whole
    from repro_torch.models import build_model
    from repro_torch.optim.grad_compress import (compressed_allreduce,
                                                 rank_ordered_sum,
                                                 wire_bytes_saved)
    from repro_torch.runtime import elastic, sharding
    from repro_torch.runtime.steps import loss_and_grads
    mesh = out["mesh"]
    rows = sharding.batch_axis(mesh, 8)
    axes = [a for a in (rows if isinstance(rows, tuple) else (rows,))
            if a is not None and mesh.shape[a] > 1]
    check(len(axes) == 1, f"train_mesh all-reduce: the rows of mesh "
          f"{mesh.shape} are on {rows}, not on one axis")
    axis = axes[0]
    D = mesh.shape[axis]
    model = build_model(get_config("llama3_2_1b"))
    data = pipeline.DataConfig(vocab_size=TRAIN_VOCAB, seq_len=128,
                               global_batch=8)
    batch = {k: torch.from_numpy(v).cuda(mesh.device)
             for k, v in pipeline.batch_at(data, TRAIN_STEPS).items()}
    specs = sharding.batch_pspecs(batch, mesh, 8)
    local = {k: sharding.local_shard(v, specs[k], mesh)
             for k, v in batch.items()}
    whole = elastic.gather_tree(out["params"], mesh, out["pspecs"]["params"],
                                link=None)
    _, _, grads = loss_and_grads(model, whole, local)
    del whole
    codec = Codec()
    build.restore(dict.fromkeys(build.counts(), 0))
    equal, leaves, raw, estimate, secs = True, 0, 0, 0, 0.0
    searched = []
    for _, g in tree_leaves(grads):
        fmt = format_for(g.dtype)
        hists = gather_whole([exponent_histogram_device(g, fmt)[None]],
                             [(axis,)], mesh, link=None)[0]
        p = params_mod.search(hists.sum(0).cpu().numpy(), fmt)
        searched.append((g, fmt, p))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = compressed_allreduce(g, mesh, axis, p, codec=codec)
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
        parts = gather_whole([g[None]], [(axis,)], mesh, link=None)[0]
        want = rank_ordered_sum(parts).to(g.dtype)
        equal &= torch.equal(got.view(torch.int16), want.view(torch.int16))
        leaves += 1
        raw += (D - 1) * g.numel() * g.element_size()
        estimate += (D - 1) * wire_bytes_saved(g, p)["compressed_bytes"]
        del got, parts, want
    launches = build.counts()
    link = codec.link_stats()["d2d_psum"]
    # the exact wire size of the same streams (the high stream cut to its
    # true length), outside the counted window: the all-reduce ships the
    # static layout, the high stream padded to its bound
    wire = 0
    for g, fmt, p in searched:
        st = ops.encode_blocks(to_blocks(to_bits(g)), fmt, p)
        wire += (D - 1) * (sum(a.numel() * a.element_size()
                               for a in (st.mask, st.low, st.raw, st.high_len))
                           + int(((st.high_len.long() + 7) // 8).sum()))
    return {"axis": axis, "ranks": D, "bitwise": equal, "leaves": leaves,
            "launches": launches,
            "link": link, "dense_bytes": raw, "estimate_bytes": estimate,
            "wire_bytes": wire, "ratio": raw / link["compressed_bytes"],
            "wire_ratio": raw / wire, "estimate_ratio": raw / estimate,
            "seconds": secs}


def train_mesh_worker(spec_path: str) -> None:
    """One rank of phase train_mesh's world: its ``launch/train.py`` runs
    (the counts of every kernel set to 0 just before each and read just
    after; the codec's encode and decode dispatches beside them), the
    digest of the shards it holds, the memory marks, then the gradient
    all-reduce check on the last run's mesh."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.codec_api import current_codec
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    spec = json.loads(Path(spec_path).read_text())
    out_dir = Path(spec["out"])
    build.build_all()
    res = {"built": {k: v["cached"] for k, v in build.BUILD_LOG.items()},
           "cards": torch.cuda.device_count(), "runs": {}}
    codec = current_codec()
    for label, args in spec["runs"].items():
        marks, skipped = [], []
        unmark = _memory_marks(train, marks)
        if not TRAIN_MESH_SAVES[label]:
            unskip = _saves_skipped(skipped)
            unmark = (lambda u, v: lambda: (v(), u()))(unmark, unskip)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        build.restore(dict.fromkeys(build.counts(), 0))
        enc = codec.encode_cache_stats()["dispatches"]
        dec = codec.decode_cache_stats()["dispatches"]
        t0 = time.perf_counter()
        try:
            pod = TRAIN_MESH_POD.get(label)
            out = train.main(["--arch", "llama3_2_1b", "--ckpt",
                              str(out_dir / "ckpt")] + args,
                             mesh=make_mesh(pod, POD_AXES, "cuda")
                             if pod else None)
        finally:
            unmark()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        mesh = out["mesh"]
        res["rank"], res["backend"] = mesh.rank, dist.get_backend()
        res["runs"][label] = {
            "mesh": dict(mesh.shape), "history": out["history"],
            "seconds": secs, "launches": build.counts(),
            "encode_dispatches": codec.encode_cache_stats()["dispatches"]
            - enc,
            "decode_dispatches": codec.decode_cache_stats()["dispatches"]
            - dec,
            "marks": marks, "held_bytes": torch.cuda.memory_allocated(),
            "saves_skipped": skipped,
            "digest": {path: leaf_digest(t)
                       for path, t in _flat_state(out)}}
        if label in TRAIN_MESH_POD_TWIN:
            # what each rank of the twin mesh holds of this rank's state
            twin = tuple(int(v) for v in TRAIN_MESH_POD_TWIN[label].split(
                "x"))
            res["runs"][label]["as_twin"] = shard_digests(out, twin)
        if label != list(spec["runs"])[-1]:
            del out
    torch.cuda.empty_cache()
    res["allreduce"] = _allreduce_check(out)
    del out
    torch.save(res, out_dir / f"{spec['tag']}_rank{res['rank']}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _replicated_leaves(shape: dict) -> set:
    """The leaves of the training state every rank of a mesh of ``shape``
    (axis name -> size: ``(data, model)`` or ``(pod, data, model)``)
    holds whole."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import abstract_params
    from repro_torch.runtime import elastic, sharding
    mesh = Mesh(tuple(shape.values()), tuple(shape))
    specs = sharding.spec_leaves(elastic.train_pspecs(
        abstract_params(get_config("llama3_2_1b")), mesh))
    return {path for path, spec in specs
            if all(mesh.shape.get(a, 1) == 1 for names in spec
                   if names is not None
                   for a in (names if isinstance(names, tuple)
                             else (names,)))}


def _peaks_gb(marks) -> dict:
    """The largest peak and held GB of each mark label."""
    out = {}
    for label, peak, held in marks:
        p, h = out.get(label, (0.0, 0.0))
        out[label] = (max(p, peak / 1e9), max(h, held / 1e9))
    return out


def phase_train_mesh():
    """The training mesh (``launch/train.py --mesh``, ``runtime/
    elastic.py``, the mesh step, the collective save and the elastic
    restore, ``optim/grad_compress.py``) on full-width llama3_2_1b at the
    launcher's defaults: TRAIN_MESH_A ranks of ``python -m
    torch.distributed.run`` sharing this card (gloo).  Mesh (1, 2), 3
    steps saved at step 3: losses and gradient norms bitwise equal to
    phase train's steps 0-2, and the digest of every leaf each rank holds
    equal to phase train's 3-step state cut to the same shard (the shards
    together are the gathered state; no gather is needed to compare
    them); that checkpoint resumed on (2, 1) to step 6 (the elastic
    change of grid; its final save, which no check reads, skipped):
    losses within TRAIN_MESH_RTOL of phase train's steps 3-5, the leaves
    both ranks hold whole equal on both; the same checkpoint resumed on
    the pod mesh (pod 2, data 1, model 1; ``TRAIN_MESH_POD``, made by the
    worker and handed to ``train.main`` as ``mesh=``) to step 6, its final
    save skipped: losses, gradient norms and the state bitwise the (2, 1)
    run's (the state cut to (2, 1)'s shards equal to the digests that
    run's ranks hold), both pods holding the same shards; one step's
    whole gradient tree through ``compressed_allreduce`` over the axis the
    last run's rows are on ("pod") bitwise equal to the plain rank-ordered
    sum; 2' launches a step as the code's (``train_step_launches``), 4
    and 1 equal to the codec's encode and decode dispatches (the save on
    rank 0, the restore on every rank; no 4 in a run that does not save).
    Logs seconds a step split into gather / compute / reduce, the gathered
    and reduced bytes a step, d2d_psum compressed against dense bytes and
    the gradient ratio, and resident and peak GB a rank for the set-up,
    the step and the save, the pod run's beside the (2, 1) run's."""
    import shutil
    import tempfile
    import torch
    card = card_line()
    want = RESULTS["train"]
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_mesh_"))
    try:
        ranks, secs = _mesh_world(TRAIN_MESH_A, TRAIN_MESH_RUNS, tmp,
                                  worker="--train-mesh-worker",
                                  tag="train_mesh")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    from repro_torch.configs import get_config
    per_step = train_step_launches(N_LAYERS, config_policy(get_config(
        "llama3_2_1b")))["dense_tile_matmul"]
    check(all(all(r["built"].values()) for r in ranks),
          f"train_mesh: a rank compiled kernels: {[r['built'] for r in ranks]}")
    res = {"card": card, "seconds": secs, "backend": ranks[0]["backend"],
           "runs": {}}
    for label in TRAIN_MESH_RUNS:
        runs = [r["runs"][label] for r in ranks]
        sizes = TRAIN_MESH_POD.get(label) or tuple(
            int(v) for v in label.split("x"))
        shape = dict(zip(POD_AXES if label in TRAIN_MESH_POD
                         else ("data", "model"), sizes))
        hist = runs[0]["history"]
        whole = _replicated_leaves(shape)
        steps = [h["step"] for h in hist]
        first = 0 if label == "1x2" else TRAIN_RESUME
        check(steps == list(range(first, first + 3)),
              f"train_mesh {label}: steps {steps}")
        for r, run in zip(ranks, runs):
            tag = f"train_mesh {label} rank {r['rank']}"
            check(run["mesh"] == shape, f"{tag}: mesh {run['mesh']}")
            check([(h["loss"], h["grad_norm"]) for h in run["history"]]
                  == [(h["loss"], h["grad_norm"]) for h in hist],
                  f"{tag}: losses differ from rank 0's")
            check({k: v for k, v in run["digest"].items() if k in whole}
                  == {k: v for k, v in runs[0]["digest"].items()
                      if k in whole},
                  f"{tag}: a leaf every rank holds whole differs from rank "
                  f"0's")
            lc = run["launches"]
            check(lc["dense_tile_matmul"] == 3 * per_step,
                  f"{tag}: 2' launched {lc['dense_tile_matmul']} times in 3 "
                  f"steps, the code says {per_step} a step")
            check(lc["enec_encode"] == run["encode_dispatches"]
                  and lc["enec_decode"] == run["decode_dispatches"]
                  and lc["decompress_matmul"] == 0,
                  f"{tag}: launches {lc}, the codec dispatched "
                  f"{run['encode_dispatches']} encodes and "
                  f"{run['decode_dispatches']} decodes")
            saves = TRAIN_MESH_SAVES[label]
            check(run["saves_skipped"] == ([] if saves else [TRAIN_STEPS]),
                  f"{tag}: saves skipped {run['saves_skipped']}")
            check((lc["enec_encode"] > 0) == (saves and r["rank"] == 0),
                  f"{tag}: kernel 4 at the save on rank 0 only (a run that "
                  f"saves): {lc}")
            check((lc["enec_decode"] > 0) == (label != "1x2"),
                  f"{tag}: kernel 1 at the restore only: {lc}")
        single = want["history"][first:first + 3]
        rel = None
        if label == "1x2":
            check([(h["loss"], h["grad_norm"]) for h in hist]
                  == [(h["loss"], h["grad_norm"]) for h in single],
                  f"train_mesh 1x2: losses {hist} differ from phase train's "
                  f"{single}")
            check([run["digest"] for run in runs] == want["digest_first"],
                  "train_mesh 1x2: the state differs from phase train's "
                  "3-step run cut to the ranks' shards")
        else:
            rel = max(abs(h["loss"] - w["loss"]) / abs(w["loss"])
                      for h, w in zip(hist, single))
            check(rel <= TRAIN_MESH_RTOL, f"train_mesh {label}: losses "
                  f"{hist} vs phase train's {single}: {rel:.2e} relative")
        twin = TRAIN_MESH_POD_TWIN.get(label)
        if twin:
            # (P, D, M) trains as (P·D, M): the twin ran before this run
            theirs = [r["runs"][twin] for r in ranks]
            check([(h["step"], h["loss"], h["grad_norm"]) for h in hist]
                  == [(h["step"], h["loss"], h["grad_norm"])
                      for h in theirs[0]["history"]],
                  f"train_mesh {label}: losses {hist} differ from the "
                  f"{twin} run's {theirs[0]['history']}")
            check(all(run["digest"] == runs[0]["digest"] for run in runs),
                  f"train_mesh {label}: the pods hold different shards")
            check(all(run["as_twin"] == [t["digest"] for t in theirs]
                      for run in runs),
                  f"train_mesh {label}: the state cut to the {twin} mesh's "
                  f"shards differs from what that run's ranks hold")
        marks = [_peaks_gb(run["marks"]) for run in runs]
        res["runs"][label] = {
            "mesh": shape,
            "history": hist, "seconds": [run["seconds"] for run in runs],
            "launches": [run["launches"] for run in runs],
            "gb": marks, "held_gb": [run["held_bytes"] / 1e9 for run in runs],
            "loss_rel": rel}
        split = {k: [h[k] for h in hist] for k in (
            "dt_s", "gather_s", "compute_s", "reduce_s", "gather_bytes",
            "reduce_bytes")}
        res["runs"][label]["split"] = split
        match = ("bitwise equal to phase train" if label == "1x2" else
                 f"losses within {rel:.2e} of phase train")
        if twin:
            match = f"bitwise equal to the {twin} run, " + match
        log(f"train_mesh {label}: {match}, "
            f"ranks equal; s a step {split['dt_s']} (gather "
            f"{[round(v, 3) for v in split['gather_s']]}, compute "
            f"{[round(v, 3) for v in split['compute_s']]}, reduce "
            f"{[round(v, 3) for v in split['reduce_s']]}); gathered "
            f"{split['gather_bytes'][0] / 1e9:.3f} GB, reduced "
            f"{split['reduce_bytes'][0] / 1e9:.3f} GB a step (dense); "
            f"GB a rank (peak, held) " + "; ".join(
                f"rank {i}: " + ", ".join(f"{k} {v[0]:.2f}/{v[1]:.2f}"
                                          for k, v in m.items())
                for i, m in enumerate(marks)) + f" ({card})")
        if twin:
            a, b = res["runs"][label], res["runs"][twin]
            log(f"train_mesh {label} beside {twin}: s a step "
                f"{a['split']['dt_s']} / {b['split']['dt_s']}; gather s "
                f"{a['split']['gather_s']} / {b['split']['gather_s']}; "
                f"compute s {a['split']['compute_s']} / "
                f"{b['split']['compute_s']}; reduce s "
                f"{a['split']['reduce_s']} / {b['split']['reduce_s']}; "
                f"reduced bytes a step {a['split']['reduce_bytes'][0]} / "
                f"{b['split']['reduce_bytes'][0]}; peak / held GB a rank "
                f"{[{k: round(v[0], 2) for k, v in m.items()} for m in a['gb']]}"
                f" / {[{k: round(v[0], 2) for k, v in m.items()} for m in b['gb']]}"
                f", {[round(g, 2) for g in a['held_gb']]} / "
                f"{[round(g, 2) for g in b['held_gb']]} ({card})")
    for r in ranks:
        ar = r["allreduce"]
        check(ar["bitwise"], f"train_mesh rank {r['rank']}: compressed_"
              f"allreduce differs from the plain rank-ordered sum")
        check(ar["launches"]["enec_encode"] == ar["leaves"]
              and ar["launches"]["enec_decode"] == ar["leaves"],
              f"train_mesh rank {r['rank']}: all-reduce launches "
              f"{ar['launches']} for {ar['leaves']} leaves")
        check(ar["link"]["dense_bytes"] == 0,
              f"train_mesh: d2d_psum {ar['link']}")
        last = list(TRAIN_MESH_RUNS)[-1]
        check(ar["axis"] == ("pod" if last in TRAIN_MESH_POD else "data"),
              f"train_mesh rank {r['rank']}: the all-reduce ran over "
              f"{ar['axis']} after the {last} run")
    ar = ranks[0]["allreduce"]
    res["allreduce"] = {k: v for k, v in ar.items() if k != "launches"}
    log(f"train_mesh all-reduce over {ar['axis']} ({ar['ranks']} ranks): "
        f"{ar['leaves']} gradient leaves bitwise "
        f"equal to the plain sum; d2d_psum {ar['link']['compressed_bytes'] / 1e9:.3f} GB "
        f"compressed against {ar['dense_bytes'] / 1e9:.3f} GB dense (ratio "
        f"{ar['ratio']:.4f} as shipped, the static stream layout; "
        f"{ar['wire_ratio']:.4f} at the exact wire size; wire_bytes_saved "
        f"estimates {ar['estimate_ratio']:.4f}), {ar['seconds']:.2f} s "
        f"({card})")
    RESULTS["train_mesh"] = res
    return {f"train_mesh_{label}": ranks[0]["runs"][label]["launches"]
            for label in TRAIN_MESH_RUNS} | {
        "train_mesh_allreduce": ranks[0]["allreduce"]["launches"]}


# ---------------------------------------------------------------------------
# phase remat: rematerialised training (the config's remat and policy)
# ---------------------------------------------------------------------------

REMAT_POLICIES = (None, "nothing", "dots")     # None: remat off
# (rows, seq, steps, policies): phase train's shape, then the train_4k
# sequence with its batch cut 256 -> 1 (remat off is predicted there, not
# run: the dry-run on meta gives its peak)
REMAT_CELLS = {"8x128": (8, 128, 1, REMAT_POLICIES),
               "1x4096": (1, 4096, 2, ("nothing", "dots"))}
# kernel 2' at the long cell's M against its plain version
REMAT_SHAPES = {"wq": (2048, 2048), "w_down": (8192, 2048)}


def _remat_cfg(policy):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3_2_1b"),
                               remat=policy is not None,
                               remat_policy=policy or "nothing")


def _states_equal(a, b) -> bool:
    import torch

    def bits(t):
        return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])

    return all(pa == pb and x.dtype == y.dtype and torch.equal(bits(x),
                                                               bits(y))
               for (pa, x), (pb, y) in zip(_flat_state(a), _flat_state(b)))


def _remat_run(label, policy, rows, seq, steps, keep=None):
    """``steps`` train steps of full-width llama3_2_1b from seed 0 under
    remat ``policy`` (the config through ``dataclasses.replace``; the
    step and AdamW of ``train.main`` at its defaults, lr 3e-4 and
    ``warmup_cosine(20, 100)``) on ``pipeline.batch_at`` batches of rows x
    seq.  Checks finite losses and gradient norms, 2' launches a step equal
    to the code's (``train_step_launches``) and, given ``keep`` (an
    earlier run's final state), the final state bitwise equal to it.
    Returns (the run's record, its final state or None when ``keep`` was
    given)."""
    import torch
    from repro_torch.data import pipeline
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import build_train_step
    cfg = _remat_cfg(policy)
    model = build_model(cfg)
    opt_cfg = adamw.AdamWConfig(lr=3e-4,
                                schedule=adamw.warmup_cosine(20, 100))
    step = build_train_step(model, opt_cfg)
    data = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=rows)
    want = train_step_launches(N_LAYERS, policy)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    params = model.init(seed=0, device="cuda")
    opt = adamw.init(params)
    torch.cuda.reset_peak_memory_stats()
    hist = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in pipeline.batch_at(data, i).items()}
        build.restore(dict.fromkeys(build.counts(), 0))
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        dt = _sync_s(t0)
        launches = build.counts()
        hist.append({"loss": float(met["loss"]),
                     "grad_norm": float(met["grad_norm"]), "s": dt})
        check(launches == want, f"remat {label} {policy}: step {i} "
              f"launched {launches}, the code says {want}")
        check(math.isfinite(hist[-1]["loss"])
              and math.isfinite(hist[-1]["grad_norm"]),
              f"remat {label} {policy}: step {i} {hist[-1]}")
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    state = {"params": params, "opt_state": opt}
    del params, opt, met
    if keep is not None:
        check(_states_equal(keep, state), f"remat {label} {policy}: the "
              f"state after {steps} steps differs from remat "
              f"{REMAT_CELLS[label][3][0]}'s")
        state = None
    return {"history": hist, "peak_gb": peak,
            "launches_per_step": want["dense_tile_matmul"]}, state


def _remat_prediction(policy, rows, seq) -> float:
    """The dry-run's peak (GB) of the same train step on ``meta``
    (``lower_cell`` on a 1x1 mesh, ``ShapeSpec`` seq x rows, kind
    train)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    rec = dryrun.lower_cell(_remat_cfg(policy),
                            ShapeSpec("train_4k", seq, rows, "train"),
                            AbstractMesh((1, 1), ("data", "model")))
    return rec["memory"]["peak_memory_in_bytes"] / 1e9


def phase_remat():
    """Rematerialised training (``models/remat.py``) on full-width
    llama3_2_1b, its weights seeded: (a) batch 8 x 128 (phase train's
    shape), one step from seed 0 each with remat off, ``nothing`` and
    ``dots``; (b) the train_4k sequence, 4096 tokens, batch cut 256 -> 1,
    two steps each with ``nothing`` and ``dots``.  Checks: in each cell
    the states (params and AdamW moments) after the steps bitwise equal
    across the policies, losses and gradient norms finite (equal across
    the policies), 2' launches a step equal to the code's count
    (``train_step_launches``: 339 / 435 / 339); kernel 2' against its plain
    version at the long cell's M (``_train_backward_checks`` on
    REMAT_SHAPES); the peak over what was allocated before each run's
    state was made within DRYRUN_PEAK_RTOL of the dry-run's peak of the
    same step on ``meta`` (1x1 mesh).  Logs seconds a step, the peaks and
    their ratios, and the dry-run's peak of remat off at 4096 tokens,
    which is not run."""
    import torch
    card = card_line()
    res = {"card": card, "cells": {}}
    launches = {}
    for label, (rows, seq, steps, policies) in REMAT_CELLS.items():
        cell, first = {}, None
        for policy in policies:
            run, state = _remat_run(label, policy, rows, seq, steps,
                                    keep=first)
            if first is None:
                first = state
            run["predicted_peak_gb"] = _remat_prediction(policy, rows, seq)
            run["peak_ratio"] = run["predicted_peak_gb"] / run["peak_gb"]
            check(abs(run["peak_ratio"] - 1) <= DRYRUN_PEAK_RTOL,
                  f"remat {label} {policy}: the dry-run's peak "
                  f"{run['predicted_peak_gb']:.2f} GB against "
                  f"{run['peak_gb']:.2f} GB measured")
            cell[str(policy)] = run
            if label == "8x128":
                launches[f"remat_{policy or 'off'}"] = dict.fromkeys(
                    KERNELS, 0) | {"dense_tile_matmul":
                                   steps * run["launches_per_step"]}
        del first, state
        torch.cuda.empty_cache()
        losses = {p: [(h["loss"], h["grad_norm"]) for h in r["history"]]
                  for p, r in cell.items()}
        check(len({tuple(v) for v in losses.values()}) == 1,
              f"remat {label}: losses or gradient norms differ across "
              f"policies {losses}")
        for p in ("None", "nothing", "dots"):
            if p not in cell:
                cell[p] = {"predicted_peak_gb": _remat_prediction(
                    None if p == "None" else p, rows, seq), "run": False}
        res["cells"][label] = cell
        log(f"remat {label} ({rows} x {seq}, {steps} step(s) a policy): "
            + "; ".join(
                f"{p}: " + (f"{sum(h['s'] for h in r['history']) / steps:.3f}"
                            f" s a step, peak {r['peak_gb']:.2f} GB against "
                            f"the dry-run's {r['predicted_peak_gb']:.2f} "
                            f"(ratio {r['peak_ratio']:.3f}), 2' "
                            f"{r['launches_per_step']} a step"
                            if r.get("run", True) else
                            f"not run, the dry-run's peak "
                            f"{r['predicted_peak_gb']:.2f} GB")
                for p, r in cell.items())
            + f"; loss {cell['nothing']['history'][-1]['loss']:.4f}, states "
              f"bitwise equal ({card})")
    res["kernel_checks"] = _train_backward_checks(4096, REMAT_SHAPES,
                                                  "remat")
    torch.cuda.empty_cache()
    RESULTS["remat"] = res
    return launches


# ---------------------------------------------------------------------------
# phase examples: examples_torch/ on the card, then llama3_2_1b served from
# a compress_params_for_streaming tree at full width
# ---------------------------------------------------------------------------

# the kernels each example launches, by the code (the fused entry, the
# standalone scan and the KV attention run in none of them)
EXAMPLE_KERNELS = {
    "quickstart": {"enec_encode", "enec_decode"},
    "compress_checkpoint": {"enec_encode", "enec_decode"},
    "serve_compressed": {"enec_encode", "enec_decode", "dense_tile_matmul"},
    "serve_moe_streaming": {"enec_encode", "enec_decode",
                            "dense_tile_matmul"},
    # the steps (2'), the saves (4) and the resume's restore (1)
    "train_lm": {"enec_encode", "enec_decode", "dense_tile_matmul"},
}
# train_lm at its small preset: TRAIN_LM_STEPS[0] steps, then a second call
# on the same directory resumed to TRAIN_LM_STEPS[1] (step 10 is logged)
TRAIN_LM_STEPS = (3, 12)
EXAMPLES_TIME_LIMIT_S = 300


def _example_module(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(name: str, args: list) -> tuple:
    """``examples_torch/<name>.py``'s ``main(args + --device cuda)`` in
    this process, its launch counts set to 0 just before and read just
    after.  Returns (its return value, its stdout, the counts, seconds);
    a failed self-check raises through."""
    import contextlib
    import io
    import torch
    from repro_torch.launch import serve
    mod = _example_module(name)
    buf = io.StringIO()
    serve.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(args + ["--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = serve.launch_counts()
    for line in buf.getvalue().splitlines():
        log(f"  {name}: {line}")
    return out, buf.getvalue(), counts, secs


def _eager_serve(model, tree, prompts, max_len: int) -> tuple:
    """Prefill then ``TOKENS - 1`` greedy ``decode_fn`` steps, eagerly.
    Returns (each token's logits, the tokens, TTFT s, TPOT s)."""
    import torch
    t0 = time.perf_counter()
    logits, cache = model.prefill_fn(tree, {"tokens": prompts}, max_len)
    ttft = _sync_s(t0)
    tok = torch.argmax(logits, -1)
    outs, toks = [logits], [tok]
    t0 = time.perf_counter()
    for _ in range(TOKENS - 1):
        logits, cache = model.decode_fn(tree, cache, tok)
        tok = torch.argmax(logits, -1)
        outs.append(logits)
        toks.append(tok)
    tpot = _sync_s(t0) / (TOKENS - 1)
    return outs, torch.stack(toks, dim=1), ttft, tpot


def _stream_everything(card) -> tuple:
    """Full-width llama3_2_1b (seeded, no cut) through the reference's
    stream-everything entry points at their defaults (1 MiB, 16 shards):
    ``streaming_encode_plan`` then ``compress_params_for_streaming(plan=)``
    (kernel-4 launches = the plan's buckets); 4 prompts x 64 + 16 greedy
    tokens through ``prefill_fn`` / ``decode_fn`` eagerly, logits bitwise
    the dense tree's, launches the code's (each step: the embed's decode,
    each layer's prefetched decode of ``buckets_per_layer`` launches or
    one a leaf, a 2' launch a product and the head's); then
    ``materialize_weight_tree`` bitwise the dense tree in one kernel-1
    launch per bucket of its decode plan.  Returns (launches by path,
    the record)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import Codec
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.runtime import streaming
    from repro_torch.runtime.overlap import build_schedule, overlap_enabled
    zero = dict.fromkeys(KERNELS, 0)
    cfg = get_config("llama3_2_1b")
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    params = model.init(seed=0, device="cuda")
    codec = Codec()
    serve.reset_launch_counts()
    t0 = time.perf_counter()
    plan = streaming.streaming_encode_plan(params, codec=codec)
    tree = streaming.compress_params_for_streaming(params, codec=codec,
                                                   plan=plan)
    setup_s = _sync_s(t0)
    setup = serve.launch_counts()
    buckets, wire = len(plan.buckets), plan.predicted_wire_bytes
    check(setup == zero | {"enec_encode": buckets},
          f"examples: compress_params_for_streaming launched {setup}, "
          f"the plan has {buckets} buckets")
    del plan      # it holds its staged blocks (1.24 GB at full width)
    stats = streaming.stream_stats(tree)
    check(stats["streamed_tensors"] >= 1 + len(LEAVES)
          and stats["flat_stream_tensors"] == 1,
          f"examples: the streamed tree {stats}")

    prompts = torch.from_numpy(_prompts(cfg.vocab_size)).cuda()
    max_len = PROMPT + TOKENS
    want, want_toks, dense_ttft, dense_tpot = _eager_serve(
        model, params, prompts, max_len)
    period = tree["period"]
    bpl = (build_schedule(period, N_LAYERS).buckets_per_layer
           if overlap_enabled(cfg.overlap, period, N_LAYERS) else None)
    step = step_launches(N_LAYERS, FLAT["llama3_2_1b"], bpl)["stream"]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    serve.reset_launch_counts()
    got, toks, ttft, tpot = _eager_serve(model, tree, prompts, max_len)
    served = serve.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(_bits_equal(got, want), "examples: logits of the streamed tree "
          "not bitwise equal to the dense tree's")
    check(torch.equal(toks, want_toks), "examples: tokens differ")
    check(served == {k: TOKENS * v for k, v in step.items()},
          f"examples: the streamed serve launched {served}, the code says "
          f"{TOKENS} x {step}")

    handles = [h for _, h in streaming.tree_leaves(tree)
               if streaming.is_handle(h)]
    dplan = codec.plan_decode([h.ct for h in handles])
    serve.reset_launch_counts()
    t0 = time.perf_counter()
    dense = streaming.materialize_weight_tree(tree, codec)
    mat_s = _sync_s(t0)
    mat = serve.launch_counts()
    check(mat == zero | {"enec_decode": len(dplan.buckets)},
          f"examples: materialize_weight_tree launched {mat}, its decode "
          f"plan has {len(dplan.buckets)} buckets")
    back = dict(streaming.tree_leaves(dense))
    for name, w in streaming.tree_leaves(params):
        got = back[name]
        check(got.dtype == w.dtype and got.shape == w.shape and torch.equal(
            got.contiguous().view(torch.uint8), w.view(torch.uint8)),
            f"examples: materialize_weight_tree's {name} differs")
    rec = {"setup_s": setup_s, "encode_buckets": buckets,
           "predicted_wire_bytes": wire,
           "stream_stats": stats,
           # phase serve's stream mode (absent in a short call without it)
           "serve_stream_hbm_ratio": RESULTS.get("serve", {}).get(
               "modes", {}).get("stream", {}).get("hbm_ratio"),
           "ttft_s": ttft, "tpot_s": tpot, "dense_ttft_s": dense_ttft,
           "dense_tpot_s": dense_tpot, "peak_gb": peak,
           "peak_over_held_gb": peak - held / 1e9,
           "buckets_per_layer": bpl, "step_launches": step,
           "materialize_s": mat_s, "decode_buckets": len(dplan.buckets)}
    log(f"examples llama3_2_1b stream-everything: set-up {setup_s:.3f} s "
        f"({buckets} encode launch(es)), {stats['streamed_tensors']} "
        f"streamed leaves, hbm ratio {stats['hbm_ratio']:.4f} (phase "
        f"serve's stream mode {rec['serve_stream_hbm_ratio']}); eager "
        f"TTFT {ttft * 1e3:.2f} ms, TPOT {tpot * 1e3:.2f} ms (dense tree "
        f"{dense_ttft * 1e3:.2f} / {dense_tpot * 1e3:.2f}), peak {peak:.2f}"
        f" GB ({rec['peak_over_held_gb']:.2f} over the held trees), logits "
        f"bitwise the dense tree's, launches {served} = {TOKENS} steps of "
        f"the code's; materialize_weight_tree {mat_s * 1e3:.1f} ms in "
        f"{len(dplan.buckets)} decode launch(es), bitwise; {card}")
    del params, tree, dense, back, got, want
    torch.cuda.empty_cache()
    return {"examples_llama3_2_1b_setup": setup,
            "examples_llama3_2_1b_serve": served,
            "examples_llama3_2_1b_materialize": mat}, rec


def phase_examples():
    """The five ``examples_torch/`` scripts on the card: (a) each
    ``main([..., "--device", "cuda"])`` in this process, its launches
    counted alone (``examples_<name>``) and the kernels it launches those
    of the code (``EXAMPLE_KERNELS``); ``train_lm`` at its small preset
    for 3 steps, then resumed on the same directory to 12 (one path);
    every self-check raises through; (b) ``python
    examples_torch/quickstart.py`` in a subprocess, exit 0 and its stdout
    the in-process run's; (c) :func:`_stream_everything`."""
    import shutil
    import tempfile
    card = card_line()
    launches, res = {}, {"card": card, "runs": {}}
    quick_out = None
    for name in ("quickstart", "compress_checkpoint", "serve_compressed",
                 "serve_moe_streaming"):
        out, stdout, counts, secs = _run_example(name, [])
        if name == "quickstart":
            quick_out = stdout
        if name == "serve_compressed":
            check(counts["enec_encode"] == out["encode_buckets"],
                  f"examples serve_compressed: {counts['enec_encode']} "
                  f"encode launches for {out['encode_buckets']} buckets")
        launches[f"examples_{name}"] = counts
        res["runs"][name] = {"s": secs, "launches": counts,
                             "stdout": stdout}
    ck = tempfile.mkdtemp(prefix="enec-train-lm-")
    try:
        counts = dict.fromkeys(KERNELS, 0)
        outs, secs = [], 0.0
        for steps in TRAIN_LM_STEPS:
            out, stdout, c, s = _run_example(
                "train_lm", ["--steps", str(steps), "--ckpt-dir", ck])
            outs.append((out, stdout))
            counts = {k: counts[k] + c[k] for k in KERNELS}
            secs += s
        (first, _), (second, resumed) = outs
        check([r["step"] for r in first["history"]]
              == list(range(TRAIN_LM_STEPS[0])),
              f"examples train_lm: first run's steps "
              f"{[r['step'] for r in first['history']]}")
        check(f"resumed from step {TRAIN_LM_STEPS[0]}" in resumed
              and [r["step"] for r in second["history"]]
              == list(range(*TRAIN_LM_STEPS)),
              "examples train_lm: the second run did not resume")
        check(all(math.isfinite(r["loss"]) for o in (first, second)
                  for r in o["history"]),
              "examples train_lm: non-finite losses")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    launches["examples_train_lm"] = counts
    res["runs"]["train_lm"] = {
        "s": secs, "launches": counts,
        "losses": [r["loss"] for o, _ in outs for r in o["history"]]}
    for name, kernels in EXAMPLE_KERNELS.items():
        ran = {k for k, n in launches[f"examples_{name}"].items() if n}
        check(ran == kernels, f"examples {name}: launched {ran}, the code "
              f"launches {kernels}")

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / "quickstart.py")],
        cwd=ROOT, capture_output=True, text=True,
        timeout=EXAMPLES_TIME_LIMIT_S)
    res["subprocess_s"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"examples: quickstart.py exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    check(proc.stdout == quick_out, "examples: quickstart.py's stdout "
          f"differs from the in-process run's:\n{proc.stdout}")

    full, res["llama3_2_1b"] = _stream_everything(card)
    launches.update(full)
    log(f"examples: five examples' self-checks passed ("
        + ", ".join(f"{n} {r['s']:.1f} s" for n, r in res["runs"].items())
        + f"), train_lm resumed at step {TRAIN_LM_STEPS[0]}, the "
        f"subprocess quickstart ({res['subprocess_s']:.1f} s) printed the "
        f"in-process lines; launches {launches}")
    RESULTS["examples"] = res
    return launches


# ---------------------------------------------------------------------------
# phase dryrun: the dry-run's predictions against the card
# ---------------------------------------------------------------------------

# the cell one card runs: llama3_2_1b decode at batch 4 over a cache of 128
# on a 1x1 mesh; the named shape's kind and the cut sizes
DRYRUN_SHAPE = ("decode_32k", 128, 4)
DRYRUN_PEAK_RTOL = 0.20
# two full-size cells of the 16x16 mesh, dry-run in a subprocess on this
# machine's CPU while the card runs the earlier phases (nothing touches
# the card): the full-size path on the machine with the card
DRYRUN_CELLS = (("llama3_2_1b", "decode_32k"),
                ("qwen3_moe_235b_a22b", "train_4k"))
DRYRUN_CELLS_TIME_LIMIT_S = 900
_DRYRUN_PROCS: list = []


def start_dryrun_cells():
    """Start the dry-run of DRYRUN_CELLS (``python -m
    repro_torch.launch.dryrun``, one process a cell, on the CPU) into
    ``chiprun_out/dryrun/``; :func:`phase_dryrun` reads their records."""
    import os
    out = ROOT / "chiprun_out" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        CUDA_VISIBLE_DEVICES="")
    for arch, shape in DRYRUN_CELLS:
        log_path = out / f"{arch}__{shape}.log"
        with open(log_path, "w") as f:
            _DRYRUN_PROCS.append((arch, shape, log_path, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--single-only", "--out", str(out)],
                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)))


def stop_dryrun_cells():
    """Kill the dry-run processes still running (a failed run)."""
    for *_, proc in _DRYRUN_PROCS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _dryrun_step_flops(layers: int) -> int:
    """2 M K N summed over one llama decode step's products: every layer's
    7 leaves and the tied head, at M = the batch."""
    m = DRYRUN_SHAPE[2]
    per_layer = sum(k * n for k, n in LEAVES.values())
    return 2 * m * (layers * per_layer + 2048 * 128256)


def phase_dryrun():
    """The dry-run (``launch/dryrun.py``) against the card on the cell one
    card runs: llama3_2_1b at full width, decode at batch 4 over a cache of
    128, on a 1x1 mesh, in dense, stream and fused mode.  For each mode a
    tree is built on the card (``assign_weight_modes`` at the dry-run's
    1 MiB and 16 shards) and ``lower_cell`` runs on ``meta`` tensors twice:
    on that tree's layout (``tree=``: its escapes and decoder buckets, which
    the encoder's searched parameters decide) and on the abstract tree of
    the paper's Table IV parameters; then the same eager ``decode_fn`` step
    runs on the card, after one warm-up step.  Checks: the dry-run's
    launches a kernel (on the tree's layout) equal to the counters' deltas
    over the step, and so are the abstract tree's in dense and fused mode
    (stream mode's decoder buckets a layer are the encoder's; logged); its
    kernel FLOPs equal to 2 M K N summed over the step's products; its
    peak within DRYRUN_PEAK_RTOL of ``torch.cuda.max_memory_allocated``
    over the step, measured from a reset (less what was allocated before
    the tree was made); finite logits of (4, vocab).  Logs the H100
    roofline terms of the cell beside the measured step time, and the
    records of the two 16x16 cells of DRYRUN_CELLS."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.codec_api import Codec, use_codec
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import build_model
    from repro_torch.models.registry import input_specs
    from repro_torch.runtime import streaming
    from repro_torch.runtime.overlap import build_schedule, overlap_enabled
    from repro_torch.runtime.steps import build_decode_step
    card = card_line()
    cfg = get_config("llama3_2_1b")
    shape = ShapeSpec(*DRYRUN_SHAPE, "decode")
    model = build_model(cfg)
    chip = roofline.H100
    want_flops = _dryrun_step_flops(N_LAYERS)
    res = {"card": card, "shape": list(DRYRUN_SHAPE), "modes": {}}

    def mesh():
        return AbstractMesh((1, 1), ("data", "model"))

    for mode in ("dense", "stream", "fused"):
        abstract = dryrun.lower_cell(cfg, shape, mesh(), mode=mode)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        codec = Codec()
        with use_codec(codec):
            tree = streaming.assign_weight_modes(
                model.init(seed=0, device="cuda"), mode=mode,
                min_bytes=streaming.MIN_STREAM_BYTES,
                shards=streaming.STREAM_SHARDS, codec=codec)
            n_periods = cfg.n_layers // len(tree["period"])
            if overlap_enabled(cfg.overlap, tree["period"], n_periods):
                build_schedule(tree["period"], n_periods)
            rec = dryrun.lower_cell(cfg, shape, mesh(), mode=mode, tree=tree)
            specs = input_specs(cfg, shape, device="cuda")
            step = build_decode_step(model)
            step(tree, specs["cache"], specs["tokens"])      # warm-up
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            build.restore(dict.fromkeys(build.counts(), 0))
            t0 = time.perf_counter()
            logits, _ = step(tree, specs["cache"], specs["tokens"])
            step_s = _sync_s(t0)
            launches = build.counts()
            peak = torch.cuda.max_memory_allocated() - held
        check(tuple(logits.shape) == (DRYRUN_SHAPE[2], cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"dryrun {mode}: logits {tuple(logits.shape)} not finite")
        del tree, specs, logits, step
        counted = {k: v for k, v in launches.items() if v}
        predicted = {k: v["launches"] for k, v in rec["kernels"].items()}
        table_iv = {k: v["launches"] for k, v in abstract["kernels"].items()}
        check(predicted == counted, f"dryrun {mode}: predicted launches "
              f"{predicted}, the card's counters {counted}")
        check(mode == "stream" or table_iv == counted,
              f"dryrun {mode}: the abstract tree's launches {table_iv}, the "
              f"card's counters {counted}")
        kernel_flops = sum(v["flops"] for v in rec["kernels"].values())
        check(kernel_flops == want_flops, f"dryrun {mode}: kernel FLOPs "
              f"{kernel_flops} != the analytic {want_flops}")
        predicted_peak = rec["memory"]["peak_memory_in_bytes"]
        ratio = predicted_peak / peak
        check(abs(ratio - 1) <= DRYRUN_PEAK_RTOL,
              f"dryrun {mode}: predicted peak {predicted_peak / 1e9:.3f} GB "
              f"against {peak / 1e9:.3f} GB measured (ratio {ratio:.3f})")
        terms = {"compute_ms": 1e3 * rec["cost"]["flops"] / chip.peak_flops,
                 "memory_ms": 1e3 * rec["cost"]["bytes accessed"]
                 / chip.hbm_bw,
                 "collective_ms": 1e3 * rec["collectives"]["total_wire_bytes"]
                 / chip.link_bw}
        res["modes"][mode] = {
            "launches": launches, "predicted_launches": predicted,
            "table_iv_launches": table_iv,
            "table_iv_peak_gb":
                abstract["memory"]["peak_memory_in_bytes"] / 1e9,
            "kernel_flops": kernel_flops, "flops": rec["cost"]["flops"],
            "bytes": rec["cost"]["bytes accessed"],
            "predicted_peak_gb": predicted_peak / 1e9,
            "measured_peak_gb": peak / 1e9, "peak_ratio": ratio,
            "roofline_ms": terms, "step_ms": 1e3 * step_s,
            "lower_s": rec["lower_s"]}
        log(f"dryrun llama3_2_1b {mode} (decode, batch 4, cache 128, 1x1): "
            f"launches {predicted} equal to the counters (Table IV tree: "
            f"{table_iv}); kernel FLOPs {kernel_flops:.4e} = 2 M K N; peak "
            f"predicted {predicted_peak / 1e9:.3f} GB / measured "
            f"{peak / 1e9:.3f} GB (ratio {ratio:.3f}; Table IV tree "
            f"{abstract['memory']['peak_memory_in_bytes'] / 1e9:.3f} GB); "
            f"roofline on {roofline.H100_NAME}: compute "
            f"{terms['compute_ms']:.4f} ms, memory {terms['memory_ms']:.4f} "
            f"ms (un-fused bytes {rec['cost']['bytes accessed']:.4e}), "
            f"collective {terms['collective_ms']:.4f} ms; measured eager "
            f"step {1e3 * step_s:.3f} ms; dry-run {rec['lower_s']:.2f} s "
            f"({card})")
    torch.cuda.empty_cache()
    res["cells"] = {}
    t0 = time.perf_counter()
    for arch, shape_name, log_path, proc in _DRYRUN_PROCS:
        try:
            code = proc.wait(timeout=max(
                1, DRYRUN_CELLS_TIME_LIMIT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            stop_dryrun_cells()
            fail(f"dryrun {arch} x {shape_name}: still running after "
                 f"{DRYRUN_CELLS_TIME_LIMIT_S} s")
        out = log_path.read_text()
        check(code == 0, f"dryrun {arch} x {shape_name} exited {code}:\n"
              f"{out[-3000:]}")
        rec = json.loads((log_path.with_suffix(".json")).read_text())
        row = roofline.analyze_cell(rec)
        full = rec["single"]["full"]
        res["cells"][f"{arch} x {shape_name}"] = {
            "record": {k: full[k] for k in ("cost", "memory", "collectives",
                                            "kernels", "program",
                                            "lower_s")},
            "roofline": row}
        log(f"dryrun {arch} x {shape_name} (16x16, rank 0, on the host's "
            f"CPU): {full['program']}; flops {full['cost']['flops']:.4e}, "
            f"bytes {full['cost']['bytes accessed']:.4e}, peak "
            f"{full['memory']['peak_memory_in_bytes'] / 2**30:.1f} GiB, wire "
            f"{full['collectives']['total_wire_bytes']:.4e} B, launches "
            f"{ {k: v['launches'] for k, v in full['kernels'].items()} }, "
            f"{full['lower_s']} s; roofline on {roofline.H100_NAME}: compute "
            f"{row['compute_s']:.4e} s, memory {row['memory_s']:.4e} s, "
            f"collective {row['collective_s']:.4e} s, dominant "
            f"{row['dominant']}")
    RESULTS["dryrun"] = res
    return {f"dryrun_{m}": r["launches"] for m, r in res["modes"].items()}


# ---------------------------------------------------------------------------

# the served path whose own run gives each kernel's ``launches``: the
# default fused mode (the main path) runs the decoder, the fused entry and
# the dense-tile entry (the logits head), and its set-up the encoder
KERNEL_PATH = {"enec_decode": "fused", "decompress_matmul": "fused",
               "dense_tile_matmul": "fused", "enec_encode": "fused",
               "idd_scan": "scan", "decode_attention_kv": "kv_attention"}


def kernels_line(launches):
    """``launches`` maps each served run to the counts read right after
    that run, with every count set to 0 just before it."""
    d, mm, enc = RESULTS["decode"], RESULTS["matmul"], RESULTS["encode"]
    sc = RESULTS["scan"]
    sc_row = sc["timed"][sc["row_shape"]]
    kv = RESULTS["kv_attention"]
    kv_row = kv["rows"][f"minitron_4b {KV_FULL['minitron_4b']}"]
    t = mm["totals_m_batch"]
    src = "src/repro_torch/csrc/"
    rows = [
        {"name": "enec_decode", "route": "cuda",
         "source": src + "enec_decode.cu",
         "replaces": "src/repro/kernels/enec_decode.py:135",
         "max_abs_err": d["embed_max_abs_err"],
         "ms": d["embed_ms"], "plain_ms": d["embed_plain_ms"],
         "bound_ms": d["embed_bound_ms"], "bound_by": "bytes",
         "library_ms": None, "dev_ms": d["embed_dev_ms"],
         "copy_ms": d["embed_copy_ms"], "plan": d["embed_plan"],
         "timed": d["embed_timed"], "layer_stream": d["layer_stream"],
         "moe_routed_experts": RESULTS["moe"]["kernels"]["decode"],
         "resources": d["resources"]},
        {"name": "decompress_matmul", "route": "cuda",
         "source": src + "decompress_matmul.cu",
         "replaces": "src/repro/kernels/decompress_matmul.py:66",
         "max_abs_err": mm["max_abs_err"], "ms": t["fused"],
         "plain_ms": t["fused_plain"], "bound_ms": t["fused_bound"],
         "bound_by": "bytes", "library_ms": t["library"],
         "timed": {c: {k: v[k] for k in ("fused", "fused_bound", "library")}
                   for c, v in mm["totals"].items()},
         "moe_attention": RESULTS["moe"]["kernels"]["fused_attention"],
         "families": {arch: c["modes"]["fused"]["kernel_checks"]
                      for arch, c in RESULTS["families"]["cases"].items()},
         "whisper": RESULTS["whisper"]["modes"]["fused"]["kernel_checks"],
         "resources": {k: v for k, v in mm["resources"]["ptxas"].items()
                       if k.startswith("fused")}},
        {"name": "dense_tile_matmul", "route": "cuda",
         "source": src + "decompress_matmul.cu",
         "replaces": "src/repro/kernels/ref.py:31",
         "max_abs_err": mm["max_abs_err_dense"],
         "ms": t["dense"], "plain_ms": t["dense_plain"],
         "bound_ms": t["dense_bound"], "bound_by": "bytes",
         "library_ms": t["library"], "head": mm["head"],
         "moe_expert": RESULTS["moe"]["kernels"]["dense_tile"],
         "train_backward": RESULTS["train"]["backward"],
         "train_launches_per_step": RESULTS["train"]["launches_per_step"],
         "remat": {label: {p: {k: r[k] for k in ("launches_per_step",
                                                 "peak_gb",
                                                 "predicted_peak_gb")
                               if k in r}
                           for p, r in cell.items()}
                   for label, cell in RESULTS["remat"]["cells"].items()},
         "remat_4096": RESULTS["remat"]["kernel_checks"],
         "families": {arch: c["modes"]["dense"]["kernel_checks"]
                      for arch, c in RESULTS["families"]["cases"].items()},
         "whisper": RESULTS["whisper"]["modes"]["dense"]["kernel_checks"],
         "timed": {c: {k: v[k] for k in ("dense", "dense_t", "dense_bound",
                                         "library")}
                   for c, v in mm["totals"].items()},
         "resources": {k: v for k, v in mm["resources"]["ptxas"].items()
                       if k.startswith("dense")}},
        {"name": "enec_encode", "route": "cuda",
         "source": src + "enec_encode.cu",
         "replaces": "src/repro/kernels/enec_encode.py:89",
         "max_abs_err": enc["embed_max_abs_err"],
         "ms": enc["embed_ms"], "plain_ms": enc["embed_plain_ms"],
         "bound_ms": enc["embed_bound_ms"], "bound_by": "bytes",
         "library_ms": None, "setup_launches": enc["setup_launches"],
         "dev_ms": enc["embed_dev_ms"], "copy_ms": enc["embed_copy_ms"],
         "plan": enc["embed_plan"], "generic": enc["embed_generic"],
         "moe_expert_leaf": RESULTS["moe"]["kernels"]["encode"],
         "resources": enc["resources"]},
        {"name": "idd_scan", "route": "cuda", "source": src + "idd_scan.cu",
         "replaces": "src/repro/kernels/idd_scan.py:73",
         "max_abs_err": sc["max_abs_err"], "shape": sc["row_shape"],
         "ms": sc_row["ms"], "plain_ms": sc_row["plain_ms"],
         "bound_ms": sc_row["bound_ms"], "bound_by": "bytes",
         "library_ms": sc_row["library_ms"], "timed": sc["timed"],
         "plan": sc_row["plan"], "resources": sc["resources"]},
        {"name": "decode_attention_kv", "route": "cuda",
         "source": src + "decode_attention_kv.cu",
         "replaces": "src/repro/kernels/decode_attention_kv.py:105",
         "max_abs_err": kv["max_abs_err"], "shape": kv_row["shape"],
         "ms": kv_row["ms"], "plain_ms": kv_row["plain_ms"],
         "bound_ms": kv_row["bound_ms"], "bound_by": kv_row["bound_by"],
         "library_ms": kv_row["library_ms"],
         "timed": {label: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "library_ms", "dev_ms",
                                             "library_dev_ms", "plan")}
                   for label, r in kv["rows"].items() if "ms" in r},
         "plan": kv_row["plan"], "resources": kv["resources"]},
    ]
    per_step = RESULTS["engine"]["cases"]
    families = RESULTS["families"]["cases"]
    for row in rows:
        row["launches_per_captured_step"] = {
            case: c["together"]["launches_per_step"][row["name"]]
            for case, c in per_step.items()} | {
            f"{arch} {mode}": r["launches_per_step"][row["name"]]
            for arch, c in families.items()
            for mode, r in c["modes"].items()} | {
            f"whisper_tiny {mode}": r["launches_per_step"][row["name"]]
            for mode, r in RESULTS["whisper"]["modes"].items()}
        path = KERNEL_PATH[row["name"]]
        row["launches"] = launches[path][row["name"]]
        check(row["launches"] > 0, f"{row['name']} was not launched in its "
              f"path {path}")
        row["path"] = path
        row["launches_by_path"] = {m: c[row["name"]]
                                   for m, c in launches.items()}
    return {"kernels": rows}


def main():
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a GPU")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    from repro_torch.launch import serve
    check(tuple(serve.COUNTERS) == KERNELS,
          f"counters {tuple(serve.COUNTERS)} != {KERNELS}")
    t0 = time.perf_counter()
    log(f"phases start {t0 - T_SCRIPT:.1f} s into the script")
    secs = RESULTS["phase_s"] = {}

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        secs[phase.__name__] = round(time.perf_counter() - t, 1)
        return out

    timed(phase_build)
    start_dryrun_cells()
    timed(phase_decode)
    timed(phase_encode)
    timed(phase_matmul)
    launches, fused = timed(phase_serve)
    timed(phase_setup_encode, fused)
    launches.update(timed(phase_ckpt, fused))
    launches.update(timed(phase_degraded, fused))
    del fused
    for phase in (phase_mesh, phase_engine, phase_overlap, phase_scan,
                  phase_kv_attention, phase_serve_minitron, phase_moe,
                  phase_families, phase_api, phase_whisper, phase_train,
                  phase_train_mesh, phase_remat, phase_examples,
                  phase_dryrun):
        launches.update(timed(phase))
    log(f"seconds by phase: {secs}")
    line = kernels_line(launches)
    RESULTS["kernels"] = line["kernels"]
    RESULTS["seconds"] = time.perf_counter() - t0
    RESULTS["script_s"] = time.perf_counter() - T_SCRIPT
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1))
    log(f"done in {RESULTS['seconds']:.1f}s ({RESULTS['script_s']:.1f} s "
        f"since the script started)")
    print(card_line())
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--train-mesh-worker"]:
        train_mesh_worker(sys.argv[2])
    else:
        import atexit
        # on stderr (stdout's last line is the result): when the
        # interpreter's exit starts, after every non-daemon thread has
        # ended, so a slow exit shows whether threads or teardown hold it
        atexit.register(lambda: print(
            f"[chip_smoke] interpreter exit starts "
            f"{time.perf_counter() - T_SCRIPT:.1f} s after the script's "
            f"start", file=sys.stderr, flush=True))
        try:
            main()
        finally:
            stop_dryrun_cells()
