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
           from seeded synthetic weights: xlstm_125m and paligemma_3b at
           full width, jamba_v0_1_52b at published widths cut to 8 layers
           (one period), each in dense, stream and fused mode, 4 requests
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
6. a ``{"kernels": [...]}`` JSON line, then the card line and the last
   line ``{"ok": true, "device": {...}}``.  Each kernel's ``launches`` is
   its count in the run of its ``path`` (fused, the main path, for the
   decoder, the encoder, the fused entry and the dense-tile entry, which
   runs the logits head; ``scan`` and ``kv_attention`` for kernels 3 and
   5);
   ``launches_by_path`` gives its count in each run (the three llama
   modes, ``ckpt_save``, ``ckpt_restore``, ``degraded``,
   ``degraded_stream``, ``engine_fused``, ``overlap_llama3_2_1b``,
   ``overlap_minitron_4b``, ``scan``,
   ``kv_attention``, the three ``minitron_*`` modes, the six ``moe_*``
   runs, the nine ``families_*`` runs and ``api``), and
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


def run_step_launches(arch: str, mode: str, out: dict) -> dict:
    """One decode step's launches of a ``serve.main`` run, its stream
    mode's prefetch read from the run's schedule (``out["overlap"]``)."""
    bpl = (out["overlap"]["buckets_per_layer"] if out["overlap"]["enabled"]
           else None)
    return step_launches(ARCH_LAYERS[arch], FLAT[arch], bpl)[mode]

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
    import torch
    from repro_torch.kernels import ops
    out = {}
    x = torch.randint(0, 9, (4, 1024), dtype=torch.int32, device="cuda")
    a = torch.randn((4, 256), device="cuda").bfloat16()
    w = torch.randn((256, 256), device="cuda").bfloat16()
    ops.idd_scan(x)
    ops.tiled_matmul(a, w)
    torch.cuda.synchronize()
    for name, fn in (("idd_scan", lambda: ops.idd_scan(x)),
                     ("matmul_counters", lambda: ops.tiled_matmul(a, w))):
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
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
# trees together (~21.3 + 20 GB at 8 layers, ~80 GB at 16)
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
# together (~26.6 + ~20 GB at 8 layers)
FAMILY_ARCHS = ("xlstm_125m", "paligemma_3b", "jamba_v0_1_52b")
FAMILY_LAYERS = {"jamba_v0_1_52b": 8}
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
    """xlstm_125m and paligemma_3b at full width and jamba_v0_1_52b at
    published widths cut to 8 layers (one period), each from seeded
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


def train_step_launches(n_layers: int) -> dict:
    """Kernel 2' launches of one train step, read from the code: every
    product (7 a layer and the tied head) forward, and its dX and dW
    backward (``kernels/ops.py:TiledMatmul``)."""
    return dict.fromkeys(KERNELS, 0) | {
        "dense_tile_matmul": 3 * (n_layers * len(LEAVES) + 1)}


def _plain_by_columns(a, b):
    """``tiled_matmul_ref`` over column strips of ``b`` (a column's bits
    depend on that column alone), each strip's partials within
    PLAIN_BYTES."""
    import torch
    from repro_torch.kernels.ref import tiled_matmul_ref
    cols = max(128, PLAIN_BYTES // (a.shape[0] * 128 * 4) // 128 * 128)
    return torch.cat([tiled_matmul_ref(a, b[:, j:j + cols])
                      for j in range(0, b.shape[1], cols)], 1)


def _train_backward_checks() -> dict:
    """The autograd Function on the card at M = TRAIN_TOKENS, for each
    product of TRAIN_SHAPES: its forward, dX and dW bitwise equal to
    kernel 2' on the same (forward) or transposed operands (dX = dY @
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
    m, rows = TRAIN_TOKENS, {}
    for name, (k, n) in TRAIN_SHAPES.items():
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / math.sqrt(k)).bfloat16()
        if name.startswith("head"):      # the tied head: embed's strides
            w = w.T.contiguous().T
        dy = torch.randn((m, n), generator=gen, device="cuda")
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = ops.tiled_matmul(xa, wa)
        check(torch.equal(y.detach(), dm.dense_matmul_cuda(x, w)),
              f"train {name} forward: the Function's result differs from "
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
                      f"train {name} {part}: the Function's result differs "
                      f"from kernel 2' on the transposed operands")
            f32 = a.dtype == torch.float32 or b.dtype == torch.float32
            bf = b.float() if f32 else b
            af = a.float() if f32 else a
            row[part] = _matmul_row(
                f"train {name} {part}", a, b.numel() * b.element_size(),
                a.shape[1], b.shape[1], lambda: dm.dense_matmul_cuda(a, b),
                lambda: _plain_by_columns(a, b),
                lambda: torch.matmul(af, bf), flush_buf.zero_, f32,
                relative=f32, reps=(5, 1, 5))
            del af, bf
        del grads, dy
        rows[name] = row
        log(f"train {name} ({k} x {n}, M {m}): " + ", ".join(
            f"{part} {r['ms']:.3f} ms (matmul {r['library_ms']:.3f}, bound "
            f"{r['bound_ms']:.3f}, err {r['max_abs_err']:.2e} / scale "
            f"{r['scale']:.1f})" for part, r in row.items()))
    del flush_buf
    return rows


def _train_memory(out, tmp) -> dict:
    """The device memory of the last run's state and, over it, the peak
    of each part of a train step (forward and backward; AdamW's apply with
    the gradients held; the whole step, ``runtime/steps.py``) and of a
    blocking checkpoint save of ``{"params", "opt"}``, in GB.  Updates the
    state in place (AdamW's moments)."""
    import torch
    from repro_torch.checkpoint.ckpt import CheckpointManager
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
    mgr = CheckpointManager(tmp / "probe", device="cuda")
    _, res["save_over_gb"] = peak(lambda: mgr.save(
        TRAIN_STEPS, {"params": params, "opt": opt}, blocking=True))
    log("train memory (GB): " + ", ".join(f"{k} {v:.2f}"
                                          for k, v in res.items()))
    return res


def _flat_state(out) -> list:
    from repro_torch.runtime.streaming import tree_leaves
    return list(tree_leaves({"params": out["params"],
                             "opt": out["opt_state"]}))


def phase_train():
    """llama3_2_1b at full width trained through ``launch/train.py``'s own
    code path at its defaults (global batch 8, seq 128, lr 3e-4,
    ``warmup_cosine(20, steps)``; while the step is under the 20 warm-up
    steps the schedule does not depend on ``--steps``): 6 steps
    uninterrupted; 3 steps, checkpointed; the same run resumed from that
    checkpoint to 6.  Checks: the resumed run's params and AdamW state at
    step 6 bitwise equal to the uninterrupted run's; finite losses and
    gradient norms; kernel 2' launches a step equal to the code's count
    (forward and backward; ``train_step_launches``); the autograd
    Function's forward and backward against the plain version
    (:func:`_train_backward_checks`).  Logs seconds a step, the run's peak
    GB (the checkpoint saves included) and the step's and the save's own
    (:func:`_train_memory`)."""
    import shutil
    import tempfile
    import torch
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
        t0 = time.perf_counter()
        whole = train.main(base + ["--steps", str(TRAIN_STEPS), "--ckpt",
                                   str(tmp / "whole")])
        whole_s = _sync_s(t0)
        launches = build.counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        shutil.rmtree(tmp / "whole")
        hist = whole["history"]
        check([h["step"] for h in hist] == list(range(TRAIN_STEPS)),
              f"train: steps {[h['step'] for h in hist]}")
        check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                  for h in hist), f"train: non-finite loss or grad norm "
              f"{hist}")
        want = train_step_launches(N_LAYERS)["dense_tile_matmul"]
        check(launches["dense_tile_matmul"] == TRAIN_STEPS * want,
              f"train: 2' launched {launches['dense_tile_matmul']} times in "
              f"{TRAIN_STEPS} steps, the code says {want} a step")
        check(launches["decompress_matmul"] == 0
              and launches["enec_decode"] == 0,
              f"train: unexpected launches {launches}")
        t0 = time.perf_counter()
        train.main(base + ["--steps", str(TRAIN_RESUME), "--ckpt",
                           str(tmp / "resume")])
        first_s = _sync_s(t0)
        t0 = time.perf_counter()
        resumed = train.main(base + ["--steps", str(TRAIN_STEPS), "--ckpt",
                                     str(tmp / "resume")])
        resumed_s = _sync_s(t0)
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
        memory = _train_memory(whole, tmp)
        del whole
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    backward = _train_backward_checks()
    torch.cuda.empty_cache()
    dts = [h["dt_s"] for h in hist]
    res = {"card": card, "history": hist, "s_per_step": dts,
           "s_per_step_mean": sum(dts[1:]) / len(dts[1:]),
           "peak_gb": peak, "held_gb": held, "memory": memory,
           "whole_s": whole_s,
           "first_s": first_s, "resumed_s": resumed_s, "launches_per_step": want,
           "backward": backward}
    RESULTS["train"] = res
    log(f"train: {TRAIN_STEPS} steps, resumed run bitwise equal; "
        f"{res['s_per_step_mean']:.3f} s a step (steps 1-5; step 0 "
        f"{dts[0]:.3f} s), peak {peak:.2f} GB ({held:.2f} held before the "
        f"phase), 2' launches a step {want}; "
        f"runs {whole_s:.1f} / {first_s:.1f} / {resumed_s:.1f} s ({card})")
    return {"train": launches}


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
    phase_build()
    phase_decode()
    phase_encode()
    phase_matmul()
    launches, fused = phase_serve()
    phase_setup_encode(fused)
    launches.update(phase_ckpt(fused))
    launches.update(phase_degraded(fused))
    del fused
    launches.update(phase_engine())
    launches.update(phase_overlap())
    launches.update(phase_scan())
    launches.update(phase_kv_attention())
    launches.update(phase_serve_minitron())
    launches.update(phase_moe())
    launches.update(phase_families())
    launches.update(phase_api())
    launches.update(phase_whisper())
    launches.update(phase_train())
    line = kernels_line(launches)
    RESULTS["kernels"] = line["kernels"]
    RESULTS["seconds"] = time.perf_counter() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1))
    log(f"done in {RESULTS['seconds']:.1f}s")
    print(card_line())
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
