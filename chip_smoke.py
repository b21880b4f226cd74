#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and hold
its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits nonzero:

1. build   compile ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a into
           ``build/kernels/``; print the build time and the card's name
           and power limit (nvidia-smi).
2. decode  the ENEC decode kernel against the plain decoder, bitwise:
           bf16 / fp16 / fp32, N in {2048, 16384}, the (m, n, L) grid,
           all / no anomalous groups, m == n, per-block (b, l) across the
           wrap boundary; then the decode of the full-width 128256x2048
           embed, timed beside the plain version and its bound.
3. matmul  the fused decode+matmul kernel at every full-width leaf shape
           and M in {1, 4, batch*prompt}: bitwise equal to its dense-tile
           entry on the decoded weight, within a stated tolerance of the
           plain version and of torch.matmul; timed at M = batch.
4. serve   llama3_2_1b at full width from seeded synthetic weights,
           compressed on the card, through ``launch.serve.main`` in fused,
           stream and dense modes (batch 4, prompt 64, 16 new tokens):
           equal greedy tokens, bitwise-equal logits, the kernel launch
           counts per decode step; plus a smoke-size model on the card
           against the plain CPU path.  The launch counts are set to 0
           just before each mode's run and read just after it.
5. a ``{"kernels": [...]}`` JSON line, then the card line and the last
   line ``{"ok": true, "device": {...}}``.  Each kernel's ``launches`` is
   its count in the run of its ``path`` (fused, the main path, for the
   decoder and the fused entry; dense for the dense-tile entry);
   ``launches_by_path`` gives its count in each mode's own run.

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
BATCH, PROMPT, TOKENS = 4, 64, 16
LEAVES = {"wq": (2048, 2048), "wk": (2048, 512), "wv": (2048, 512),
          "wo": (2048, 2048), "w_gate": (2048, 8192), "w_up": (2048, 8192),
          "w_down": (8192, 2048)}
# f32 sums of the same exact products in another order: measured <= 3e-6
# at K <= 8192 with O(1) outputs.  A kernel that rounded f32 inputs to TF32
# or kept bf16 partial sums errs by >= 1e-4; phase 3 computes both controls
# and fails unless each exceeds this limit.
MATMUL_ATOL = 2e-5

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


def cuda_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events), after
    one warm-up; ``flush`` runs before each timed run, outside the
    window (evicts the 50 MB L2 so weights are read from memory)."""
    import torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
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


def _decode_both(streams, n_elems, fmt, p, b_vec=None, l_vec=None):
    import torch
    from repro_torch.kernels import enec_decode, ops
    got = ops.decode_blocks(streams, n_elems, fmt, p, b_vec, l_vec)
    torch.cuda.synchronize()
    want = enec_decode.decode_blocks_plain(streams, n_elems, fmt, p,
                                           b_vec, l_vec)
    return got, want


def phase_decode():
    import torch
    from repro_torch.core import codec, params, stats
    from repro_torch.core.codec_api import Codec
    from repro_torch.core.dtypes import BF16, FORMATS, to_bits
    from repro_torch.core.params import EnecParams
    from repro_torch.kernels import enec_decode, ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = 0

    def run(bits, fmt, p, label, b_vec=None, l_vec=None):
        nonlocal cases
        n_elems = bits.shape[1]
        if b_vec is None:
            streams = codec.encode_blocks(bits, fmt, p)
        else:
            streams = codec.encode_blocks(bits, fmt, p, b_vec=b_vec)
        got, want = _decode_both(streams, n_elems, fmt, p, b_vec, l_vec)
        check(torch.equal(got, want), f"decode kernel != plain ({label})")
        check(torch.equal(got.to(fmt.work_dtype) & fmt.bits_mask, bits),
              f"decode is not lossless ({label})")
        cases += 1

    for key, fmt in FORMATS.items():
        for n_elems in (2048, 16384):
            w = _weights((4, n_elems), fmt, gen)
            bits = to_bits(w)
            st = stats.stack_stats(bits.reshape(1, -1), fmt)
            p = params.widen_for_range(
                params.search(st.hist, fmt, block_elems=n_elems),
                *st.bounds())
            run(bits, fmt, p, f"{key} N={n_elems} {p.astuple()}")
    for m, n, L in ((1, 4, 16), (3, 6, 16), (5, 6, 32), (2, 7, 64),
                    (6, 6, 16)):
        for n_elems in (2048, 16384):
            exps = torch.randint(127 - (1 << n) + 1, 128, (2, n_elems),
                                 generator=gen, device="cuda")
            low = torch.randint(0, 1 << 16, (2, n_elems), generator=gen,
                                device="cuda") & 0x807F
            bits = ((exps << 7) | low).to(torch.int32)
            p = EnecParams(b=127, n=n, m=m, L=L, l=127 - (1 << n) + 1)
            run(bits, BF16, p, f"grid m={m} n={n} L={L} N={n_elems}")
    # all groups anomalous in block 0, none in block 1; and m == n
    n_elems = 16384
    exps = torch.cat([torch.full((1, n_elems), 120, device="cuda"),
                      torch.full((1, n_elems), 127, device="cuda")])
    bits = ((exps << 7) | (torch.randint(0, 1 << 16, (2, n_elems),
                                         generator=gen, device="cuda")
                           & 0x807F)).to(torch.int32)
    run(bits, BF16, EnecParams(b=127, n=4, m=2, L=16, l=120), "all/none")
    run(bits, BF16, EnecParams(b=127, n=4, m=4, L=16, l=120), "m == n")
    # two tensors' blocks in one launch, exponents at each window's edge
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
    run(torch.stack(rows).to(torch.int32), BF16, ps[0], "per-block (b, l)",
        b_vec, l_vec)
    log(f"decode: {cases} cases bitwise equal to the plain decoder")

    # the main path's decode: the full-width tied embed, flat L=1 stack
    embed = (torch.nn.init.trunc_normal_(
        torch.empty((128256, 2048), device="cuda"), 0.0, 1.0, -2.0, 2.0,
        generator=gen) * 0.02).to(torch.bfloat16)
    [ct] = Codec().compress_stacked_many([embed[None]], shards=2)
    flat = codec.flatten_blocks(ct.streams)
    nblocks = flat.mask.shape[0]
    b_vec = torch.full((nblocks,), ct.params.b, dtype=torch.int32,
                       device="cuda")
    l_vec = torch.full((nblocks,), ct.params.l, dtype=torch.int32,
                       device="cuda")
    got, want = _decode_both(flat, ct.block_elems, ct.fmt, ct.params,
                             b_vec, l_vec)
    check(torch.equal(got, want), "embed decode kernel != plain")
    embed_err = float((got.view(torch.bfloat16).float()
                       - want.view(torch.bfloat16).float()).abs().max())
    check(torch.equal(got.reshape(-1)[:embed.numel()],
                      embed.reshape(-1).view(torch.int16)),
          "embed decode is not lossless")
    del got, want
    ms = cuda_ms(lambda: enec_decode.decode_blocks_cuda(
        flat, ct.block_elems, ct.fmt, ct.params, b_vec, l_vec), reps=10)
    plain_ms = cuda_ms(lambda: enec_decode.decode_blocks_plain(
        flat, ct.block_elems, ct.fmt, ct.params, b_vec, l_vec), reps=2)
    in_bytes = needed_bytes(flat) + 8 * nblocks        # + per-block b, l
    out_bytes = nblocks * ct.block_elems * 2
    bound = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"decode embed 128256x2048 bf16 ({nblocks} blocks, params "
        f"{ct.params.astuple()}, ratio {ct.ratio():.4f}): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
        f"(bytes {in_bytes + out_bytes}), {bound / ms:.3f} of bound")
    RESULTS["decode"] = {"cases": cases, "embed_ms": ms,
                         "embed_plain_ms": plain_ms, "embed_bound_ms": bound,
                         "embed_bytes": in_bytes + out_bytes,
                         "embed_max_abs_err": embed_err,
                         "embed_params": list(ct.params.astuple()),
                         "embed_ratio": ct.ratio()}
    del embed, ct, flat
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


def phase_matmul():
    import torch
    from repro_torch.core.api import slice_stacked
    from repro_torch.core.codec_api import Codec
    from repro_torch.kernels import decompress_matmul as dm
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    codec_obj = Codec()
    rows, max_err, max_err_dense, max_err_lib = [], 0.0, 0.0, 0.0
    controls = {}
    totals = {k: 0.0 for k in ("fused", "fused_plain", "dense", "dense_plain",
                               "library", "fused_bound", "dense_bound")}
    for name, (k, n) in LEAVES.items():
        w = (torch.nn.init.trunc_normal_(
            torch.empty((k, n), device="cuda"), 0.0, 1.0, -2.0, 2.0,
            generator=gen) / math.sqrt(k)).to(torch.bfloat16)
        [ct] = codec_obj.tile_weights_for_fusion_many([w], shards=2)
        check(ct is not None, f"{name}: tiles did not compress")
        ct = slice_stacked(ct, 0)
        w_dec = codec_obj.untile_matmul_weight(ct, k, n)
        check(torch.equal(w_dec, w), f"{name}: tile decode not lossless")
        comp_bytes = needed_bytes(ct.streams)
        for m in (1, BATCH, BATCH * PROMPT):
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            fused = dm.decompress_matmul_cuda(x, ct, k, n)
            dense = dm.dense_matmul_cuda(x, w_dec)
            torch.cuda.synchronize()
            check(torch.equal(fused.view(torch.int32),
                              dense.view(torch.int32)),
                  f"{name} M={m}: fused != dense-tile entry bitwise")
            plain = dm.decompress_matmul_plain(x, ct, k, n, codec_obj)
            lib = torch.matmul(x.float(), w.float())
            err = float((fused - plain).abs().max())
            err_dense = float((dense - dm.dense_matmul_plain(x, w_dec))
                              .abs().max())
            err_lib = float((fused - lib).abs().max())
            check(max(err, err_dense, err_lib) <= MATMUL_ATOL,
                  f"{name} M={m}: |fused - plain| {err}, |dense-tile - "
                  f"plain| {err_dense}, |fused - torch.matmul| {err_lib} > "
                  f"{MATMUL_ATOL}")
            max_err = max(max_err, err)
            max_err_dense = max(max_err_dense, err_dense)
            max_err_lib = max(max_err_lib, err_lib)
            row = {"leaf": name, "k": k, "n": n, "m": m,
                   "max_abs_err_plain": err, "max_abs_err_matmul": err_lib}
            if m == BATCH and "bf16_sums" not in controls:
                controls["bf16_sums"] = float(
                    (_bf16_sums(x, w) - plain).abs().max())
            if m == BATCH:
                row["ms"] = cuda_ms(
                    lambda: dm.decompress_matmul_cuda(x, ct, k, n), 20, flush)
                row["dense_ms"] = cuda_ms(
                    lambda: dm.dense_matmul_cuda(x, w), 20, flush)
                row["plain_ms"] = cuda_ms(
                    lambda: dm.decompress_matmul_plain(x, ct, k, n,
                                                       codec_obj), 3, flush)
                row["dense_plain_ms"] = cuda_ms(
                    lambda: dm.dense_matmul_plain(x, w), 3, flush)
                row["library_ms"] = cuda_ms(lambda: torch.matmul(x, w), 20,
                                            flush)
                xo = m * k * 2 + m * n * 4
                flops_ms = 2 * m * k * n / F32_FLOPS * 1e3
                row["bound_ms"] = max((comp_bytes + xo) / HBM_BYTES_PER_S
                                      * 1e3, flops_ms)
                row["dense_bound_ms"] = max((k * n * 2 + xo)
                                            / HBM_BYTES_PER_S * 1e3, flops_ms)
                for key, src in (("fused", "ms"), ("fused_plain", "plain_ms"),
                                 ("dense", "dense_ms"),
                                 ("dense_plain", "dense_plain_ms"),
                                 ("library", "library_ms"),
                                 ("fused_bound", "bound_ms"),
                                 ("dense_bound", "dense_bound_ms")):
                    totals[key] += row[src]
                log(f"matmul {name} {k}x{n} M={m}: fused {row['ms']:.4f} ms "
                    f"(bound {row['bound_ms']:.4f}), dense-tile "
                    f"{row['dense_ms']:.4f} ms (bound "
                    f"{row['dense_bound_ms']:.4f}), plain "
                    f"{row['plain_ms']:.4f} ms, torch.matmul bf16 "
                    f"{row['library_ms']:.4f} ms; err {err:.3g}")
            rows.append(row)
    # the kernel's other branches: fp16 / fp32 weights, f32 activations,
    # ragged K and N (zero-padded tiles), m == n (no high stream)
    from repro_torch.core.params import EnecParams
    for w_dt, (k, n), x_dt, fixed in (
            (torch.float16, (256, 384), torch.bfloat16, False),
            (torch.float32, (256, 384), torch.float32, False),
            (torch.bfloat16, (250, 120), torch.float32, False),
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
        x = torch.randn((5, k), generator=gen, device="cuda").to(x_dt)
        fused = dm.decompress_matmul_cuda(x, ct, k, n)
        dense = dm.dense_matmul_cuda(x, w)
        torch.cuda.synchronize()
        label = f"{w_dt} {k}x{n} x {x_dt}{' m==n' if fixed else ''}"
        check(torch.equal(fused.view(torch.int32), dense.view(torch.int32)),
              f"{label}: fused != dense-tile entry bitwise")
        plain = dm.decompress_matmul_plain(x, ct, k, n, codec_obj)
        err = float((fused - plain).abs().max())
        check(err <= MATMUL_ATOL, f"{label}: |fused - plain| {err}")
        max_err = max(max_err, err)
        rows.append({"case": label, "max_abs_err_plain": err})
        if w_dt == torch.float32:
            controls["tf32_inputs"] = float(
                (dm.dense_matmul_plain(_tf32(x), _tf32(w)) - plain)
                .abs().max())
    for name, c in controls.items():
        check(c > MATMUL_ATOL, f"control {name} errs by {c} <= "
              f"{MATMUL_ATOL}: the tolerance would not catch it")
    log(f"matmul: {len(rows)} shape/M cases, fused == dense-tile bitwise, max "
        f"|fused - plain| {max_err:.3g}, |dense-tile - plain| "
        f"{max_err_dense:.3g}, |fused - torch.matmul| {max_err_lib:.3g} <= "
        f"{MATMUL_ATOL}; controls (must exceed it) {controls}; one layer's "
        f"7 leaves at M={BATCH}: fused {totals['fused']:.4f} ms, bound "
        f"{totals['fused_bound']:.4f} ms")
    RESULTS["matmul"] = {"rows": rows, "totals_m_batch": totals,
                         "max_abs_err": max_err,
                         "max_abs_err_dense": max_err_dense,
                         "max_abs_err_matmul": max_err_lib,
                         "atol": MATMUL_ATOL, "controls": controls}
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
    n_layers, per_layer = 16, len(LEAVES)
    for mode, out in runs.items():
        step = out["step_launches"][0]
        check(all(s == step for s in out["step_launches"]),
              f"{mode}: launches vary between decode steps")
        want = {"fused": {"enec_decode": 1,
                          "decompress_matmul": n_layers * per_layer,
                          "dense_tile_matmul": 0},
                "stream": {"enec_decode": 1 + n_layers * per_layer,
                           "decompress_matmul": 0,
                           "dense_tile_matmul": n_layers * per_layer},
                "dense": {"enec_decode": 0, "decompress_matmul": 0,
                          "dense_tile_matmul": n_layers * per_layer}}[mode]
        check(step == want, f"{mode}: per-step launches {step} != {want}")
        for name, n in want.items():
            check(n == 0 or out["path_launches"][name] > 0,
                  f"{mode}: kernel {name} was never launched in its run")
        log(f"serve {mode}: set-up {out['setup_s']:.3f} s, TTFT "
            f"{out['ttft_s'] * 1e3:.2f} ms, TPOT {out['tpot_s'] * 1e3:.2f} "
            f"ms, {out['tok_s']:.2f} tok/s, wire ratio "
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
                                        "setup_s", "wire_ratio",
                                        "path_launches", "prefill_launches",
                                        "mode_mix")}
                  | {"step_launches": o["step_launches"][0],
                     "hbm_ratio": o["stream_stats"]["hbm_ratio"]}
                  for m, o in runs.items()}}
    return launches


# ---------------------------------------------------------------------------

# the served path whose own run gives each kernel's ``launches``: the
# default fused mode (the main path) runs the decoder and the fused entry;
# the dense-tile entry runs in the dense and stream modes only
KERNEL_PATH = {"enec_decode": "fused", "decompress_matmul": "fused",
               "dense_tile_matmul": "dense"}


def kernels_line(launches):
    """``launches`` maps each served mode to the counts read right after
    that mode's run, with every count set to 0 just before it."""
    d, mm = RESULTS["decode"], RESULTS["matmul"]
    t = mm["totals_m_batch"]
    src = "src/repro_torch/csrc/"
    rows = [
        {"name": "enec_decode", "route": "cuda",
         "source": src + "enec_decode.cu",
         "replaces": "src/repro/kernels/enec_decode.py:135",
         "max_abs_err": d["embed_max_abs_err"],
         "ms": d["embed_ms"], "plain_ms": d["embed_plain_ms"],
         "bound_ms": d["embed_bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "decompress_matmul", "route": "cuda",
         "source": src + "decompress_matmul.cu",
         "replaces": "src/repro/kernels/decompress_matmul.py:66",
         "max_abs_err": mm["max_abs_err"], "ms": t["fused"],
         "plain_ms": t["fused_plain"], "bound_ms": t["fused_bound"],
         "bound_by": "bytes", "library_ms": t["library"]},
        {"name": "dense_tile_matmul", "route": "cuda",
         "source": src + "decompress_matmul.cu",
         "replaces": "src/repro/kernels/ref.py:31",
         "max_abs_err": mm["max_abs_err_dense"],
         "ms": t["dense"], "plain_ms": t["dense_plain"],
         "bound_ms": t["dense_bound"], "bound_by": "bytes",
         "library_ms": t["library"]},
    ]
    for row in rows:
        path = KERNEL_PATH[row["name"]]
        row["launches"] = launches[path][row["name"]]
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
    t0 = time.perf_counter()
    phase_build()
    phase_decode()
    phase_matmul()
    launches = phase_serve()
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
