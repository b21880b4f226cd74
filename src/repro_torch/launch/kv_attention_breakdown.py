"""Where a launch of the compressed-KV attention kernel
(``csrc/decode_attention_kv.cu``) spends its time, on one GPU:

    PYTHONPATH=src python -m repro_torch.launch.kv_attention_breakdown

1. Ablations: copies of the kernel with one part taken out (the block
   decode, the tensor-core products, the ordered combine of split pairs,
   or everything but the launch), built with nvcc into
   ``build/kv_attention_breakdown/`` and timed at the two full-width
   shapes of ``chip_smoke.py`` (B 8, S 32768, KV 8, grp 3 and 8) beside
   the full kernel and SDPA on the dense bf16 K/V.  The ablated copies
   compute wrong results; they exist to be timed.
2. A timeline: a copy in which thread 0 of each CTA adds up the
   ``clock64`` cycles of each step of its walk over all its items (wait
   for the item's copies, the block barrier, issue the next item's
   copies, rank and decode, scores, softmax, p @ V, segment end)
   and records ``%globaltimer`` at its start and end; printed as the
   median and the maximum over CTAs.

Times are device times (``matmul_breakdown.device_ms``: the L2 flushed and
a spin kernel ahead of each run).  The edits are text substitutions of
exact lines of the kernel source; ``tests/test_torch_matmul_schedule.py``
checks that each still applies.  Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import params, stats
from repro_torch.core.dtypes import BF16
from repro_torch.kernels import build
from repro_torch.launch.matmul_breakdown import (_Use, _variant,
                                                 build_sources, device_ms)

DAK = importlib.import_module("repro_torch.kernels.decode_attention_kv")
OPS = importlib.import_module("repro_torch.kernels.ops")
SOURCE = "decode_attention_kv"
OUT = build.BUILD_DIR.parent / "kv_attention_breakdown"
SHAPES = {"grp 3": (8, 32768, 8, 3), "grp 8": (8, 32768, 8, 8)}
REPS = 5

_DECODE = ("    enec::decode_staged_lanes_bf16<kBlock>(\n",
           "    if (a.pairs < 0) enec::decode_staged_lanes_bf16<kBlock>(\n")
_SCORES = ("    for (int ks = 0; ks < kHd / 16; ++ks) {",
           "    for (int ks = 0; ks < 0; ++ks) {")
_PV = ("        for (int part = 0; part < 3; ++part) {\n"
       "          mma_bf16_k8(",
       "        for (int part = 0; part < 0; ++part) {\n"
       "          mma_bf16_k8(")
_COMBINE = ("          const bool last =\n"
            "              atomicAdd(&a.counters[pair], 1) == c_hi - c_lo;",
            "          const bool last = false;")
_EMPTY = ("  extern __shared__ __align__(128) uint8_t smem[];\n",
          "  extern __shared__ __align__(128) uint8_t smem[];\n"
          "  if (a.pairs > 0) return;\n")
ABLATIONS = {"full": [], "no_decode": [_DECODE],
             "no_products": [_SCORES, _PV], "no_combine": [_COMBINE],
             "launch_only": [_EMPTY]}

# the timeline: thread 0 of each CTA adds the cycles of each step
STEPS = ("wait", "barrier", "issue", "decode", "scores", "softmax", "pv",
         "segment_end")
_TL_HEAD = """__device__ long long g_tl[4096][12];
__device__ __forceinline__ long long tl_gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TL(i) do { if (threadIdx.x == 0) { const long long now_ = clock64(); \\
    tl_acc[i] += now_ - tl_last; tl_last = now_; } } while (0)
"""
_TIMELINE = [
    ("namespace {\n", "namespace {\n" + _TL_HEAD),
    ("  if (stager) prefetch(0);\n  for (int j = 0; j < count; ++j) {\n",
     "  long long tl_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  const long long tl_t0 = tl_gtimer(), tl_c0 = clock64();\n"
     "  long long tl_last = tl_c0;\n"
     "  if (stager) prefetch(0);\n  for (int j = 0; j < count; ++j) {\n"),
    ("    mbar_wait(&bars[j % kStages], (j / kStages) & 1);\n"
     "    __syncthreads();\n",
     "    mbar_wait(&bars[j % kStages], (j / kStages) & 1);\n    TL(0);\n"
     "    __syncthreads();\n    TL(1);\n"),
    ("    if (stager) prefetch(j + 1);",
     "    if (stager) prefetch(j + 1);\n    TL(2);"),
    ("                                    (i0 & 127)) = make_uint2(lo, hi);\n"
     "        });\n    __syncwarp();\n",
     "                                    (i0 & 127)) = make_uint2(lo, hi);\n"
     "        });\n    __syncwarp();\n    TL(3);\n"),
    ("               *reinterpret_cast<const uint32_t*>(kr + 8));\n    }\n",
     "               *reinterpret_cast<const uint32_t*>(kr + 8));\n    }\n"
     "    TL(4);\n"),
    ("    // acc = acc * corr + V^T p^T",
     "    TL(5);\n    // acc = acc * corr + V^T p^T"),
    ("    if (j == count - 1 || chunk == C - 1) {   // the pair's segment ends\n",
     "    TL(6);\n"
     "    if (j == count - 1 || chunk == C - 1) {   // the pair's segment ends\n"),
    ("  }\n}\n\n// Per device",
     "    TL(7);\n  }\n"
     "  if (threadIdx.x == 0 && blockIdx.x < 4096) {\n"
     "    for (int i = 0; i < 8; ++i) g_tl[blockIdx.x][i] = tl_acc[i];\n"
     "    g_tl[blockIdx.x][8] = count;\n"
     "    g_tl[blockIdx.x][9] = tl_t0;\n"
     "    g_tl[blockIdx.x][10] = tl_gtimer();\n"
     "    g_tl[blockIdx.x][11] = clock64() - tl_c0;\n"
     "  }\n}\n\n// Per device"),
]
_TL_READ = ('\nextern "C" void kv_timeline(long long* out) {\n'
            '  cudaMemcpyFromSymbol(out, g_tl, sizeof(g_tl));\n}\n')


def variant_source(name: str) -> str:
    if name == "timeline":
        return _variant(name, _TIMELINE, SOURCE) + _TL_READ
    return _variant(name, ABLATIONS[name], SOURCE)


def _use(lib) -> _Use:
    """Route the wrapper to one build of the kernel; its cached bindings,
    resources and per-pair counters start anew (an ablated combine leaves
    the counters)."""
    def reset():
        DAK._FNS.clear()
        DAK._RESOURCES.clear()
        DAK._COUNTERS.clear()
    return _Use(lib, SOURCE, reset)


def _case(shape, gen):
    """Seeded bf16 q, K, V (normal x 0.3) and params searched over K and V
    together, compressed by the port's encoder (as chip_smoke.py does)."""
    b, s, kv, grp = shape

    def t(dims):
        return (torch.randn(dims, generator=gen, device="cuda") * 0.3).to(
            torch.bfloat16)

    k, v, q = t((b, s, kv, 128)), t((b, s, kv, 128)), t((b, kv, grp, 128))
    both = torch.cat([k.reshape(-1), v.reshape(-1)]).view(torch.int16)
    st = stats.stack_stats(both.reshape(1, -1), BF16)
    del both
    lo, hi = st.bounds()
    p = params.widen_for_range(
        params.search(st.hist, BF16, block_elems=128 * 128), lo, hi)
    ks, vs = OPS.compress_kv_prefix(k, p), OPS.compress_kv_prefix(v, p)
    q4 = q.reshape(b, kv * grp, 1, 128)
    k4 = k.permute(0, 2, 1, 3).contiguous()
    v4 = v.permute(0, 2, 1, 3).contiguous()
    del k, v
    return q, ks, vs, p, (q4, k4, v4)


def _timeline(lib, fn, grid: int) -> dict:
    buf = np.zeros((4096, 12), dtype=np.int64)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    flush.zero_()
    torch.cuda._sleep(250_000)
    fn()
    torch.cuda.synchronize()
    lib.kv_timeline.argtypes = [ctypes.c_void_p]
    lib.kv_timeline(buf.ctypes.data)
    d = buf[:grid]
    span_us = (d[:, 10] - d[:, 9]) / 1e3
    per_us = float(np.median(d[:, 11] / span_us))   # SM cycles a us
    ends = (d[:, 10] - d[:, 9].min()) / 1e3
    res = {"sm_mhz": per_us, "items_per_cta": [int(d[:, 8].min()),
                                                int(d[:, 8].max())],
           "start_us": [float(np.median((d[:, 9] - d[:, 9].min()) / 1e3)),
                        float((d[:, 9].max() - d[:, 9].min()) / 1e3)],
           "end_us": [float(np.median(ends)), float(ends.max())]}
    for i, step in enumerate(STEPS):
        v = d[:, i] / per_us
        res[step] = [float(np.median(v)), float(v.max())]
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the breakdown needs CUDA")
    import torch.nn.functional as F
    build.build_all()
    libs = build_sources({name: variant_source(name)
                          for name in list(ABLATIONS) + ["timeline"]},
                         SOURCE, OUT)
    gen = torch.Generator(device="cuda").manual_seed(5)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda").zero_
    res = {"ablations": {}, "timeline": {}, "plans": {}}
    for label, shape in SHAPES.items():
        q, ks, vs, p, (q4, k4, v4) = _case(shape, gen)
        res["ablations"].setdefault("sdpa", {})[label] = device_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   enable_gqa=True),
            REPS, flush)
        del q4, k4, v4
        for name in ABLATIONS:
            with _use(libs[name]):
                res["ablations"].setdefault(name, {})[label] = device_ms(
                    lambda: DAK.decode_attention_kv_enec_cuda(q, ks, vs, p),
                    REPS, flush)
                res["plans"][label] = DAK.launch_plan(q, ks, p)[1]
        with _use(libs["timeline"]):
            tl = _timeline(libs["timeline"], lambda: (
                DAK.decode_attention_kv_enec_cuda(q, ks, vs, p)),
                res["plans"][label]["grid"])
        res["timeline"][label] = tl
        print(f"[kv breakdown] {label}: " + ", ".join(
            f"{name} {res['ablations'][name][label]:.4f} ms"
            for name in ["sdpa", *ABLATIONS])
            + f"; plan {res['plans'][label]}", flush=True)
        print(f"[kv breakdown] timeline {label} (median / max over CTAs, us; "
              f"SM clock {tl['sm_mhz']:.0f} MHz): " + ", ".join(
                  f"{key} {v[0]:.1f} / {v[1]:.1f}" for key, v in tl.items()
                  if isinstance(v, list) and key != "items_per_cta")
              + f"; items per CTA {tl['items_per_cta']}", flush=True)
        del q, ks, vs
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    res["card"] = card
    print(card)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
