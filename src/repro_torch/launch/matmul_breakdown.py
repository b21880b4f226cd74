"""Where a launch of the matmul kernel (``csrc/decompress_matmul.cu``)
spends its time, on one GPU:

    PYTHONPATH=src python -m repro_torch.launch.matmul_breakdown

1. Ablations: copies of the kernel with one part taken out (the weight-tile
   loads, the x-row loads, the tile product, the ordered reduction, all of
   them, or everything but the launch), each built with nvcc into
   ``build/matmul_breakdown/`` and timed at M = 4 on llama3_2_1b's leaf
   shapes beside the full kernel and ``torch.matmul``.  The ablated copies
   compute wrong results; they exist to be timed.
2. A timeline: a copy that records ``clock64`` at the steps of each CTA's
   walk (tile arrived, product done, step done; walk done, arrivals
   counted, strips summed) and ``%globaltimer`` at its start and end;
   printed as the median and the maximum over CTAs.

Times are device times: CUDA events with the L2 flushed and a spin kernel
ahead of each run (``chip_smoke.py``'s ``cuda_ms(..., spin=True)``), so
they compare with each other, not with windows that hold the host's launch
cost.  The ablations and the timeline are text substitutions of exact
lines of the kernel source; ``tests/test_torch_matmul_schedule.py``
checks that each still applies.  Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.api import slice_stacked
from repro_torch.core.codec_api import Codec
from repro_torch.kernels import build

# the module (``repro_torch.kernels.decompress_matmul`` is also the name of
# the routed function in the package's namespace)
DM = importlib.import_module("repro_torch.kernels.decompress_matmul")
OUT = build.BUILD_DIR.parent / "matmul_breakdown"
SHAPES = {"wq": (2048, 2048), "wk": (2048, 512), "w_gate": (2048, 8192),
          "w_down": (8192, 2048)}
SPIN_CYCLES = 250_000
M, REPS = 4, 20          # llama3_2_1b's decode batch; timed runs a mean

_LOADS = ("        stage_w_tile(st, a, kt * kTile, (t / a.k_tiles) * kTile);",
          "")
_X = ("      stage_x(st, kt, 0);", "")
_PRODUCT = ("    tile_partial(W, st + L.x_off, a.x_bf16, a.mc, mma, p);",
            "    for (int v = 0; v < kVals; ++v) p[v] = 0.f;")
_REDUCE = ("      const bool last = atomicAdd(&a.counters[strip], 1) == "
           "a.k_tiles - 1;", "      const bool last = false;")
_EMPTY = ("  constexpr int S = kStages;\n",
          "  constexpr int S = kStages;\n"
          "  if (a.M > 0) return;\n")
ABLATIONS = {"full": [], "no_weight_loads": [_LOADS], "no_x_loads": [_X],
             "no_product": [_PRODUCT], "no_reduction": [_REDUCE],
             "skeleton": [_LOADS, _X, _PRODUCT, _REDUCE],
             "launch_only": [_EMPTY]}

# the timeline: thread 0 of each CTA stores clock64 at these points
_TL_HEAD = """__device__ unsigned long long g_tl[4096][24];
__device__ __forceinline__ unsigned long long tl_gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TL(i) do { if (threadIdx.x == 0 && blockIdx.x < 4096) \\
    g_tl[blockIdx.x][i] = clock64(); } while (0)
"""
_TIMELINE = [
    ("namespace {\n", "namespace {\n" + _TL_HEAD),
    ("  constexpr int S = kStages;\n",
     "  constexpr int S = kStages;\n"
     "  if (threadIdx.x == 0 && blockIdx.x < 4096)\n"
     "    g_tl[blockIdx.x][22] = tl_gtimer();\n  TL(0);\n"),
    ("    if (kFused) mbar_wait(&bars[j % S], (j / S) & 1);\n"
     "    __syncthreads();\n",
     "    if (kFused) mbar_wait(&bars[j % S], (j / S) & 1);\n"
     "    __syncthreads();\n    if (j < 5) TL(1 + 3 * j);\n"),
    ("    tile_partial(W, st + L.x_off, a.x_bf16, a.mc, mma, p);\n",
     "    tile_partial(W, st + L.x_off, a.x_bf16, a.mc, mma, p);\n"
     "    if (j < 5) TL(2 + 3 * j);\n"),
    ("    __syncthreads();   // the tile and the stage buffer are reused\n"
     "  }\n",
     "    __syncthreads();   // the tile and the stage buffer are reused\n"
     "    if (j < 5) TL(3 + 3 * j);\n  }\n  TL(16);\n"
     "  if (threadIdx.x == 0 && blockIdx.x < 4096)\n"
     "    g_tl[blockIdx.x][21] = count;\n"),
    ("      done[q] = last ? strip : -1;\n    }\n    __syncthreads();\n",
     "      done[q] = last ? strip : -1;\n    }\n    __syncthreads();\n"
     "    TL(17);\n"),
    ("      if (threadIdx.x == 0) a.counters[strip] = 0;\n    }\n",
     "      if (threadIdx.x == 0) a.counters[strip] = 0;\n    }\n"
     "    TL(18);\n    if (threadIdx.x == 0 && blockIdx.x < 4096)\n"
     "      g_tl[blockIdx.x][23] = tl_gtimer();\n"),
]
_TL_READ = ('\nextern "C" void matmul_timeline(unsigned long long* out) {\n'
            '  cudaMemcpyFromSymbol(out, g_tl, sizeof(g_tl));\n}\n')


def _variant(name: str, subs, source: str = "decompress_matmul") -> str:
    """``csrc/<source>.cu`` with each (old, new) substitution made once;
    raises if a line it names is gone."""
    src = (build.CSRC / f"{source}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{name}: the kernel source no longer has "
                               f"{old!r}")
        src = src.replace(old, new, 1)
    return src


def build_sources(texts: dict, source: str, out: Path) -> dict:
    """nvcc each edited copy (name -> text of ``csrc/<source>.cu``) in
    parallel into ``out/<name>/``; returns name -> ctypes.CDLL."""
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in texts.items():
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir()
        for h in build.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        (d / f"{source}.cu").write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / f"{source}.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / name / "lib.so"))
    return libs


def build_variants(names) -> dict:
    """nvcc every variant in parallel; returns name -> ctypes.CDLL."""
    return build_sources(
        {name: (_variant(name, _TIMELINE) + _TL_READ if name == "timeline"
                else _variant(name, ABLATIONS[name])) for name in names},
        "decompress_matmul", OUT)


def device_ms(fn, reps: int, flush) -> float:
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


class _Use:
    """Route ``build.load(source)`` to one build of that kernel; ``reset``
    clears the wrapper's cached bindings on the way in and out."""

    def __init__(self, lib, source="decompress_matmul",
                 reset=lambda: DM._FNS.clear()):
        self.lib, self.source, self.reset = lib, source, reset
        self.orig = build.load

    def __enter__(self):
        build.load = lambda n: self.lib if n == self.source else self.orig(n)
        self.reset()

    def __exit__(self, *exc):
        build.load = self.orig
        self.reset()


def _cases(m: int):
    gen = torch.Generator(device="cuda").manual_seed(0)
    codec = Codec()
    out = {}
    for name, (k, n) in SHAPES.items():
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / math.sqrt(k)).to(torch.bfloat16)
        [ct] = codec.tile_weights_for_fusion_many([w])
        x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        out[name] = (k, n, w, slice_stacked(ct, 0), x)
    return out


def _timeline(lib, fn) -> dict:
    buf = np.zeros((4096, 24), dtype=np.uint64)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    flush.zero_()
    torch.cuda._sleep(SPIN_CYCLES)
    fn()
    torch.cuda.synchronize()
    lib.matmul_timeline.argtypes = [ctypes.c_void_p]
    lib.matmul_timeline(buf.ctypes.data)
    d = buf[:DM.last_plan()["grid"]].astype(np.int64)
    # SM cycles per microsecond, from each CTA's clock64 and globaltimer
    # spans between its first and last marks
    per_us = float(np.median((d[:, 18] - d[:, 0])
                             / ((d[:, 23] - d[:, 22]) / 1e3)))
    cnt = d[:, 21]
    ends = (d[:, 23] - d[:, 22].min()) / 1e3
    res = {"sm_mhz": per_us, "tiles_per_cta": np.bincount(cnt).tolist(),
           "end_us": [float(np.median(ends)), float(ends.max())]}
    for j in range(5):
        ok = cnt > j
        if ok.any():
            for label, i in (("arrived", 1 + 3 * j), ("product", 2 + 3 * j),
                             ("step", 3 + 3 * j)):
                v = (d[ok, i] - d[ok, 0]) / per_us
                res[f"tile{j}_{label}"] = [float(np.median(v)),
                                           float(v.max())]
    for label, i in (("walk_done", 16), ("arrivals_counted", 17),
                     ("strips_summed", 18)):
        v = (d[:, i] - d[:, 0]) / per_us
        res[label] = [float(np.median(v)), float(v.max())]
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the breakdown needs CUDA")
    build.build_all()
    libs = build_variants(list(ABLATIONS) + ["timeline"])
    cases = _cases(M)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda").zero_
    res = {"m": M, "ablations": {}, "timeline": {}}
    for leaf, (k, n, w, ct, x) in cases.items():
        res["ablations"].setdefault("torch.matmul", {})[leaf] = device_ms(
            lambda: torch.matmul(x, w), REPS, flush)
    for name in ABLATIONS:
        with _Use(libs[name]):
            row = {}
            for leaf, (k, n, w, ct, x) in cases.items():
                row[f"dense {leaf}"] = device_ms(
                    lambda: DM.dense_matmul_cuda(x, w), REPS, flush)
                row[f"fused {leaf}"] = device_ms(
                    lambda: DM.decompress_matmul_cuda(x, ct, k, n),
                    REPS, flush)
            res["ablations"][name] = row
        print(f"[breakdown] {name}: " + ", ".join(
            f"{key} {v * 1e3:.1f} us" for key, v in row.items()), flush=True)
    print("[breakdown] torch.matmul: " + ", ".join(
        f"{leaf} {v * 1e3:.1f} us"
        for leaf, v in res["ablations"]["torch.matmul"].items()), flush=True)
    with _Use(libs["timeline"]):
        for leaf in ("w_gate", "wq"):
            k, n, w, ct, x = cases[leaf]
            for entry, fn in (
                    ("dense", lambda: DM.dense_matmul_cuda(x, w)),
                    ("fused", lambda: DM.decompress_matmul_cuda(x, ct, k,
                                                                n))):
                tl = _timeline(libs["timeline"], fn)
                res["timeline"][f"{entry} {leaf}"] = tl
                print(f"[breakdown] timeline {entry} {leaf} (median / max "
                      f"over CTAs, us since the CTA's start; SM clock "
                      f"{tl['sm_mhz']:.0f} MHz): "
                      + ", ".join(f"{key} {v[0]:.2f} / {v[1]:.2f}"
                                  for key, v in tl.items()
                                  if isinstance(v, list) and len(v) == 2
                                  and key != "tiles_per_cta")
                      + f"; tiles per CTA {tl['tiles_per_cta']}",
                      flush=True)
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
