"""Roofline analysis over the port's dry-run records (counterpart of
``repro/launch/roofline.py``, whose arithmetic this is, with the chip a
parameter).

Per (arch x shape) cell on the single-pod 16x16 mesh, the three terms
(seconds, per device):

    compute    = FLOPs / chip.peak_flops
    memory     = bytes / chip.hbm_bw
    collective = wire_bytes / chip.link_bw

Sources: the dry-run's ``cost.flops`` and ``cost["bytes accessed"]`` (what
rank 0 of the mesh runs, counted op by op on ``meta`` tensors plus the
kernels' analytic cost record; ``launch/dryrun.py``) and the collective
wire bytes of its abstract mesh (``launch/collective_stats.py``).

Corrections, as the reference's:
 1. scan-counted-once: ``cost = p0 + P * (p1 - p0)`` when the record has
    0- and 1-period entries.  The port runs every layer eagerly and writes
    none, so its records are taken as they are.
 2. recurrent time scans (Mamba / mLSTM / sLSTM) are counted as a loop
    body by the dry-run (two steps on ``meta``: ``models/layers.py:
    scan_steps``); the reference's analytic FLOPs of the T steps are added
    here:
      mamba:  6*B*d_inner*d_state        per layer-step
      mlstm:  6*B*H*hd^2                 per layer-step
      slstm:  8*B*D^2 (recurrent matmul) + 16*B*D   per layer-step

MODEL_FLOPS: 6*N*tokens (train, dense), 6*N_active*tokens (train, MoE),
2*N(_active)*tokens (prefill/decode), spread over the chips.

Roofline fraction:
    T_ideal  = max(model_compute_s, model_min_bytes_s)
    fraction = T_ideal / max(compute_s, memory_s, collective_s)

The default chip, :data:`H100`, is the card of the port's measurements:
NVIDIA H100 80GB HBM3 at a 700.00 W power limit, with NVIDIA's published
peaks for the SXM part (dense bf16 989.4 TFLOP/s, HBM3 3.35 TB/s, NVLink 4
900 GB/s both directions, so 450 GB/s a direction), 256 cards on a 16x16
mesh.  A card set below 700 W runs slower under load.

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --dryrun-dir results/dryrun_torch --out results/roofline_torch.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.models.registry import active_param_count, param_count


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One accelerator of the mesh and the mesh's layout."""
    peak_flops: float      # dense bf16 FLOP/s a device
    hbm_bw: float          # device memory bytes/s
    link_bw: float         # bytes/s a device sends over its links
    chips: int             # devices of the pod
    mesh_data: int
    mesh_model: int


# NVIDIA H100 80GB HBM3 (SXM) at a 700.00 W power limit: NVIDIA's data
# sheet, dense rates without sparsity
H100 = ChipSpec(peak_flops=989.4e12, hbm_bw=3.35e12, link_bw=450e9,
                chips=256, mesh_data=16, mesh_model=16)
H100_NAME = "NVIDIA H100 80GB HBM3, 700.00 W"


def _corrected(entry: dict, key_path, n_periods: int) -> float:
    """cost = p0 + P*(p1 - p0); falls back to full when unrolled."""
    def get(rec):
        v = rec
        for k in key_path:
            v = v.get(k, 0.0) if isinstance(v, dict) else 0.0
        return float(v or 0.0)

    full = get(entry["full"])
    if "p1" not in entry or "p0" not in entry:
        return full
    p1, p0 = get(entry["p1"]), get(entry["p0"])
    body = max(p1 - p0, 0.0)
    return p0 + n_periods * body


def _recurrent_correction_flops(cfg, shape, chip: ChipSpec = H100) -> float:
    """Analytic time-scan FLOPs (per device) of the T - 1 recurrent steps
    the dry-run does not count."""
    if shape.kind == "decode":
        return 0.0  # single step: counted exactly
    b_dev = max(shape.global_batch // chip.mesh_data, 1)
    t = shape.seq_len
    total = 0.0
    if cfg.family == "hybrid":
        d_inner = 2 * cfg.d_model
        n_mamba = cfg.n_layers * 7 // 8
        total += 6.0 * b_dev * d_inner * cfg.ssm_state * t * n_mamba
    if cfg.family == "ssm":
        hd = cfg.d_model // cfg.n_heads
        n_m = cfg.n_layers * 3 // 4
        n_s = cfg.n_layers - n_m
        total += 6.0 * b_dev * cfg.n_heads * hd * hd * t * n_m
        total += (8.0 * b_dev * cfg.d_model * cfg.d_model
                  + 16.0 * b_dev * cfg.d_model) * t * n_s
    if shape.kind == "train":
        total *= 3.0  # fwd + bwd(2x) through the recurrence
    return total


def model_flops_per_device(cfg, shape, chip: ChipSpec = H100) -> float:
    n_act = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens / chip.chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens / chip.chips
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n_act * tokens / chip.chips


def model_min_bytes_per_device(cfg, shape, *, weight_ratio: float = 1.0,
                               chip: ChipSpec = H100) -> float:
    """Bytes that must cross device memory per step per device (ideal
    lower bound); ``weight_ratio`` > 1 models ENEC-compressed weight
    residency (decode reads weights / ratio bytes)."""
    n = param_count(cfg)
    wbytes = 2.0 * n / chip.chips / weight_ratio
    if shape.kind == "train":
        tokens_dev = shape.global_batch * shape.seq_len / chip.mesh_data
        act = 4.0 * tokens_dev * cfg.d_model * cfg.n_layers / chip.mesh_model
        return 12.0 * n / chip.chips + act       # p+g+opt r/w (bf16+f32)
    if shape.kind == "prefill":
        tokens_dev = shape.global_batch * shape.seq_len / chip.mesh_data
        kv = (2.0 * tokens_dev * cfg.n_kv_heads * cfg.head_dim_() * 2
              * cfg.n_layers / chip.mesh_model)
        return wbytes + kv
    # decode: weights once + full KV/state read once
    if cfg.family in ("ssm",):
        kv_bytes = 0.0
    else:
        attn_layers = (cfg.n_layers // 8 if cfg.family == "hybrid"
                       else cfg.n_layers)
        kv_elems = (shape.global_batch * shape.seq_len * cfg.n_kv_heads
                    * cfg.head_dim_() * 2 * attn_layers)
        kv_bytes = 2.0 * kv_elems / chip.chips
    return wbytes + kv_bytes


SUGGESTIONS = {
    ("compute_s", "train"): "reduce remat recompute / larger microbatch",
    ("compute_s", "prefill"): "fuse attention chunks; drop f32 upcasts",
    ("compute_s", "decode"): "decode is tiny-FLOP; check for replicated "
                             "compute",
    ("memory_s", "train"): "tighter remat policy; fuse optimizer update",
    ("memory_s", "prefill"): "avoid score materialization; bf16 "
                             "intermediates",
    ("memory_s", "decode"): "ENEC-compressed weight residency (+fused "
                            "decode-GEMM)",
    ("collective_s", "train"): "overlap FSDP all-gathers; reduce-scatter "
                               "grads",
    ("collective_s", "prefill"): "resharding copies (SPMD warnings) — align "
                                 "KV layouts",
    ("collective_s", "decode"): "shard KV seq axis; combine EP all-reduce "
                                "into a2a",
}


def analyze_cell(rec: dict, *, weight_ratio: float = 1.0,
                 chip: ChipSpec = H100) -> dict:
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    entry = rec.get("single", {})
    if rec.get("status") == "skipped":
        return {"arch": rec["arch"], "shape": rec["shape"],
                "status": "skipped", "reason": rec.get("reason", "")}
    if entry.get("status") != "ok":
        return {"arch": rec["arch"], "shape": rec["shape"],
                "status": "failed",
                "error": entry.get("error", "missing")}

    n_p = rec.get("n_periods", 1)
    flops = _corrected(entry, ("cost", "flops"), n_p)
    bytes_ = _corrected(entry, ("cost", "bytes accessed"), n_p)
    wire = _corrected(entry, ("collectives", "total_wire_bytes"), n_p)
    rec_fl = _recurrent_correction_flops(cfg, shape, chip)
    flops_corr = flops + rec_fl

    compute_s = flops_corr / chip.peak_flops
    memory_s = bytes_ / chip.hbm_bw
    coll_s = wire / chip.link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)

    mf = model_flops_per_device(cfg, shape, chip)
    ideal = max(mf / chip.peak_flops,
                model_min_bytes_per_device(cfg, shape,
                                           weight_ratio=weight_ratio,
                                           chip=chip) / chip.hbm_bw)
    frac = ideal / max(terms.values()) if max(terms.values()) else 0.0
    return {
        "arch": rec["arch"], "shape": rec["shape"], "status": "ok",
        "layers_mode": rec.get("layers_mode"),
        "flops_hlo": flops, "flops_recurrent_corr": rec_fl,
        "flops": flops_corr, "bytes": bytes_, "wire_bytes": wire,
        **{k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": mf / flops_corr if flops_corr else 0.0,
        "roofline_fraction": round(frac, 4),
        "suggestion": SUGGESTIONS[(dominant, shape.kind)],
        "multi_pod_ok": rec.get("multi", {}).get("status") == "ok",
        "peak_hbm_gb": round(entry["full"]["memory"]
                             .get("peak_memory_in_bytes", 0) / 2**30, 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun-dir", default="results/dryrun_torch")
    ap.add_argument("--out", default="results/roofline_torch.json")
    ap.add_argument("--weight-ratio", type=float, default=1.0,
                    help="ENEC weight-residency ratio for the ideal bound")
    args = ap.parse_args(argv)

    rows = []
    for path in sorted(Path(args.dryrun_dir).glob("*.json")):
        rec = json.loads(path.read_text())
        # variant records (...__streamed.json etc.) are compared apart; the
        # baseline table stays variant-free
        if rec.get("variant", "baseline") != "baseline" \
                or "__mesh" in path.stem or len(path.stem.split("__")) > 2:
            continue
        rows.append(analyze_cell(rec, weight_ratio=args.weight_ratio))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    md = ["| arch | shape | mode | compute_s | memory_s | collective_s | "
          "dominant | MODEL/HLO | roofline_frac | peakHBM(GB) | multi-pod |",
          "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] == "skipped":
            md.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — | "
                      f"— | — | — | {r['reason']} |")
            continue
        if r["status"] == "failed":
            md.append(f"| {r['arch']} | {r['shape']} | FAILED | — | — | — |"
                      f" — | — | — | — | {r['error'][:60]} |")
            continue
        md.append(
            f"| {r['arch']} | {r['shape']} | {r['layers_mode']} "
            f"| {r['compute_s']:.2e} | {r['memory_s']:.2e} "
            f"| {r['collective_s']:.2e} | **{r['dominant'][:-2]}** "
            f"| {r['useful_ratio']:.3f} | {r['roofline_fraction']:.3f} "
            f"| {r['peak_hbm_gb']} | {'Y' if r['multi_pod_ok'] else 'N'} |")
    md = "\n".join(md)
    out.with_suffix(".md").write_text(md)
    print(f"[roofline] chip: {H100_NAME}")
    print(md)
    return rows


if __name__ == "__main__":
    main()
