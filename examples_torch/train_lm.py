"""End-to-end training run: train a ~100M-param llama-family config with
the full production stack (AdamW, deterministic pipeline, ENEC-compressed
checkpoints, straggler watchdog, resume).  The PyTorch port's counterpart
of ``examples/train_lm.py``: every weight product runs on the port's
dense-tile matmul kernel on ``cuda``, and every checkpoint compresses
through its encode kernel.

--preset small trains a ~10M model; --preset 100m is the full
deliverable-(b) configuration — same code, bigger dims.  Run it again
with the same --ckpt-dir and more --steps to resume.

    PYTHONPATH=src python examples_torch/train_lm.py --steps 200 \\
        [--device cpu]
"""
import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import build_model
from repro_torch.models.registry import param_count
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import TrainLoopConfig, run

PRESETS = {
    # ~10M params: CPU-friendly smoke of the same architecture family
    "small": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
                  head_dim=32, d_ff=1024, vocab_size=8192, seq=128, batch=8),
    # ~100M params: deliverable-(b) scale (run on accelerators)
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 head_dim=64, d_ff=3072, vocab_size=32768, seq=1024,
                 batch=64),
}
LOG_EVERY = 10
# not the JAX example's directory: the two examples never resume from
# each other's checkpoints
DEFAULT_CKPT_DIR = str(Path(tempfile.gettempdir()) / "repro_torch_train_ckpt")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ps = PRESETS[args.preset]
    cfg = dataclasses.replace(
        get_config("llama3_2_1b"), n_layers=ps["n_layers"],
        d_model=ps["d_model"], n_heads=ps["n_heads"],
        n_kv_heads=ps["n_kv_heads"], head_dim=ps["head_dim"],
        d_ff=ps["d_ff"], vocab_size=ps["vocab_size"], tie_embeddings=True,
        scan_layers=True, remat=False)
    model = build_model(cfg)
    print(f"[train_lm] {args.preset}: {param_count(cfg)/1e6:.1f}M params, "
          f"{args.steps} steps, batch {ps['batch']} x seq {ps['seq']}")

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=ps["seq"],
                          global_batch=ps["batch"], seed=0)
    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, schedule=adamw.warmup_cosine(20, args.steps))
    ckpt = CheckpointManager(Path(args.ckpt_dir), keep_last=2, device=dev)
    out = run(model, opt_cfg, data_cfg,
              TrainLoopConfig(total_steps=args.steps, ckpt_every=50,
                              log_every=LOG_EVERY),
              ckpt=ckpt, device=dev,
              on_metrics=lambda row: print(f"  step {row['step']:>5d} "
                                           f"loss {row['loss']:.4f} "
                                           f"({row['dt_s']*1e3:.0f} ms)"))
    # the port's history keeps every step; the reference's only the logged
    # ones, which its line reads.  A resumed run that logged none (the
    # reference's raises IndexError there) reads every step it ran.
    logged = [r for r in out["history"] if r["step"] % LOG_EVERY == 0] \
        or out["history"]
    if logged:
        first, last = logged[0], logged[-1]
        print(f"[train_lm] loss {first['loss']:.4f} -> {last['loss']:.4f} "
              f"in {out['wall_s']:.1f}s; checkpoints (ENEC-compressed) in "
              f"{args.ckpt_dir}")
    return out


if __name__ == "__main__":
    main()
