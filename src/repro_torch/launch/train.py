"""Single-device training launcher of the PyTorch port (counterpart of
``repro/launch/train.py``): seeded synthetic weights, AdamW with a
warmup-cosine schedule, the fault-tolerant loop of
``runtime/train_loop.py`` (ENEC checkpoints of ``{"params", "opt"}``,
straggler watchdog, resume from the latest checkpoint).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 4 --global-batch 2 --seq 16
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b

Every weight product, forward and backward, runs the canonical tiled
matmul: the dense-tile entry of ``csrc/decompress_matmul.cu`` on the card.
The reference's ``--mesh`` (and its elastic mesh sizing and sharding
rules) is not here: the port trains on one device.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.runtime.steps import build_train_step
from repro_torch.runtime.train_loop import TrainLoopConfig, run


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Single device only: the reference's --mesh, elastic mesh "
               "sizing and sharded training (ROADMAP item 12) are not "
               "ported yet.")
    ap.add_argument("--arch", default="llama3_2_1b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    print(f"[launch.train] {cfg.name} on {dev}")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    opt_state = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, schedule=adamw.warmup_cosine(20, args.steps))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.global_batch)
    out = run(model, opt_cfg, data_cfg,
              TrainLoopConfig(total_steps=args.steps,
                              ckpt_every=50, log_every=10),
              ckpt=CheckpointManager(args.ckpt, device=dev),
              train_step=build_train_step(model, opt_cfg), params=params,
              opt_state=opt_state, device=dev,
              on_metrics=lambda r: print(f"  step {r['step']} "
                                         f"loss {r['loss']:.4f}"))
    last = out["history"][-1] if out["history"] else None
    print(f"[launch.train] done: {last}")
    return out


if __name__ == "__main__":
    main()
