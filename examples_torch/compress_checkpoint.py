"""Offline checkpoint (re)compression tool.

    PYTHONPATH=src python examples_torch/compress_checkpoint.py [--device cpu]

The PyTorch port's counterpart of ``examples/compress_checkpoint.py``:
builds a model state, saves it through the ENEC ``CheckpointManager``
(compressed on the device: the encode kernel on ``cuda``), prints
per-tensor and aggregate compression accounting, restores, and verifies
the restore is bit-identical.  The checkpoint's records are byte for byte
the JAX package's for the same state.
"""
import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core.api import tree_leaves
from repro_torch.data.synthetic_weights import PAPER_MODELS, generate
from repro_torch.models import build_model
from repro_torch.optim import adamw

STEP = 1234


def make_state(params, device):
    """The saved state around ``params``: one big leaf with trained-like
    statistics (random-init smoke weights are narrower-spectrum, so the
    ratios match the paper's) and AdamW's state over its first 2^20
    elements."""
    w = generate(dataclasses.replace(PAPER_MODELS[3], n_elems=1 << 21),
                 device=device)
    return {"params": params, "realistic_block": w.reshape(1024, 2048),
            "opt": adamw.init({"w": w[: 1 << 20]})}


def save_and_verify(state, root, device) -> dict:
    """Save ``state`` under ``root``, print the accounting, restore and
    check every leaf bit for bit; returns the manifest."""
    mgr = CheckpointManager(Path(root), keep_last=2, device=device)
    mgr.save(STEP, state, blocking=True)
    manifest = json.loads(
        (Path(root) / f"step_{STEP:012d}" / "manifest.json").read_text())
    print(f"[ckpt] step {manifest['step']}: "
          f"{manifest['raw_bytes']:,} B -> "
          f"{manifest['compressed_bytes']:,} B "
          f"(ratio {manifest['ratio']:.3f}x, "
          f"{manifest['save_s']*1e3:.0f} ms)")
    biggest = sorted(manifest["leaves"], key=lambda e: -e["bytes"])[:5]
    for e in biggest:
        print(f"   {e['name']:<40s} {e['mode']:<6s} {e['bytes']:>10,} B"
              + (f"  params={tuple(e['params'])}" if "params" in e
                 else ""))
    restored, _ = mgr.load(state)
    for (pa, a), (pb, b) in zip(tree_leaves(state), tree_leaves(restored)):
        if pa != pb or a.dtype != b.dtype or a.shape != b.shape \
                or not torch.equal(a.reshape(-1).view(torch.uint8),
                                   b.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"{pa}: the restore differs")
    print("[ckpt] restore verified bit-identical")
    return manifest


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config("llama3_2_1b")
    params = build_model(cfg).init(seed=0, device=dev)
    state = make_state(params, dev)
    with tempfile.TemporaryDirectory() as d:
        return save_and_verify(state, d, dev)


if __name__ == "__main__":
    main()
