"""Training launcher of the PyTorch port (counterpart of
``repro/launch/train.py``): seeded synthetic weights, AdamW with a
warmup-cosine schedule, the fault-tolerant loop of
``runtime/train_loop.py`` (ENEC checkpoints of ``{"params", "opt"}``,
straggler watchdog, resume from the latest checkpoint).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 4 --global-batch 2 --seq 16
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --smoke --device cpu --mesh 2x2 \\
        --steps 4 --global-batch 4 --seq 16

Every weight product, forward and backward, runs the canonical tiled
matmul: the dense-tile entry of ``csrc/decompress_matmul.cu`` on the card.
In a world of several ranks (``torch.distributed.run``) it trains on a
mesh: ``--mesh DxM``, or the largest grid the arch supports
(``elastic.best_mesh_for``); each rank holds its shards of the parameters
and AdamW state (``sharding.param_pspecs(mode="train")``) and a
checkpoint written by any layout resumes on any other.  In a world of one
rank it trains on one device.  ``--mesh`` stays ``DxM``, as the
reference's launcher's does; a caller with a pod mesh (``launch/mesh.py:
make_mesh(shape, ("pod", "data", "model"))``) passes it to
:func:`main` as ``mesh=``, and the run goes as on any other mesh.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_mesh, world_size
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import elastic
from repro_torch.runtime.steps import build_train_step
from repro_torch.runtime.train_loop import TrainLoopConfig, run


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3_2_1b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--mesh", default=None,
                    help="DxM (data x model), e.g. 2x2: its product must be "
                         "the world size (default: the largest grid the arch "
                         "supports, elastic.best_mesh_for)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def mesh_shape(arg, world: int):
    """``--mesh``'s grid, checked against the world size (None: none
    given)."""
    if arg is None:
        return None
    shape = tuple(int(v) for v in arg.split("x"))
    if not 1 <= len(shape) <= 2 or min(shape) < 1:
        raise ValueError(f"--mesh takes DxM (data x model), got {arg!r}")
    if math.prod(shape) != world:
        raise ValueError(f"--mesh {arg} needs {math.prod(shape)} ranks; the "
                         f"world has {world}")
    return shape


def main(argv=None, *, mesh=None) -> dict:
    """Parse ``argv`` and train; ``mesh``: a mesh the caller made over the
    whole world (a pod mesh, say), used in place of ``--mesh``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    world = world_size()
    if mesh is not None and (args.mesh is not None or mesh.size != world):
        raise ValueError(f"mesh= {dict(mesh.shape)} takes the place of "
                         f"--mesh and must span the world of {world}")
    shape = mesh_shape(args.mesh, world)
    model = build_model(cfg)
    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, schedule=adamw.warmup_cosine(20, args.steps))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.global_batch)
    loop_cfg = TrainLoopConfig(total_steps=args.steps, ckpt_every=50,
                               log_every=10)
    if world == 1:
        print(f"[launch.train] {cfg.name} on {dev}")
        params = model.init(seed=0, device=dev)
        opt_state = adamw.init(params)
        mesh = None
    else:
        if dev.type == "cuda":
            # before the process group: a build must not eat its timeout
            from repro_torch.kernels import build
            build.build_all()
        if mesh is None:
            mesh = (make_mesh(shape, ("data", "model")[:len(shape)], dev)
                    if shape else elastic.best_mesh_for(cfg, device=dev))
        print(f"[launch.train] {cfg.name} on mesh {dict(mesh.shape)}")
        dev = mesh.device
        # ``run`` makes the state from seed 0: the params whole once, then
        # this rank's shards; the moments only as shards.  Held here, they
        # would stay alive beside a restored state and the updated params
        params = opt_state = None
    out = run(model, opt_cfg, data_cfg, loop_cfg,
              ckpt=CheckpointManager(args.ckpt, device=dev),
              train_step=build_train_step(model, opt_cfg, mesh),
              params=params, opt_state=opt_state, device=dev, mesh=mesh,
              on_metrics=lambda r: print(f"  step {r['step']} "
                                         f"loss {r['loss']:.4f}"))
    last = out["history"][-1] if out["history"] else None
    print(f"[launch.train] done: {last}")
    return out


if __name__ == "__main__":
    main()
