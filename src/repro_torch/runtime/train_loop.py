"""Fault-tolerant single-device training loop (port of
``repro/runtime/train_loop.py``): checkpoint and resume, a straggler
watchdog, asynchronous ENEC checkpoints and a data stream that resumes
at the recorded step.

Each batch is a pure function of (seed, step) (``data/pipeline.py``) and
every step's bits are deterministic (``runtime/steps.py``), so a run
resumed from a checkpoint gives the same parameters and optimizer state
as one that ran through.  Checkpoints hold ``{"params", "opt"}`` under the
reference's record names, so either package resumes the other's.  As in
the reference, a save inside the loop at ``step`` holds the state after
that step ran and is labelled ``step``; the final save is labelled
``total_steps``.

On a training mesh (``run(..., mesh=)``) each rank runs this loop over
its shards of the state (``runtime/elastic.py``): a resume restores any
checkpoint (written by one device, another mesh or the reference) onto
the mesh, every save is collective, and the straggler watchdog decides
from the world's largest step time, so that every rank strikes, and
saves, at the same step.  A pod mesh (``("pod", "data", "model")``) runs
the same way: its ranks' shards are replicated across "pod", pod 0 alone
gathers a save, and the watchdog's maximum spans all three axes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.data import pipeline as data_pipeline
from repro_torch.optim import adamw


@dataclasses.dataclass
class WatchdogConfig:
    """EMA step-time straggler detection: a step far above the EMA
    strikes; after ``max_strikes`` the ``on_straggler`` hook runs and the
    state is checkpointed."""
    factor: float = 2.5
    ema: float = 0.9
    max_strikes: int = 3
    warmup_steps: int = 3


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_every: int = 200
    log_every: int = 10
    watchdog: WatchdogConfig = dataclasses.field(default_factory=WatchdogConfig)


def _to_device(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


# the mesh step's own metrics, kept in every history row that has them
MESH_METRICS = ("gather_s", "compute_s", "reduce_s", "gather_bytes",
                "reduce_bytes")


def run(model, opt_cfg: adamw.AdamWConfig, data_cfg, loop_cfg: TrainLoopConfig,
        *, ckpt: Optional[CheckpointManager] = None, train_step=None,
        params=None, opt_state=None, on_metrics: Optional[Callable] = None,
        on_straggler: Optional[Callable] = None, device="cuda",
        mesh=None) -> dict:
    """Run (or resume) training on ``device``, or on ``mesh`` (a
    ``launch/mesh.py`` mesh; ``params`` and ``opt_state`` then are this
    rank's shards).  A state not given is made here from the seed, or,
    where ``ckpt`` has a step to resume, restored without one being made.
    Returns the final state and stats."""
    from repro_torch.models.registry import abstract_params
    from repro_torch.runtime import elastic
    from repro_torch.runtime.steps import build_train_step

    dev = resolve_device(device) if mesh is None else mesh.device
    specs = None if mesh is None else elastic.train_pspecs(
        abstract_params(model.cfg), mesh)
    place = {} if mesh is None else {"mesh": mesh, "pspecs": specs}
    if train_step is None:
        train_step = build_train_step(model, opt_cfg, mesh)
    resume = ckpt is not None and ckpt.latest_step() is not None
    if params is None and resume:
        # shapes only: the checkpoint's state takes their place, and a
        # state made from the seed would stay alive beside it
        params = abstract_params(model.cfg)
        if mesh is not None:
            params = elastic.abstract_shards(params, mesh, specs["params"])
    elif params is None:
        params = model.init(seed=data_cfg.seed, device=dev)
        if mesh is not None:
            params = elastic.reshard(params, mesh, specs["params"])
    if opt_state is None:
        opt_state = adamw.init(params)

    start_step = 0
    if resume:
        state, manifest = ckpt.load({"params": params, "opt": opt_state},
                                    **place)
        params, opt_state = state["params"], state["opt"]
        start_step = int(manifest["step"])
        print(f"[train] resumed from step {start_step} "
              f"(ckpt ratio {manifest['ratio']:.3f}x)")

    it = data_pipeline.Prefetcher(data_cfg, start_step)
    ema_dt, strikes = None, 0
    history = []
    t_loop = time.time()
    try:
        for step in range(start_step, loop_cfg.total_steps):
            batch = _to_device(next(it), dev)
            t0 = time.time()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])     # waits for the step
            dt = time.time() - t0
            if mesh is not None:
                # one decision for the world: a save is collective
                dt = mesh.world_max(dt)

            wd = loop_cfg.watchdog
            if step - start_step >= wd.warmup_steps:
                if ema_dt is not None and dt > wd.factor * ema_dt:
                    strikes += 1
                    print(f"[watchdog] step {step} took {dt:.3f}s "
                          f"(EMA {ema_dt:.3f}s) — strike {strikes}")
                    if strikes >= wd.max_strikes:
                        if on_straggler is not None:
                            on_straggler(step)
                        if ckpt is not None:
                            ckpt.save(step, {"params": params,
                                             "opt": opt_state}, **place)
                        strikes = 0
                else:
                    strikes = max(0, strikes - 1)
                ema_dt = dt if ema_dt is None else \
                    wd.ema * ema_dt + (1 - wd.ema) * dt
            else:
                ema_dt = dt

            # every step's row is kept; ``on_metrics`` sees every
            # ``log_every``-th (the reference keeps only those)
            row = {"step": step, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "dt_s": round(dt, 4)}
            row.update((k, metrics[k]) for k in MESH_METRICS if k in metrics)
            history.append(row)
            if step % loop_cfg.log_every == 0 and on_metrics is not None:
                on_metrics(row)
            if ckpt is not None and step and step % loop_cfg.ckpt_every == 0:
                ckpt.save(step, {"params": params, "opt": opt_state},
                          **place)
    finally:
        it.close()
        if ckpt is not None:
            ckpt.wait()
    if ckpt is not None:
        ckpt.save(loop_cfg.total_steps, {"params": params, "opt": opt_state},
                  blocking=True, **place)
    return {"params": params, "opt_state": opt_state, "history": history,
            "wall_s": time.time() - t_loop, **place}
