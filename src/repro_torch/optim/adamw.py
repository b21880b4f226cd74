"""AdamW with f32 moments over bf16 params, global-norm gradient clipping
and a warmup-cosine schedule (port of ``repro/optim/adamw.py``).

:func:`apply` takes the parameter, state and gradient trees and returns
new parameters and a new state, as the reference does, but updates the
moments in place: the state it was given is spent (holding old and new
moments at once would cost another 8 bytes a parameter).  Every number is
an f32 tensor as in the reference: the bias corrections come from the
f32 step, each update runs in f32 (the reference's operations in its
order) and casts to the parameter's dtype at the end.
The state is a NamedTuple, so a checkpoint names its records
``opt/step``, ``opt/m/...``, ``opt/v/...`` as the reference's does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.api import tree_leaves, tree_map_with_path


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Optional[Callable] = None  # step -> lr multiplier


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    m: dict
    v: dict


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def init(params) -> AdamWState:
    """Zero moments in f32, step 0, on the parameters' device."""
    def zeros(_, p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = next(leaf for _, leaf in tree_leaves(params))
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map_with_path(zeros, params),
        v=tree_map_with_path(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's f32 sum
    of squares."""
    total = None
    for _, g in tree_leaves(tree):
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def apply(cfg: AdamWConfig, params, state: AdamWState, grads):
    """One AdamW step. Returns (new_params, new_state, metrics); the
    moments of ``state`` are updated in place and carried into
    ``new_state``."""
    gnorm = global_norm(grads)
    scale = (torch.minimum(_f32(1.0, gnorm), cfg.grad_clip
                           / torch.clamp(gnorm, min=1e-9))
             if cfg.grad_clip else _f32(1.0, gnorm))
    step = state.step + 1
    stepf = step.float()
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule else _f32(1.0, gnorm))
    c1 = 1.0 - torch.pow(_f32(cfg.b1, stepf), stepf)
    c2 = 1.0 - torch.pow(_f32(cfg.b2, stepf), stepf)
    grad = dict(tree_leaves(grads))
    ms, vs = dict(tree_leaves(state.m)), dict(tree_leaves(state.v))

    def upd(path, p):
        g = grad[path].float() * scale
        # b1 * m + (1 - b1) * g, rounded as the reference's out-of-place form
        m = ms[path].mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v = vs[path].mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype)

    new_p = tree_map_with_path(upd, params)
    return new_p, AdamWState(step, state.m, state.v), \
        {"grad_norm": gnorm, "lr": lr}


def warmup_cosine(warmup: int, total: int, floor: float = 0.1):
    """step -> lr multiplier: linear warmup to 1, then a cosine down to
    ``floor`` at ``total``."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step / max(warmup, 1)
        progress = torch.clamp((step - warmup) / max(total - warmup, 1),
                               0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * progress))
        return torch.where(step < warmup, warm, cos)
    return sched
