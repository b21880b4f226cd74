"""Build a supported architecture behind one functional interface (port
of ``repro/models/registry.py``: every decoder-only family), and its
abstract trees on ``meta`` tensors, the counterpart of the reference's
``jax.eval_shape`` helpers: shapes and dtypes with nothing allocated."""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple

from repro_torch.configs.base import ArchConfig

from . import lm


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable            # (seed=, device=) -> params
    prefill_fn: Callable      # (params, batch, max_len) -> (logits, cache)
    decode_fn: Callable       # (params, cache, tokens) -> (logits, cache)
    init_cache: Callable      # (batch, max_len, device=) -> cache
    init_step_state: Callable  # (slots, max_len, device=) -> step buffers
    decode_step: Callable     # (params, state, bucket) -> None, in place


def build_model(cfg: ArchConfig) -> Model:
    lm.block_program(cfg)     # raises for families not ported yet
    return Model(
        cfg=cfg,
        init=partial(lm.init_params, cfg),
        prefill_fn=lambda params, batch, max_len: lm.prefill_fn(
            params, cfg, batch, max_len),
        decode_fn=lambda params, cache, tokens: lm.decode_fn(
            params, cfg, cache, tokens),
        init_cache=partial(lm.init_cache, cfg),
        init_step_state=partial(lm.init_step_state, cfg),
        decode_step=lambda params, state, bucket: lm.decode_step(
            params, cfg, state, bucket),
    )


# the reference's eval_shape helpers, on meta tensors
abstract_params = lm.abstract_params


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The decode cache of ``batch`` rows as ``meta`` tensors."""
    return lm.init_cache(cfg, batch, max_len, device="meta")


def param_count(cfg: ArchConfig) -> int:
    return sum(math.prod(s) for s in lm.param_shapes(cfg).values())


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters a token reads: only its top-k experts of each MoE stack
    (the reference's ``registry.active_param_count``)."""
    total = param_count(cfg)
    if cfg.n_experts:
        expert = sum(math.prod(s) for path, s in lm.param_shapes(cfg).items()
                     if any(k.startswith("e_") for k in path.split("/")))
        frac = cfg.experts_per_token / cfg.n_experts
        total = total - expert + int(expert * frac)
    return total
