"""Build a supported architecture behind one functional interface (port
of ``repro/models/registry.py``, dense and MoE families)."""
from __future__ import annotations

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
