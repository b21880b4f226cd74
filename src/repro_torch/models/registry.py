"""Build a supported architecture behind one functional interface (port
of ``repro/models/registry.py``: the decoder-only families and whisper's
encoder-decoder), and its abstract trees on ``meta`` tensors, the
counterpart of the reference's ``jax.eval_shape`` helpers: shapes and
dtypes with nothing allocated.

Whisper is served as the reference serves it: ``prefill_fn(params,
{"frames", "tokens"}, max_len)`` then ``decode_fn`` (or ``decode_step``
on the buffers of ``init_step_state``); the serving engine, which
prefills tokens only, does not take it."""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec

from . import encdec, lm


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable            # (seed=, device=) -> params
    loss_fn: Callable         # (params, batch) -> (loss, metrics)
    prefill_fn: Callable      # (params, batch, max_len, mesh=) -> (logits,
    #                           cache), this rank's positions on a mesh
    decode_fn: Callable       # (params, cache, tokens) -> (logits, cache)
    init_cache: Callable      # (batch, max_len, device=, mesh=) -> cache
    init_step_state: Callable  # (slots, max_len, device=, mesh=) -> buffers
    decode_step: Callable     # (params, state, bucket) -> None, in place


def build_model(cfg: ArchConfig) -> Model:
    if cfg.is_encdec:
        return Model(
            cfg=cfg,
            init=partial(encdec.init_params, cfg),
            loss_fn=lambda params, batch: encdec.loss_fn(params, cfg, batch),
            prefill_fn=lambda params, batch, max_len, **kw: encdec.prefill(
                params, cfg, batch["frames"], batch["tokens"], max_len,
                **kw),
            decode_fn=lambda params, cache, tokens: encdec.decode_fn(
                params, cfg, cache, tokens),
            init_cache=partial(encdec.init_cache, cfg),
            init_step_state=partial(encdec.init_step_state, cfg),
            decode_step=lambda params, state, bucket: encdec.decode_step(
                params, cfg, state, bucket),
        )
    lm.block_program(cfg)     # raises for a family it does not know
    return Model(
        cfg=cfg,
        init=partial(lm.init_params, cfg),
        loss_fn=lambda params, batch: lm.loss_fn(params, cfg, batch),
        prefill_fn=lambda params, batch, max_len, **kw: lm.prefill_fn(
            params, cfg, batch, max_len, **kw),
        decode_fn=lambda params, cache, tokens: lm.decode_fn(
            params, cfg, cache, tokens),
        init_cache=partial(lm.init_cache, cfg),
        init_step_state=partial(lm.init_step_state, cfg),
        decode_step=lambda params, state, bucket: lm.decode_step(
            params, cfg, state, bucket),
    )


def param_shapes(cfg: ArchConfig) -> dict:
    """Leaf path -> shape of the family's parameter tree."""
    return (encdec if cfg.is_encdec else lm).param_shapes(cfg)


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree as ``meta`` tensors (the reference's
    ``jax.eval_shape`` of ``init``)."""
    return (encdec if cfg.is_encdec else lm).abstract_params(cfg)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, *,
                device="meta") -> dict:
    """Stand-ins for every model input of one cell (the reference's
    ``registry.input_specs``), as tensors on ``device`` (``meta``: nothing
    allocated; on a real device, zeros):

      train  : token / target batches (+ the prefix or frame stubs)
      prefill: prompt tokens (+ stubs)
      decode : one new token per sequence + the decode cache
    """
    b, t = shape.global_batch, shape.seq_len

    def spec(shape_, dtype):
        return torch.zeros(shape_, dtype=dtype, device=device)

    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.is_encdec:
            specs["frames"] = spec((b, t, cfg.d_model), torch.bfloat16)
            specs["tokens"] = spec((b, t), torch.int32)
        else:
            t_text = t - cfg.prefix_embed
            specs["tokens"] = spec((b, t_text), torch.int32)
            if cfg.prefix_embed:
                specs["prefix_embeds"] = spec((b, cfg.prefix_embed,
                                               cfg.d_model), torch.bfloat16)
        if shape.kind == "train":
            specs["targets"] = spec(tuple(specs["tokens"].shape),
                                    torch.int32)
    elif shape.kind == "decode":
        specs["tokens"] = spec((b,), torch.int32)
        specs["cache"] = cache_specs(cfg, b, t, device=device)
    else:
        raise ValueError(shape.kind)
    return specs


def cache_specs(cfg: ArchConfig, batch: int, max_len: int, *,
                device="meta") -> dict:
    """The decode cache of ``batch`` rows as ``meta`` tensors, or zeros on
    ``device`` (whisper's with the reference's ``ENC_FRAMES_STUB`` = 4096
    memory positions)."""
    return (encdec if cfg.is_encdec else lm).init_cache(
        cfg, batch, max_len, device=device)


def param_count(cfg: ArchConfig) -> int:
    return sum(math.prod(s) for s in param_shapes(cfg).values())


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters a token reads: only its top-k experts of each MoE stack
    (the reference's ``registry.active_param_count``)."""
    total = param_count(cfg)
    if cfg.n_experts:
        expert = sum(math.prod(s) for path, s in param_shapes(cfg).items()
                     if any(k.startswith("e_") for k in path.split("/")))
        frac = cfg.experts_per_token / cfg.n_experts
        total = total - expert + int(expert * frac)
    return total
