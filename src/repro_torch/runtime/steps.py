"""Step builders (port of ``repro/runtime/steps.py``): the train, prefill
and decode steps shared by the launcher and the training loop.

The train step differentiates the model's ``loss_fn`` with autograd: every
weight product runs the canonical tiled matmul (``kernels/ops.py``:
kernel 2' on the card, forward and backward), and the embedding's
gradient is accumulated deterministically (``models/layers.py``), so a
step's bits are the same in every run.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.api import tree_leaves, tree_map_with_path
from repro_torch.optim import adamw


def build_train_step(model, opt_cfg: adamw.AdamWConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""
    def train_step(params, opt_state, batch):
        leaves = tree_map_with_path(
            lambda _, p: p.detach().requires_grad_(True), params)
        flat = list(tree_leaves(leaves))
        with torch.enable_grad():
            loss, metrics = model.loss_fn(leaves, batch)
            got = torch.autograd.grad(loss, [p for _, p in flat],
                                      allow_unused=True)
        # a leaf the loss does not read gets a zero gradient, as jax.grad
        # gives it
        grads = {path: torch.zeros_like(p) if g is None else g
                 for (path, p), g in zip(flat, got)}
        grads = tree_map_with_path(lambda path, _: grads[path], params)
        params, opt_state, om = adamw.apply(opt_cfg, params, opt_state,
                                            grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {"loss": loss.detach(), **metrics, **om}

    return train_step


def build_prefill_step(model, max_len: int) -> Callable:
    def prefill_step(params, batch):
        return model.prefill_fn(params, batch, max_len)
    return prefill_step


def build_decode_step(model) -> Callable:
    def decode_step(params, cache, tokens):
        return model.decode_fn(params, cache, tokens)
    return decode_step
