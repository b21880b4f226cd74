"""Step builders (port of ``repro/runtime/steps.py``): the train, prefill
and decode steps shared by the launcher and the training loop.

The train step differentiates the model's ``loss_fn`` with autograd: every
weight product runs the canonical tiled matmul (``kernels/ops.py``:
kernel 2' on the card, forward and backward), and the embedding's
gradient is accumulated deterministically (``models/layers.py``), so a
step's bits are the same in every run.

On a training mesh (``build_train_step(..., mesh=)``: axes ("pod",
"data", "model") in that order, any of them absent or of size 1) each
rank holds its shards of the parameters and AdamW moments
(``runtime/elastic.py``: FSDP over "data", TP over "model", replicated
across "pod", the reference's pod-DP layout) and a step runs, on every
rank:

  1. gather: every parameter whole from its shards (dense broadcasts,
     counted on ``d2d_allgather``);
  2. forward and backward over this rank's rows of the global batch
     (``sharding.batch_axis``: ("pod", "data") where the batch divides,
     else "data", else none; ranks that differ only on "model", or on
     "pod" when the rows sit on "data" alone, compute the same rows);
  3. the gradient sum over the batch's ranks: each rank's whole gradient
     stacked pod-major (the order ``local_shard`` splits the rows in),
     ``REDUCE_CHUNK`` elements at a time, and summed in that order in
     f32, scaled by 1/N for the N row blocks and cast to the parameter's
     dtype (counted on ``d2d_psum`` as (N - 1) x the gradient's dense
     bytes; none with N = 1), the same bits on every rank: a (P, D, M)
     mesh gives what a (P·D, M) mesh gives, bit for bit (``docs/PORT.md``
     convention 12);
  4. the global norm of the whole gradient;
  5. AdamW on the local shards of params, m and v, clipped by that norm.

The loss metric is the rank-ordered mean over the same ranks of their
local losses.  With N = 1 every rank computes exactly what one device
computes.

On a serving mesh (``build_prefill_step`` / ``build_decode_step(...,
mesh=)``) a rank runs its rows of the batch under the ambient serving mesh
(its stream shards gathered at use) over its share of the K/V rings
(``sharding.kv_layout``; the decode attention's gathers over the sequence
axes), of the recurrent states (``sharding.state_layout``: Mamba ``h``'s
d_state and ``conv``'s channels on "model", the conv output and the
read-out's products gathered; an sLSTM ``h``'s D on "model", its bf16
``h`` gathered) and of whisper's encoder memory
(``sharding.memory_layout``; the cross attention's gathers), and with its
share of the MoE expert stacks
(``sharding.expert_layout``; the MoE block's exchanges over "data" and
"model"), as the dry-run's serving cells run rank 0.
"""
from __future__ import annotations

import math
import time
from typing import Callable

import torch

from repro_torch.core.api import tree_leaves, tree_map_with_path
from repro_torch.core.codec_api import current_codec
from repro_torch.launch.mesh import gather_whole
from repro_torch.optim import adamw
from repro_torch.optim.grad_compress import rank_ordered_sum
from repro_torch.runtime import elastic, sharding
from repro_torch.runtime.collectives import use_serving_mesh

# a training mesh's axes, in the order a mesh lays them out
TRAIN_AXES = ("pod", "data", "model")
# elements of a gradient leaf the sum over the row blocks gathers at once:
# the stack of N whole parts of a layer-stacked leaf would hold N copies
REDUCE_CHUNK = 1 << 26


def loss_and_grads(model, params, batch) -> tuple:
    """``(loss, metrics, grads)`` of ``model.loss_fn`` at ``params``: a
    leaf the loss does not read gets a zero gradient, as jax.grad gives
    it."""
    leaves = tree_map_with_path(
        lambda _, p: p.detach().requires_grad_(True), params)
    flat = list(tree_leaves(leaves))
    with torch.enable_grad():
        loss, metrics = model.loss_fn(leaves, batch)
        got = torch.autograd.grad(loss, [p for _, p in flat],
                                  allow_unused=True)
    grads = {path: torch.zeros_like(p) if g is None else g
             for (path, p), g in zip(flat, got)}
    grads = tree_map_with_path(lambda path, _: grads[path], params)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def build_train_step(model, opt_cfg: adamw.AdamWConfig, mesh=None
                     ) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); on
    ``mesh`` (a ``launch/mesh.py`` mesh over ``TRAIN_AXES``) params and
    opt_state are this rank's shards and batch the global batch."""
    if mesh is not None:
        return _mesh_train_step(model, opt_cfg, mesh)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(model, params, batch)
        params, opt_state, om = adamw.apply(opt_cfg, params, opt_state,
                                            grads)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def _clock(dev: torch.device) -> float:
    """The host clock once ``dev`` has finished its queued work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def mean_over_row_blocks(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean over the row blocks of ``axes`` (``sharding.batch_axis``'s
    answer: an axis or a tuple of them) of every block's ``t``: each
    block's ``t`` gathered pod-major (the order ``local_shard`` splits
    the rows in), ``REDUCE_CHUNK`` elements at a time, summed in that
    order in f32 by ``rank_ordered_sum``, divided by the number of blocks
    and cast to ``t``'s dtype; the same bits on every rank.  Counted on no
    link (the step counts its ``d2d_psum`` bytes)."""
    names = axes if isinstance(axes, tuple) else (axes,)
    n = math.prod(mesh.shape[a] for a in names)
    flat = t.reshape(-1)
    out = torch.empty_like(flat)
    for a in range(0, flat.numel(), REDUCE_CHUNK):
        piece = flat[a:a + REDUCE_CHUNK]
        parts = gather_whole([piece[None]], [(axes,)], mesh, link=None)[0]
        out[a:a + piece.numel()] = (rank_ordered_sum(parts) / n).to(t.dtype)
    return out.view(t.shape)


def _mesh_train_step(model, opt_cfg, mesh) -> Callable:
    from repro_torch.models.registry import abstract_params
    if tuple(mesh.shape) != tuple(a for a in TRAIN_AXES if a in mesh.shape):
        raise ValueError(f"a training mesh has axes {TRAIN_AXES} in that "
                         f"order, any of them absent, got "
                         f"{tuple(mesh.shape)}")
    pspecs = sharding.param_pspecs(abstract_params(model.cfg), mesh,
                                   mode="train")
    specs = dict(sharding.spec_leaves(pspecs))

    def train_step(params, opt_state, batch):
        codec = current_codec()
        gathered = codec.link_stats()["d2d_allgather"]["dense_bytes"]
        t0 = _clock(mesh.device)
        whole = elastic.gather_tree(params, mesh, pspecs, codec=codec)
        gathered = codec.link_stats()["d2d_allgather"]["dense_bytes"] \
            - gathered
        t1 = _clock(mesh.device)

        rows = batch["tokens"].shape[0]
        bspecs = sharding.batch_pspecs(batch, mesh, rows)
        local = {k: sharding.local_shard(v, bspecs[k], mesh)
                 for k, v in batch.items()}
        loss, metrics, grads = loss_and_grads(model, whole, local)
        del whole
        t2 = _clock(mesh.device)

        reduce_bytes = 0
        axes = sharding.batch_axis(mesh, rows)
        if axes is not None:        # the rows are split: sum over them
            n = math.prod(mesh.shape[a] for a in (
                axes if isinstance(axes, tuple) else (axes,)))

            def reduce(q, g):
                nonlocal reduce_bytes
                nbytes = (n - 1) * g.numel() * g.element_size()
                codec.count_link("d2d_psum", nbytes, dense=True)
                reduce_bytes += nbytes
                return mean_over_row_blocks(g, mesh, axes)

            grads = tree_map_with_path(reduce, grads)
            names = sorted(metrics)
            means = mean_over_row_blocks(torch.stack(
                [loss] + [metrics[k].float() for k in names]), mesh, axes)
            loss = means[0]
            metrics = dict(zip(names, means[1:]))
        gnorm = adamw.global_norm(grads)
        local_grads = tree_map_with_path(
            lambda q, g: sharding.local_shard(g, specs[q], mesh), grads)
        t3 = _clock(mesh.device)
        params, opt_state, om = adamw.apply(opt_cfg, params, opt_state,
                                            local_grads, gnorm=gnorm)
        return params, opt_state, {
            "loss": loss, **metrics, **om, "gather_s": t1 - t0,
            "compute_s": t2 - t1, "reduce_s": t3 - t2,
            "gather_bytes": gathered, "reduce_bytes": reduce_bytes}

    return train_step


def build_prefill_step(model, max_len: int, mesh=None,
                       expert_mode: str = "serve") -> Callable:
    """(params, batch) -> (logits, cache).  On a serving ``mesh``
    (``launch/mesh.py``; ``params`` as ``runtime/collectives.py`` places
    them, MoE expert stacks under ``sharding.expert_layout(mode=
    expert_mode)``) the step runs under it as the ambient serving mesh on
    this rank's rows of the global ``batch`` (``sharding.batch_pspecs``)
    and keeps this rank's share of the cache, as ``cache_pspecs`` places
    it (:func:`serving_layouts` with ``batch=rows``): the K/V rings'
    sequence, the Mamba states' blocks and the encoder memory's
    positions.  Its logits and cache are the rank's."""
    if mesh is None:
        def prefill_step(params, batch):
            return model.prefill_fn(params, batch, max_len)
        return prefill_step

    def mesh_prefill_step(params, batch):
        rows = batch["tokens"].shape[0]
        bspecs = sharding.batch_pspecs(batch, mesh, rows)
        local = {k: sharding.local_shard(v, bspecs[k], mesh)
                 for k, v in batch.items()}
        enc_len = batch["frames"].shape[1] if "frames" in batch else None
        layouts = serving_layouts(model.cfg, mesh, max_len, rows, enc_len)
        with use_serving_mesh(mesh, rows=sharding.batch_axis(mesh, rows),
                              expert_mode=expert_mode):
            return model.prefill_fn(params, local, max_len, **layouts)

    return mesh_prefill_step


def serving_layouts(cfg, mesh, max_len: int, rows=None,
                    enc_len=None) -> dict:
    """How a rank of a serving ``mesh`` holds a cache of ``rows`` rows
    (``None``: every row on every rank), as keyword arguments of the
    model's ``prefill_fn`` / ``init_cache``: ``layout``, the K/V rings'
    (``sharding.kv_layout`` of ``max_len``, pinned by
    ``cfg.decode_score_shard``); for whisper ``memory``, the encoder
    memory's (``sharding.memory_layout`` of ``enc_len``); for a program
    with Mamba or sLSTM blocks ``state``, their states'
    (``sharding.state_layout``).
    The decode step reads them from the cache."""
    from repro_torch.models import encdec, lm
    out = {"layout": sharding.kv_layout(mesh, max_len, batch=rows,
                                        pin=cfg.decode_score_shard)}
    if cfg.is_encdec:
        out["memory"] = encdec.memory_layout(
            encdec.ENC_LEN if enc_len is None else enc_len, mesh,
            batch=rows)
        return out
    state = lm.state_layout(cfg, mesh, batch=rows)
    if state is not None:
        out["state"] = state
    return out


def build_decode_step(model, mesh=None,
                      expert_mode: str = "serve") -> Callable:
    """(params, cache, tokens) -> (logits, cache).  On a serving ``mesh``
    ``cache`` is this rank's (its rows and its share of the K/V rings,
    the recurrent states and the encoder memory, its layouts recorded in it:
    the mesh prefill step's, or ``model.init_cache(..., **
    serving_layouts(cfg, mesh, max_len, B))``) and ``tokens`` the global
    (B,) batch, of which the step decodes this rank's rows under the
    ambient serving mesh (MoE expert stacks as for
    :func:`build_prefill_step`)."""
    if mesh is None:
        def decode_step(params, cache, tokens):
            return model.decode_fn(params, cache, tokens)
        return decode_step

    def mesh_decode_step(params, cache, tokens):
        spec = (sharding.batch_axis(mesh, tokens.shape[0]),)
        with use_serving_mesh(mesh, rows=spec[0], expert_mode=expert_mode):
            return model.decode_fn(params, cache, sharding.local_shard(
                tokens, spec, mesh))

    return mesh_decode_step
