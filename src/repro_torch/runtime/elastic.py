"""Elastic scaling: size a training mesh from the ranks there are and move
state onto it (port of ``repro/runtime/elastic.py``).

Flow: a job restarts on whatever ranks survive -> :func:`best_mesh_for`
picks the largest ``(data, model)`` grid the new world supports (the model
width capped by head / ffn / expert divisibility) -> the checkpoint's
records, which are layout-agnostic wire bytes, restore onto it
(``CheckpointManager.load(..., mesh=, pspecs=)`` keeps each rank's shards
through :func:`reshard`) -> training resumes at the saved step.  Nothing
in the pipeline depends on the world size: a batch is a pure function of
(seed, step).

A rank holds its shards as tensors of its own (:func:`reshard`), never as
views of a whole tensor, so its resident bytes fall to its share of the
state; :func:`gather_tree` rebuilds the whole tensors from them.  On a
mesh with a "pod" axis (``("pod", "data", "model")``, the reference's
pod-DP layout) the state is placed by "data" and "model" only: every pod
holds the same shards.  The grids :func:`best_mesh_for` picks stay
``(data, model)``, as the reference's do.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.api import tree_leaves, tree_map_with_path
from repro_torch.launch.mesh import gather_whole, make_mesh, world_size
from repro_torch.optim import adamw
from repro_torch.runtime import sharding


def candidate_grids(n_devices: int, max_model: int = 16):
    """(data, model) factorizations, largest model axis first."""
    out = []
    m = max_model
    while m >= 1:
        if n_devices % m == 0:
            out.append((n_devices // m, m))
        m //= 2
    return out


def best_mesh_for(cfg, n_devices: Optional[int] = None, max_model: int = 16,
                  device="cuda"):
    """Largest usable (data, model) mesh for this arch on ``n_devices``
    ranks (default: the world's).  The model axis must divide the
    TP-sharded dims actually used."""
    n = n_devices if n_devices is not None else world_size()
    hd_total = cfg.n_heads * cfg.head_dim_()
    for data, model in candidate_grids(n, max_model):
        divisible = (hd_total % model == 0
                     and (cfg.d_ff % model == 0 or cfg.d_ff == 0)
                     and (cfg.n_experts % model == 0 or cfg.n_experts == 0))
        if divisible:
            return make_mesh((data, model), ("data", "model"), device)
    return make_mesh((n,), ("data",), device)


def train_pspecs(params, mesh) -> dict:
    """Specs of the training state ``{"params", "opt"}`` of whole-shaped
    ``params`` (tensors or ``meta`` tensors): FSDP over "data" on the
    non-TP matrix dim and TP over "model" (``param_pspecs(mode="train")``),
    the AdamW moments as their parameters, the step replicated (the
    reference's ``launch/train.py``); on a pod mesh every pod holds the
    same shards (no spec names "pod")."""
    specs = sharding.param_pspecs(params, mesh, mode="train")
    return {"params": specs,
            "opt": adamw.AdamWState(step=(), m=specs, v=specs)}


def reshard(tree, mesh, pspecs):
    """This rank's shards of the whole ``tree`` (on the host or a device)
    under ``pspecs``, each a contiguous tensor of its own on
    ``mesh.device``: a view would keep the whole tensor alive."""
    specs = dict(sharding.spec_leaves(pspecs))

    def one(path, t):
        piece = sharding.local_shard(t, specs[path], mesh)
        return torch.empty(piece.shape, dtype=piece.dtype,
                           device=mesh.device).copy_(piece)

    return tree_map_with_path(one, tree)


def abstract_shards(tree, mesh, pspecs):
    """``meta`` tensors of the shapes and dtypes of this rank's shards of
    the whole ``tree`` (tensors or ``meta`` tensors) under ``pspecs``."""
    specs = dict(sharding.spec_leaves(pspecs))
    return tree_map_with_path(lambda path, t: torch.empty(
        sharding.local_shard(t, specs[path], mesh).shape, dtype=t.dtype,
        device="meta"), tree)


def whole_shape(t: torch.Tensor, spec, mesh) -> tuple:
    """The whole tensor's shape of which ``t`` is this rank's shard."""
    shape = list(t.shape)
    for d, names in enumerate(spec):
        if names is None:
            continue
        for n in (names if isinstance(names, tuple) else (names,)):
            shape[d] *= mesh.shape.get(n, 1)
    return tuple(shape)


def gather_tree(tree, mesh, pspecs, *, codec=None, link="d2d_allgather"):
    """The whole tree from this rank's shards (every rank calls it): one
    :func:`~repro_torch.launch.mesh.gather_whole` of all the leaves,
    counted on ``link``."""
    specs = dict(sharding.spec_leaves(pspecs))
    flat = list(tree_leaves(tree))
    whole = dict(zip((p for p, _ in flat), gather_whole(
        [t for _, t in flat], [specs[p] for p, _ in flat], mesh,
        codec=codec, link=link)))
    return tree_map_with_path(lambda p, _: whole[p], tree)
