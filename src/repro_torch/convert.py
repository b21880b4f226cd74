"""Carry a parameter tree of the JAX package over to the port.

``params_from_jax`` takes the reference's parameter tree as numpy arrays
(``jax.device_get(params)``) and returns the port's tree of tensors on
``device``, bit for bit, so both packages compute the same function on the
same weights (an MoE tree's ``moe`` subtree too: the router stays f32 and
the expert stacks stay ``(L, E, ...)``).  bf16 arrays travel through an ``int16`` view (numpy has no
bf16 of its own).  A missing, extra or mis-shaped leaf raises with its
path named.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.lm import param_shapes
from repro_torch.runtime.streaming import tree_leaves, tree_map_with_path


def tensor_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def params_from_jax(tree, device="cuda", *, cfg):
    """The reference's parameter tree (nested dicts/lists of numpy arrays)
    -> the port's tree on ``device``, checked against ``cfg``'s shapes."""
    dev = resolve_device(device)
    want = param_shapes(cfg)
    got = dict(tree_leaves(tree))
    missing = sorted(set(want) - set(got))
    if missing:
        raise KeyError(f"JAX tree lacks leaf {missing[0]!r}")
    extra = sorted(set(got) - set(want))
    if extra:
        raise KeyError(f"JAX tree has unexpected leaf {extra[0]!r}")
    for path, shape in want.items():
        if tuple(np.shape(got[path])) != shape:
            raise ValueError(f"leaf {path!r} has shape "
                             f"{tuple(np.shape(got[path]))}, expected {shape}")
    return tree_map_with_path(
        lambda path, leaf: tensor_from_numpy(np.asarray(leaf), dev), tree)
