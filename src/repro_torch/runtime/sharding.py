"""Sharding rules: DP / TP / EP / SP / pod-DP placement specs (port of
``repro/runtime/sharding.py``).

Logical layout (single pod 16x16, multi-pod 2x16x16):
  * batch            -> ("pod", "data") when divisible (pure DP across pods)
  * vocab / heads / ffn / experts / d_inner -> "model"  (TP / EP)
  * decode KV-cache sequence -> "model" (+ "pod" for long-context cells)
  * params replicated across "pod"

A spec is a plain tuple with one entry per tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names; it equals
``tuple(PartitionSpec(...))`` of the reference.  The rules read only
``mesh.shape`` (a dict of axis sizes), so a :class:`~repro_torch.launch.
mesh.Mesh` or any object with such a ``shape`` works.  Axes are dropped
when a dim does not divide by the mesh axis (replicate).

The reference's ``to_named`` (specs to ``NamedSharding``) has no
counterpart: a rank holds its own slice of a tensor, cut by
:func:`local_shard`.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import CompressedTensor
from repro_torch.runtime.weights import (DenseWeight, is_handle,
                                         tree_map_with_path)


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= _axis_size(mesh, n)
        return out
    return mesh.shape[name] if name in mesh.shape else 1


def _fits(dim: int, mesh, name) -> bool:
    size = _axis_size(mesh, name)
    return size > 1 and dim % size == 0


def _present(mesh, name):
    """Drop axis names that don't exist in this mesh; collapse tuples."""
    if name is None:
        return None
    if isinstance(name, (tuple, list)):
        kept = tuple(n for n in name if n in mesh.shape)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return name if name in mesh.shape else None


def _maybe(dim: int, mesh, name):
    """axis name if present and divisible, else None (replicate)."""
    name = _present(mesh, name)
    return name if name is not None and _fits(dim, mesh, name) else None


def batch_axis(mesh, b: int):
    """Largest of ("pod","data") / "data" / None that divides the batch."""
    full = _present(mesh, ("pod", "data"))
    if full is not None and _fits(b, mesh, full):
        return full
    if _fits(b, mesh, "data"):
        return "data"
    return None


def replicated(rank: int) -> tuple:
    return (None,) * rank


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_pspec(path: str, shape, mesh, mode: str = "train") -> tuple:
    """TP(+EP) rules by leaf name; leading stack dims stay unsharded.

    mode="train" also FSDP-shards the non-TP matrix dim over "data";
    mode="serve" keeps weights TP-only, except MoE expert stacks (E on
    model x F on data); mode="serve_ep" shards the expert stacks'
    contracting dim on data."""
    rank = len(shape)
    lead = (None,) * (rank - 2)
    name = path.rsplit("/", 1)[-1]
    fsdp = "data" if mode == "train" else None

    def last2(a, b):
        return (*lead, a, b)

    def m(dim, ax):
        return _maybe(dim, mesh, ax)

    # stream arrays reached as bare path leaves replicate: handles and
    # CompressedTensors are leaves of param_pspecs, placed by their own
    # layout metadata (handle_pspecs / ct_pspecs)
    if "/streams/" in path or "/ct/" in path:
        return replicated(rank)
    if name == "embed":
        return (m(shape[0], "model"), m(shape[1], fsdp))
    if name == "head":
        return (m(shape[0], fsdp), m(shape[1], "model"))
    if rank == 1 or "norm" in name or name in ("conv_b", "dt_bias", "d_skip",
                                               "a_log"):
        return replicated(rank)
    if name in ("e_gate", "e_up", "e_down"):
        if mode == "serve_ep" or name == "e_down":
            return (*(None,) * (rank - 3), m(shape[-3], "model"),
                    m(shape[-2], "data"), None)
        return (*(None,) * (rank - 3), m(shape[-3], "model"), None,
                m(shape[-1], "data"))
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "x_proj",
                "dt_proj", "w_in", "r_in", "wi", "wf", "wo_gate", "router"):
        return last2(m(shape[-2], fsdp), m(shape[-1], "model"))
    if name in ("wo", "w_down", "out_proj"):
        return last2(m(shape[-2], "model"), m(shape[-1], fsdp))
    if name == "conv_w":
        return last2(None, m(shape[-1], "model"))
    return replicated(rank)


def ct_stacked(ct: CompressedTensor) -> bool:
    """Does the stream layout carry a leading layer-stack dim?"""
    base = 3 if ct.shards > 1 else 2
    return ct.streams.mask.ndim == base + 1


def shard_dim(ct: CompressedTensor) -> int:
    """The TP-shard dim of an enec tensor's stream arrays: 1 under a layer
    stack, else 0."""
    return 1 if ct_stacked(ct) else 0


def _stream_leaf_rule(ct: CompressedTensor, mesh, axis="model"):
    """Spec rule for one CompressedTensor's stream arrays, from the
    tensor's own layout: the TP-shard dim goes on ``axis`` when
    ``ct.shards`` divides by the mesh axis; const / raw payloads and
    unsharded streams replicate.  A rank's own slice of a placed tensor
    (the shard dim cut to ``shards / A``) gets the spec of the whole."""
    ax = None
    d = 0
    if ct.mode == "enec" and ct.shards > 1:
        d = shard_dim(ct)
        ax = _maybe(ct.shards, mesh, axis)

    def rule(a: torch.Tensor) -> tuple:
        names = [None] * a.ndim
        if ax is not None and a.ndim > d and a.shape[d] in (
                ct.shards, ct.shards // _axis_size(mesh, ax)):
            names[d] = ax
        return tuple(names)

    return rule


def ct_pspecs(ct: CompressedTensor, mesh, axis="model"):
    """The specs of one bare :class:`CompressedTensor`, in the leaf order
    of the reference's pytree: a :class:`BlockStreams` of specs for an enec
    tensor, the ``raw_bytes`` payload's spec for const / raw."""
    rule = _stream_leaf_rule(ct, mesh, axis)
    if ct.mode == "enec":
        return ct.streams.map(rule)
    return rule(ct.raw_bytes)


def handle_pspecs(handle, mesh, axis="model"):
    """The specs of one serving weight handle, from its metadata: stream /
    fused handles shard their streams' TP dim on ``axis``; a dense handle
    replicates (the dense math runs replicated, so sharded logits equal the
    single-device ones bit for bit); a handle holding no tensor (an expert
    store's) has none."""
    ct = getattr(handle, "ct", None)
    if ct is not None:
        return ct_pspecs(ct, mesh, axis)
    if isinstance(handle, DenseWeight):
        return replicated(handle.w.ndim)
    return None


def param_pspecs(params, mesh, mode: str = "train"):
    """Whole-tree specs: weight handles and CompressedTensors get their
    metadata's stream specs; plain tensors the name / shape rules of
    :func:`param_pspec`."""
    def one(path, leaf):
        if is_handle(leaf):
            return handle_pspecs(leaf, mesh)
        if isinstance(leaf, CompressedTensor):
            return ct_pspecs(leaf, mesh)
        return param_pspec(path, tuple(leaf.shape), mesh, mode)

    return tree_map_with_path(one, params)


# ---------------------------------------------------------------------------
# batches, caches, outputs
# ---------------------------------------------------------------------------

def batch_pspecs(specs: dict, mesh, global_batch: int) -> dict:
    ba = batch_axis(mesh, global_batch)
    out = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = cache_pspecs(v, mesh, global_batch)
        else:
            out[k] = (ba, *((None,) * (len(v.shape) - 1)))
    return out


def cache_pspecs(cache, mesh, b: int):
    """KV caches: batch on data(+pod) when divisible, else the sequence dim
    on ("pod","model") (the long-context path).  SSM states: batch, else
    channel on model."""
    ba = batch_axis(mesh, b)

    def spec_for(path, leaf) -> tuple:
        name = path.rsplit("/", 1)[-1]
        shape = tuple(leaf.shape)
        if name == "lengths":
            return (ba,)
        if name in ("k", "v", "mem_k", "mem_v"):
            # (periods, B, S, KV, hd)
            seq_axes = _maybe(shape[2], mesh, "model") if ba is not None \
                else _maybe(shape[2], mesh, ("pod", "model"))
            return (None, ba, seq_axes, None, None)
        if name in ("h", "conv"):        # mamba state / conv window
            ch = _maybe(shape[-1], mesh, "model")
            return (None, ba, *((None,) * (len(shape) - 3)), ch)
        if name in ("c", "n", "m"):      # mlstm / slstm states
            return (None, ba, *((None,) * (len(shape) - 2)))
        return replicated(len(shape))

    return tree_map_with_path(spec_for, cache)


def logits_pspec(mesh, b: int, vocab: int) -> tuple:
    return (batch_axis(mesh, b), _maybe(vocab, mesh, "model"))


# ---------------------------------------------------------------------------
# a rank's slice
# ---------------------------------------------------------------------------

def spec_leaves(tree, path: str = ""):
    """(path, spec) pairs of a spec tree, named as ``core.api.tree_leaves``
    names the tree's leaves: dicts (sorted keys), lists and NamedTuples
    (by field) are walked; a plain tuple is one spec; ``None`` (a handle
    without tensors) yields nothing."""
    if tree is None:
        return
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        yield path, tree
        return
    if hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from spec_leaves(v, f"{path}/{k}" if path else k)
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from spec_leaves(tree[k], f"{path}/{k}" if path else str(k))
        return
    for i, v in enumerate(tree):
        yield from spec_leaves(v, f"{path}/{i}" if path else str(i))


def local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` under ``spec`` (a view):
    every sharded dim cut to the rank's block along its axes (a tuple of
    axes splits the dim major-to-minor, as a JAX mesh does)."""
    for d, names in enumerate(spec):
        if names is None:
            continue
        names = names if isinstance(names, tuple) else (names,)
        index, count = 0, 1
        for n in names:
            size = mesh.shape.get(n, 1)
            index = index * size + mesh.coords.get(n, 0)
            count *= size
        if t.shape[d] % count:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"over {names} ({count} ranks)")
        step = t.shape[d] // count
        t = t.narrow(d, index * step, step)
    return t


__all__ = ["batch_axis", "param_pspec", "param_pspecs", "ct_pspecs",
           "handle_pspecs", "batch_pspecs", "cache_pspecs", "logits_pspec",
           "local_shard", "spec_leaves", "shard_dim", "ct_stacked"]
