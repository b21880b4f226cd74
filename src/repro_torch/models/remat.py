"""Rematerialisation of the layer stack's periods (the reference's
``cfg.remat``: ``jax.checkpoint`` around each period body,
``repro/models/lm.py:_wrap_body``).

A period runs under ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``: autograd keeps the period's inputs and drops what
its ops saved; the backward runs the period again to get them back.  The
policy says what else is kept:

  nothing  only the period's inputs (``jax.checkpoint_policies.
           nothing_saveable``);
  dots     also the output of each product the reference computes as a
           ``dot_general`` without batch dimensions
           (``dots_with_no_batch_dims_saveable``; the ``saveable`` marker
           of ``layers.weight_matmul``), when the backward reads it.

Every product of the period goes through the region's :class:`ProductTape`
(``kernels/ops.py:tiled_matmul``).  In the forward the tape records the
saveable products; when the period is done it keeps those whose output a
saved tensor of the period depends on (a product feeding only the period's
output, as the MLP's ``w_down`` in a one-layer period, is read by no
gradient, and the reference's partial evaluation drops it too) and hands
them to autograd (:class:`_Keep`), so that they live exactly as long as
the graph.  In the recompute a kept product's node is made again with its
output the kept one, launching nothing; any other product saves its
operands first and then launches, so checkpoint's early stop, which ends
the recompute once the last tensor the backward needs is saved, does not
launch a last product whose output no gradient reads (``w_down`` above:
the reference's recompute drops it as dead code).

The kernels, their order and their sums are those of the run without
remat: loss, gradients and launches other than the recompute's are
bitwise equal under ``remat=False``, ``nothing`` and ``dots``.  A period
that builds no graph (autograd off, or no input requiring a gradient, as
in every serving path) runs as it is.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import cost, ops

POLICIES = ("nothing", "dots")


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _builds_graph(args) -> bool:
    """Whether running on ``args`` records an autograd graph: grad mode on
    and some tensor of ``args`` requiring a gradient."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensors(args))


class _Replayed(torch.autograd.Function):
    """A product's node made again in a recompute: TiledMatmul's saved
    operands and backward, its output the kept one (``kept``) or, without
    one, a fresh tensor that the caller fills after the operands are
    saved."""

    @staticmethod
    def forward(ctx, x, w, kept):
        ctx.save_for_backward(x, w)
        ctx.repeat = cost.repeat_factor()
        if kept is not None:
            return kept
        return torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32,
                           device=x.device)

    @staticmethod
    def backward(ctx, dy):
        return ops.TiledMatmul.backward(ctx, dy) + (None,)


class _Keep(torch.autograd.Function):
    """The region's outputs, returned as they are, with the kept products
    saved beside them: their gradients reach this node before any node of
    the region runs, so it hands the products back to the tape first."""

    @staticmethod
    def forward(ctx, tape, n, *tensors):
        ctx.tape = tape
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*tensors[n:])
        return tensors[:n]

    @staticmethod
    def backward(ctx, *grads):
        ctx.tape.kept = list(ctx.saved_tensors)
        return (None, None) + grads + (None,) * len(ctx.saved_tensors)


_SAVED_ATTRS: dict = {}     # node type -> its ``_raw_saved_*`` attributes


def _saves(node) -> bool:
    """Whether an autograd node saved a tensor, read without unpacking it
    (an unpack would start the recompute)."""
    names = _SAVED_ATTRS.get(type(node))
    if names is None:
        names = _SAVED_ATTRS[type(node)] = [
            a for a in dir(node) if a.startswith("_raw_saved_")]
    for name in names:
        got = getattr(node, name)
        for v in got if isinstance(got, (tuple, list)) else (got,):
            if isinstance(v, torch._C._autograd.SavedTensor):
                return True
    return False


def _read_by_backward(outputs, boundary, products: dict) -> int:
    """A bit mask over ``products`` (node -> index): the products whose
    output some node of the region saved a tensor computed from, walking
    the region's graph from its ``outputs`` down to the ``boundary`` (the
    nodes of the region's inputs)."""
    order, seen = [], set(boundary)
    stack = [(n, False) for n in outputs]
    while stack:
        node, done = stack.pop()
        if done:
            order.append(node)
            continue
        if node in seen:
            continue
        seen.add(node)
        stack.append((node, True))
        stack.extend((m, False) for m, _ in node.next_functions
                     if m is not None and m not in seen)
    upstream, read = {}, 0
    for node in order:                 # a node after every node it reads
        mask = 0
        for m, _ in node.next_functions:
            mask |= upstream.get(m, 0)
        if _saves(node):
            read |= mask
        upstream[node] = mask | (1 << products[node] if node in products
                                 else 0)
    return read


class ProductTape:
    """The products of one run of a rematerialised region, in call order:
    each an index into ``kept`` (the ``dots`` policy keeps its output) or
    None."""

    def __init__(self, policy: str):
        self.policy = policy
        self.slots: list = []
        self.kept: list = []
        self._recorded: list = []    # (output, node) of each saveable one
        self._replaying = False
        self._next = 0

    @contextlib.contextmanager
    def _active(self, replaying: bool):
        self._replaying, self._next = replaying, 0
        ops.TAPES.append(self)
        try:
            yield
        finally:
            ops.TAPES.pop()

    def contexts(self):
        """checkpoint's ``context_fn``: the forward's and the
        recompute's."""
        return self._active(False), self._active(True)

    def product(self, x: torch.Tensor, w: torch.Tensor, saveable: bool):
        if not self._replaying:
            y = ops.TiledMatmul.apply(x, w)
            slot = None
            if saveable and self.policy == "dots":
                slot = len(self._recorded)
                self._recorded.append((y, y.grad_fn))
            self.slots.append(slot)
            return y
        i, self._next = self._next, self._next + 1
        slot = self.slots[i] if i < len(self.slots) else None
        if slot is not None:
            kept, self.kept[slot] = self.kept[slot], None
            return _Replayed.apply(x, w, kept)
        y = _Replayed.apply(x, w, None)
        # the operands are saved: a recompute that needs no more stops
        # before this launch
        with torch.no_grad():
            y.detach().copy_(ops._tiled(x.detach(), w.detach()))
        return y

    def keep(self, out, args):
        """``out`` with the kept products handed to autograd
        (:class:`_Keep`); the products no gradient reads are dropped and
        run again in the recompute like any other."""
        recorded, self._recorded = self._recorded, []
        if not recorded:
            return out
        flat, spec = pytree.tree_flatten(out)
        idx = [i for i, t in enumerate(flat)
               if isinstance(t, torch.Tensor) and t.requires_grad]
        boundary = {t.grad_fn for t in _tensors(args)
                    if t.grad_fn is not None}
        read = _read_by_backward([flat[i].grad_fn for i in idx], boundary,
                                 {node: j for j, (_, node)
                                  in enumerate(recorded)})
        slot_of, kept = {}, []
        for j, (y, _) in enumerate(recorded):
            if read >> j & 1:
                slot_of[j] = len(kept)
                kept.append(y.detach())
        self.slots = [None if s is None else slot_of.get(s)
                      for s in self.slots]
        if not kept:
            return out
        got = _Keep.apply(self, len(idx), *[flat[i] for i in idx], *kept)
        for i, t in zip(idx, got):
            flat[i] = t
        return pytree.tree_unflatten(flat, spec)


def rematerialised(body, policy: str):
    """``body`` run as one rematerialised region under ``policy`` (one of
    POLICIES) when it builds a graph (:func:`_builds_graph`), else as it
    is."""

    def run(*args, **kwargs):
        if not _builds_graph((args, kwargs)):
            return body(*args, **kwargs)
        tape = ProductTape(policy)
        out = checkpoint(body, *args, use_reentrant=False,
                         context_fn=tape.contexts, **kwargs)
        return tape.keep(out, args)

    return run
