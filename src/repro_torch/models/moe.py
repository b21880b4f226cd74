"""Mixture-of-Experts FFN with top-k token-choice routing (port of
``repro/models/moe.py``).

Dispatch is the reference's per-sequence capacity gather: for every
(sequence, expert) pair the expert's top-C assigned tokens (C from
:func:`capacity_for`; overflow drops) are gathered into ``(B, E, C, D)``,
each expert's gated FFN runs on its ``B*C`` rows, and the weighted outputs
are added back to their tokens.

What the port does in its own way, and why:

* **Ties.**  ``jax.lax.top_k`` breaks ties toward the lower index, and the
  capacity pick has many zero-gate ties.  ``torch.topk`` promises no tie
  order, so both picks are a stable descending ``torch.sort``, sliced.
* **Products.**  The f32 router product and each expert's three products
  run the port's canonical tiled matmul (``layers.weight_matmul``: kernel
  2's dense-tile entry on the card), so a row's bits do not depend on how
  many rows are multiplied together, which is what lets the engine batch
  requests bitwise (cuBLAS gives M-dependent rows).
* **Combine.**  Slots whose gate is not positive contribute exactly
  ``+0.0`` (``where(gate > 0, y * gate, 0.0)``, as the reference).  Each
  token's contributions are added in a fixed order, experts ascending,
  through an inverse map of the capacity pick and a gather; there is no
  ``index_add_`` / ``scatter_add_`` (their CUDA atomics reorder float
  sums between calls).
* **Expert streaming.**  With :class:`~repro_torch.runtime.experts.
  ExpertRef` leaves the routed expert ids come to the host (one sync per
  MoE layer), the store fetches those experts, and only they are
  computed.  An unrouted expert's slots all have gate 0, so in the dense
  path it adds ``+0.0`` to every token, which leaves a sum that is never
  ``-0.0`` unchanged: skipping it gives the same bits.  Without a store
  the block has no host sync and captures in a CUDA graph.
* **Expert parallelism** (under a serving mesh whose ranks hold their
  share of the expert stacks: ``sharding.expert_layout``, placed by
  ``collectives.place_serving_tree``).  Routing runs on the rank's own
  rows, whole (the router is whole on every rank).  The rank computes only
  its own experts: the capacity pick of those experts (from every data
  rank's rows where the rows and the matrices' output columns are both
  split on "data": ``collectives.expert_dispatch``), ``g`` and ``u`` on
  its F columns, ``h`` all-gathered over "data" along F, ``y`` on its D
  columns and returned to the rows' ranks (``expert_return``).  A column
  slice of a canonical product is that product's columns bit for bit.
  The combine all-gathers every rank's experts' weighted outputs over the
  expert axis (``expert_combine``) and every rank folds all of them in
  ascending expert order, as one device does: no float atomics and no
  reassociating psum, so the block's output is one device's bits.
  ``dispatch_a2a=True`` (the reference's all-to-all onto the contracting
  dim) moves what ``False`` moves: the port splits no contracting dim
  (``docs/PORT.md`` convention 11).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.runtime import collectives, sharding
from repro_torch.runtime.experts import ExpertRef, routed_expert_weights

from .layers import ACT_DTYPE, dense_init, weight_matmul

CAPACITY_FACTOR = 1.25
EXPERT_LEAVES = sharding.EXPERT_LEAVES


def init_moe(n_layers: int, d_model: int, d_ff: int, n_experts: int, gen,
             device, dtype=ACT_DTYPE):
    """Stacked (L, ...) MoE weights: the f32 router (L, D, E) and the
    expert stacks (L, E, D, F) / (L, E, F, D)."""
    return {
        "router": dense_init((n_layers, d_model, n_experts), gen, device,
                             dtype=torch.float32),
        "e_gate": dense_init((n_layers, n_experts, d_model, d_ff), gen,
                             device, dtype=dtype),
        "e_up": dense_init((n_layers, n_experts, d_model, d_ff), gen,
                           device, dtype=dtype),
        "e_down": dense_init((n_layers, n_experts, d_ff, d_model), gen,
                             device, dtype=dtype),
    }


def capacity_for(seq_len: int, n_experts: int, k: int,
                 factor: float = CAPACITY_FACTOR) -> int:
    c = int(factor * k * seq_len / n_experts)
    c = max(1, min(c, seq_len))
    if seq_len >= 8:
        c = min(max(8, (c + 7) // 8 * 8), seq_len)
    return c


def _top(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: values descending, ties to
    the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_weights(p, topk_i: torch.Tensor):
    """``(experts, weights)``: the experts to compute, ascending, and
    ``weights[e] = (gate, up, down)`` for each.  Dense stacks compute every
    expert; :class:`ExpertRef` leaves fetch the routed ones through their
    store."""
    leaves = [p[name] for name in EXPERT_LEAVES]
    refs = [w for w in leaves if isinstance(w, ExpertRef)]
    if not refs:
        n_experts = leaves[0].shape[0]
        return list(range(n_experts)), {
            e: tuple(w[e] for w in leaves) for e in range(n_experts)}
    if len(refs) != len(leaves):
        raise TypeError(
            "moe_block needs e_gate/e_up/e_down uniformly dense or "
            "uniformly expert-streamed; got a mix — see "
            "runtime.experts.install_expert_store")
    routed, stacks = routed_expert_weights(refs, topk_i)
    return routed, {e: tuple(s[e] for s in stacks) for e in routed}


def _held_layout(p, n_experts: int, d_model: int):
    """The expert layout of what this rank holds under the ambient serving
    mesh (``sharding.held_expert_layout``), or None: no mesh, an expert
    store's handles, or stacks held whole on every rank (the one-device
    path then runs as it is)."""
    ctx = collectives.serving_mesh()
    if ctx is None or any(isinstance(p[n], ExpertRef)
                          for n in EXPERT_LEAVES):
        return None
    layout = sharding.held_expert_layout(
        ctx[0], n_experts, d_model, p["e_gate"].shape, p["e_down"].shape,
        collectives.serving_rows()[1])
    if layout.expert_axis is None and layout.data_axis is None:
        return None
    return layout


def _own_experts(p, layout, x_ec, gate_ec, acc_dt) -> torch.Tensor:
    """This rank's experts' products under ``layout`` and the exchanges
    around them: returns every expert's weighted outputs (B, E, C, D) in
    ``acc_dt`` for the rank's rows, ascending expert order."""
    rows = collectives.serving_rows()[0]
    lo, n = layout.offset, layout.local_experts
    x_own = collectives.expert_dispatch(x_ec[:, lo:lo + n], layout, rows)
    bb, _, c, d = x_own.shape                   # bb: the rows multiplied
    hs = []
    for j in range(n):
        xj = x_own[:, j].reshape(bb * c, d)
        g = weight_matmul(p["e_gate"][j], xj, saveable=False)
        u = weight_matmul(p["e_up"][j], xj, saveable=False)
        hs.append((F.silu(g) * u).to(ACT_DTYPE))        # (bb*C, F')
    h = torch.stack(hs)
    if layout.data_axis is not None:
        h = collectives.gather_acts(h, 2, layout.mesh, layout.data_axis)
    y = torch.stack([weight_matmul(p["e_down"][j], h[j], saveable=False)
                     .reshape(bb, c, -1) for j in range(n)], 1)
    y = collectives.expert_return(y, layout, rows)      # (B, n, C, D) f32
    gate = gate_ec[:, lo:lo + n, :, None]
    y = torch.where(gate > 0, y * gate, 0.0).to(acc_dt)
    return collectives.expert_combine(y, layout)


def route(router, x: torch.Tensor, k: int) -> dict:
    """The routing of ``moe_block`` for x (B, T, D): router ``logits`` and
    ``probs`` (B, T, E) f32, each token's top-k experts ``topk_i`` and
    renormalised weights ``topk_p`` (B, T, k), the ``assign`` weights
    (B, T, E), and each (sequence, expert) pair's capacity pick: gates
    ``gate_ec`` and token indices ``idx_ec`` (B, E, C)."""
    b, t, _ = x.shape
    logits = weight_matmul(router, x.float())               # (B, T, E) f32
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_i = _top(probs, k)                         # (B, T, k)
    topk_p = topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)
    assign = torch.zeros((b, t, e), dtype=torch.float32, device=x.device)
    assign.scatter_(2, topk_i, topk_p)                      # distinct per row
    gate_ec, idx_ec = _top(assign.transpose(1, 2),
                           capacity_for(t, e, k))           # (B, E, C)
    return {"logits": logits, "probs": probs, "topk_p": topk_p,
            "topk_i": topk_i, "assign": assign, "gate_ec": gate_ec,
            "idx_ec": idx_ec}


def moe_block(p, x: torch.Tensor, k: int, combine_dtype: str = "f32",
              dispatch_a2a: bool = False):
    """x: (B, T, D) -> (out (B, T, D) in x's dtype, aux dict with the
    router's load-balancing and z losses).  Each token's output is the sum
    of its experts' contributions in ascending expert order, accumulated
    in f32 (``combine_dtype="bf16"``: in bf16)."""
    b, t, d = x.shape
    dev = x.device
    r = route(p["router"], x, k)
    logits, probs, assign = r["logits"], r["probs"], r["assign"]
    gate_ec, idx_ec, topk_i = r["gate_ec"], r["idx_ec"], r["topk_i"]
    e, c = assign.shape[-1], idx_ec.shape[-1]
    bidx = torch.arange(b, device=dev)[:, None, None]
    x_ec = x[bidx, idx_ec]                                  # (B, E, C, D)
    # slot of each (sequence, expert, token) in the capacity pick, or -1;
    # a pick's C token indices are distinct, so the scatter has no clashes
    slot = torch.full((b, e, t), -1, dtype=torch.int64, device=dev)
    slot.scatter_(2, idx_ec, torch.arange(c, device=dev).expand(b, e, c))

    acc_dt = torch.bfloat16 if combine_dtype == "bf16" else torch.float32
    out = torch.zeros((b, t, d), dtype=acc_dt, device=dev)
    layout = _held_layout(p, e, d)
    if layout is not None:
        # every expert's weighted outputs, from the ranks that own them
        y_all = _own_experts(p, layout, x_ec, gate_ec, acc_dt)
        for j in range(e):
            sj = slot[:, j]                                 # (B, T)
            took = torch.gather(y_all[:, j], 1,
                                sj.clamp(min=0)[..., None].expand(b, t, d))
            out = out + torch.where(sj[..., None] >= 0, took, 0.0)
    else:
        experts, weights = _expert_weights(p, topk_i)
        for j in experts:
            w_gate, w_up, w_down = weights[j]
            xj = x_ec[:, j].reshape(b * c, d)
            # the reference's batched expert einsums: no output kept by
            # remat
            g = weight_matmul(w_gate, xj, saveable=False)
            u = weight_matmul(w_up, xj, saveable=False)
            h = (F.silu(g) * u).to(ACT_DTYPE)
            y = weight_matmul(w_down, h, saveable=False).reshape(b, c, d)
            gate = gate_ec[:, j, :, None]
            y = torch.where(gate > 0, y * gate, 0.0)
            sj = slot[:, j]                                 # (B, T)
            took = torch.gather(y, 1,
                                sj.clamp(min=0)[..., None].expand(b, t, d))
            out = out + torch.where(sj[..., None] >= 0, took,
                                    0.0).to(acc_dt)

    me = probs.mean(dim=(0, 1))                             # (E,)
    ce = (assign > 0).float().mean(dim=(0, 1))
    aux = {"lb_loss": e * torch.sum(me * ce),
           "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return out.to(x.dtype), aux
