"""Selective state-space (Mamba/S6) block of the Jamba hybrid (port of
``repro/models/ssm.py``).

Prefill runs the recurrence as a Python loop over time carrying the f32
``(B, d_inner, d_state)`` state, so the ``(T, d_inner, d_state)`` outer
product never exists (two steps of it on ``meta`` tensors, for the
dry-run: ``layers.scan_steps``); decode is the same body applied once.

What the port does in its own way, and why:

* **Products.**  ``in_proj``, ``x_proj``, ``dt_proj`` and ``out_proj``
  run the canonical tiled matmul (``layers.weight_matmul``: kernel 2's
  dense-tile entry on the card), so a row's bits do not depend on the
  batch, and dense, stream and fused serving agree bitwise (these leaves
  stream through kernel 1 in both compressing modes).
* **Reductions.**  The read-out over ``d_state`` is a fixed pairwise sum
  (``layers.fixed_sum``), and the causal conv adds its taps in the
  reference's order (taps 0..K-1, then the bias) in prefill and decode
  alike, so a step continues a prefill exactly and its bits are the same
  at every batch size.
* **Short prompts.**  The decode state's conv window is the last
  ``K - 1`` pre-conv inputs of a prompt zero-padded on the left, which is
  the reference's window wherever it is defined (``T >= K - 1``).
* **On a serving mesh** (``runtime/sharding.py:StateLayout``) a rank
  holds and updates only its block of ``h``'s ``d_state`` and of
  ``conv``'s channels (:func:`rank_mamba_step`): the conv and ``_update``
  are per element, so they keep their bits; the conv output ``x`` and the
  read-out's products are gathered whole before the products that
  contract over them (``docs/PORT.md`` convention 13).  The prefill runs
  the whole recurrence; its caller keeps the rank's blocks.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import (ACT_DTYPE, dense_init, fixed_sum, run_rank,
                     scan_steps, softplus, stack_steps, weight_matmul)


def mamba_dims(d_model: int, d_state: int, expand: int = 2):
    d_inner = expand * d_model
    dt_rank = max(1, math.ceil(d_model / 16))
    return d_inner, dt_rank


def mamba_shapes(d_model: int, d_state: int, conv_dim: int) -> dict:
    """One layer's leaves: name -> (shape, dtype)."""
    c, r = mamba_dims(d_model, d_state)
    bf, f32 = ACT_DTYPE, torch.float32
    return {"in_proj": ((d_model, 2 * c), bf), "conv_w": ((conv_dim, c), bf),
            "conv_b": ((c,), bf), "x_proj": ((c, r + 2 * d_state), bf),
            "dt_proj": ((r, c), bf), "dt_bias": ((c,), bf),
            "a_log": ((c, d_state), f32), "d_skip": ((c,), f32),
            "out_proj": ((c, d_model), bf)}


def init_mamba(n_layers: int, d_model: int, d_state: int, conv_dim: int,
               gen, device):
    """Stacked (L, ...) Mamba weights with the reference's distributions:
    truncated-normal projections, zero conv bias, ``dt_bias`` at
    softplus^-1(0.01), ``a_log = log(1..d_state)``, ``d_skip`` ones."""
    c, _ = mamba_dims(d_model, d_state)
    p = {}
    for name, (shape, dtype) in mamba_shapes(d_model, d_state,
                                             conv_dim).items():
        if len(shape) == 2:
            p[name] = dense_init((n_layers,) + shape, gen, device,
                                 dtype=dtype)
    a = torch.arange(1, d_state + 1, dtype=torch.float32, device=device)
    p["a_log"] = torch.log(a)[None, None, :].expand(n_layers, c, d_state) \
        .contiguous()
    p["conv_b"] = torch.zeros((n_layers, c), dtype=ACT_DTYPE, device=device)
    p["dt_bias"] = torch.full((n_layers, c), -4.6, dtype=ACT_DTYPE,
                              device=device)
    p["d_skip"] = torch.ones((n_layers, c), dtype=torch.float32,
                             device=device)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv over time. x (B, T, C), w (K, C): the taps
    added in order 0..K-1 in f32, then the bias."""
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + t].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _projections(p, x: torch.Tensor, d_state: int):
    """x (B, T, C) after the conv and SiLU -> dt (B, T, C), B_t and C_t
    (B, T, S), all f32."""
    dt_rank = p["dt_proj"].shape[0]
    proj = weight_matmul(p["x_proj"], x)                   # (B, T, R + 2S)
    dt = softplus(weight_matmul(p["dt_proj"], proj[..., :dt_rank])
                  + p["dt_bias"].float())
    return dt, proj[..., dt_rank:dt_rank + d_state], \
        proj[..., dt_rank + d_state:]


def _update(h, a, dt_t, x_t, b_t):
    """One step of the f32 recurrence: h' = exp(dt a) h + (dt x) B."""
    da = torch.exp(dt_t[..., None] * a)                    # (B, C, S)
    return da * h + (dt_t * x_t)[..., None] * b_t[:, None, :]


def _read_out(h, c_t):
    """y[b, c] = sum_s h[b, c, s] C[b, s], in a fixed order."""
    return fixed_sum(h * c_t[:, None, :])


def mamba_forward(p, u: torch.Tensor, d_state: int, conv_dim: int = 4):
    """u: (B, T, D) -> ((B, T, D), the final state {"h", "conv"})."""
    xz = weight_matmul(p["in_proj"], u).to(ACT_DTYPE)
    c = xz.shape[-1] // 2
    x_raw, z = xz[..., :c], xz[..., c:]
    x = _causal_conv(x_raw, p["conv_w"], p["conv_b"])
    x = F.silu(x.float()).to(ACT_DTYPE)
    dt, b_t, c_t = _projections(p, x, d_state)
    a = -torch.exp(p["a_log"])                             # (C, S)
    b, t = x.shape[0], x.shape[1]
    xf = x.float()
    h = torch.zeros((b, c, d_state), dtype=torch.float32, device=u.device)
    ys = []
    for i in scan_steps(x, t):
        h = _update(h, a, dt[:, i], xf[:, i], b_t[:, i])
        ys.append(_read_out(h, c_t[:, i]))
    y = stack_steps(ys, t) + xf * p["d_skip"]
    y = y * F.silu(z.float())
    out = weight_matmul(p["out_proj"], y.to(ACT_DTYPE)).to(u.dtype)
    window = F.pad(x_raw, (0, 0, conv_dim - 1, 0))[:, t:]
    return out, {"h": h, "conv": window}


def init_mamba_cache(d_model: int, d_state: int, conv_dim: int, batch: int,
                     device, layout=None):
    """Zero decode state of ``batch`` rows: ``h`` (B, d_inner, d_state)
    f32 and ``conv`` (B, K - 1, d_inner) bf16, or under a
    ``sharding.StateLayout`` the rank's blocks of their last dims."""
    c, _ = mamba_dims(d_model, d_state)
    s0, s1 = (0, d_state) if layout is None else layout.state_block
    c0, c1 = (0, c) if layout is None else layout.channel_block
    return {"h": torch.zeros((batch, c, s1 - s0), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv_dim - 1, c1 - c0),
                                dtype=ACT_DTYPE, device=device)}


def keep_state_blocks(entry: dict, got: dict, layout=None) -> None:
    """Copy a prefill's whole final state ``got`` (``h`` (..., d_inner,
    d_state), ``conv`` (..., K - 1, d_inner)) into a cache entry: whole,
    or under ``layout`` the rank's blocks of their last dims."""
    s0, s1 = (0, got["h"].shape[-1]) if layout is None \
        else layout.state_block
    c0, c1 = (0, got["conv"].shape[-1]) if layout is None \
        else layout.channel_block
    entry["h"].copy_(got["h"][..., s0:s1].to(entry["h"].dtype))
    entry["conv"].copy_(got["conv"][..., c0:c1].to(entry["conv"].dtype))


def rank_mamba_step(p, u: torch.Tensor, cache: dict, d_state: int,
                    layout=None):
    """The rank-local part of a single-token decode, u (B, 1, D), over
    this rank's blocks of the state (``cache["h"]`` (B, d_inner, S_local),
    ``cache["conv"]`` (B, K - 1, C_local)) under a ``sharding.
    StateLayout`` (None: the whole state, one device): a generator.
    Each ``yield (t, dim, axis)`` asks for every rank's ``t`` along ``dim``
    over ``axis`` in block order (``layout.gather``, or a test
    concatenating A ranks' parts in one process) and is sent that; it
    returns ((B, 1, D), the rank's new state).  Its bits are the whole
    step's:

      (a) ``in_proj`` whole;
      (b) the causal conv on the rank's channel block of the window and of
          ``x_raw`` (the taps in order 0..K-1, then the bias), then SiLU;
      (c) ``x`` gathered whole along the channels (bf16, B x d_inner);
      (d) ``x_proj`` / ``dt_proj`` whole;
      (e) ``_update`` on the rank's ``d_state`` block of ``h``, ``a`` and
          ``B_t`` (elementwise);
      (f) the read-out's products ``h * C_t`` on the block, gathered along
          ``d_state``, then the fixed pairwise sum over all of it.  Partial
          sums are not folded: ``fixed_sum`` adds element j to j + half
          first, so a contiguous block's own sum is not a subtree of it.

    The new conv window is a view of a fresh tensor, never of
    ``cache["conv"]``, so a caller may copy it over the old one."""
    xz = weight_matmul(p["in_proj"], u).to(ACT_DTYPE)
    c = xz.shape[-1] // 2
    x_raw, z = xz[..., :c], xz[..., c:]
    c0, c1 = (0, c) if layout is None else layout.channel_block
    s0, s1 = (0, d_state) if layout is None else layout.state_block
    win = torch.cat([cache["conv"], x_raw[..., c0:c1]], dim=1)  # (B, K, Cl)
    w = p["conv_w"][:, c0:c1]
    x = torch.zeros(win[:, 0].shape, dtype=torch.float32, device=u.device)
    for i in range(w.shape[0]):
        x = x + win[:, i].float() * w[i].float()
    x = F.silu(x + p["conv_b"][c0:c1].float()).to(ACT_DTYPE)
    if c1 - c0 != c:
        x = yield x, -1, layout.conv_axis
    x = x[:, None, :]
    dt, b_t, c_t = _projections(p, x, d_state)
    a = -torch.exp(p["a_log"])[:, s0:s1]
    xf = x[:, 0].float()
    h = _update(cache["h"], a, dt[:, 0], xf, b_t[:, 0, s0:s1])
    prods = h * c_t[:, 0, None, s0:s1]
    if s1 - s0 != d_state:
        prods = yield prods, -1, layout.h_axis
    y = fixed_sum(prods)[:, None, :] + x.float() * p["d_skip"]
    y = y * F.silu(z.float())
    out = weight_matmul(p["out_proj"], y.to(ACT_DTYPE)).to(u.dtype)
    return out, {"h": h, "conv": win[:, 1:]}


def mamba_step(p, u: torch.Tensor, cache: dict, d_state: int,
               layout=None):
    """Single-token decode, u (B, 1, D) -> ((B, 1, D), the new state):
    :func:`rank_mamba_step` over the whole state, or under a
    ``sharding.StateLayout`` over the rank's blocks with its gathers."""
    return run_rank(rank_mamba_step(p, u, cache, d_state, layout),
                    None if layout is None else layout.gather)
