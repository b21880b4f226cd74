"""xLSTM blocks (arXiv:2405.04517; port of ``repro/models/xlstm.py``):
mLSTM (matrix memory) and sLSTM (scalar memory with recurrent gate
feedback), both attention-free with O(1) decode state.

Both run the numerically stabilised recurrent forms (exponential input
gates with the running-max stabiliser ``m``, App. A of the paper) as a
Python loop over time, in f32 (two steps of it on ``meta`` tensors, for
the dry-run: ``layers.scan_steps``).

What the port does in its own way, and why:

* **Products.**  Every product with a weight runs the canonical tiled
  matmul (``layers.weight_matmul``: kernel 2's dense-tile entry on the
  card): ``wq`` / ``wk`` / ``wv`` / ``wo_gate`` / ``out_proj``, the f32
  gate projections ``wi`` / ``wf`` on the f32 input, sLSTM's ``w_in``
  and, inside the time loop, its recurrent ``r_in``.  A row's bits then
  do not depend on the batch, and all three weight modes agree bitwise.
* **Reductions.**  mLSTM's ``C q`` and ``n q`` over ``hd_k`` are fixed
  pairwise sums (``layers.fixed_sum``) for the same reason.
* **Gates.**  ``log_sigmoid`` is the reference's ``-softplus(-x)``
  (``layers.log_sigmoid``); ``exp``, ``tanh`` and ``sigmoid`` are torch's,
  which may differ from XLA's by an f32 ulp (the tests state the
  tolerance this leaves).
* **On a serving mesh** (``runtime/sharding.py:StateLayout``) a rank
  holds only its block of an sLSTM's ``h``'s D, and ``c`` / ``n`` /
  ``m`` whole (:func:`rank_slstm_step`): the bf16 ``h`` is gathered whole
  before ``r_in``, whose product contracts over all of it, and every rank
  then computes the whole new state from the same inputs in the same
  order, so its bits are one device's (``docs/PORT.md`` convention 14).
  The prefill runs the whole recurrence; its caller keeps the rank's
  block (:func:`keep_slstm_blocks`).
"""
from __future__ import annotations

import math

import torch

from .layers import (ACT_DTYPE, dense_init, fixed_sum, log_sigmoid,
                     rms_norm, run_rank, scan_steps, stack_steps,
                     weight_matmul)

M_INIT = -1e30      # the stabiliser's initial value


def mlstm_shapes(d_model: int, n_heads: int) -> dict:
    """One mLSTM layer's leaves: name -> (shape, dtype)."""
    d, bf = d_model, ACT_DTYPE
    return {"wq": ((d, d), bf), "wk": ((d, d), bf), "wv": ((d, d), bf),
            "wi": ((d, n_heads), torch.float32),
            "wf": ((d, n_heads), torch.float32),
            "wo_gate": ((d, d), bf), "out_proj": ((d, d), bf),
            "norm": ((d,), bf)}


def slstm_shapes(d_model: int) -> dict:
    """One sLSTM layer's leaves: name -> (shape, dtype)."""
    d, bf = d_model, ACT_DTYPE
    return {"w_in": ((d, 4 * d), bf), "r_in": ((d, 4 * d), bf),
            "out_proj": ((d, d), bf), "norm": ((d,), bf)}


def _init(shapes: dict, n_layers: int, gen, device) -> dict:
    """Truncated-normal matrices, zero norm scales (the reference's)."""
    p = {}
    for name, (shape, dtype) in shapes.items():
        if len(shape) == 2:
            p[name] = dense_init((n_layers,) + shape, gen, device,
                                 dtype=dtype)
        else:
            p[name] = torch.zeros((n_layers,) + shape, dtype=dtype,
                                  device=device)
    return p


def init_mlstm(n_layers: int, d_model: int, n_heads: int, gen, device):
    return _init(mlstm_shapes(d_model, n_heads), n_layers, gen, device)


def init_slstm(n_layers: int, d_model: int, gen, device):
    return _init(slstm_shapes(d_model), n_layers, gen, device)


# ---------------------------------------------------------------------------
# mLSTM: matrix memory C (B, H, hd_v, hd_k)
# ---------------------------------------------------------------------------

def _mlstm_qkvif(p, x: torch.Tensor, n_heads: int):
    b, t, d = x.shape
    hd = d // n_heads
    q = weight_matmul(p["wq"], x).reshape(b, t, n_heads, hd)
    k = weight_matmul(p["wk"], x).reshape(b, t, n_heads, hd)
    v = weight_matmul(p["wv"], x).reshape(b, t, n_heads, hd)
    k = k / math.sqrt(hd)
    xf = x.float()
    i_pre = weight_matmul(p["wi"], xf)                      # (B, T, H)
    f_pre = weight_matmul(p["wf"], xf)
    o_gate = torch.sigmoid(weight_matmul(p["wo_gate"], x))
    return q, k, v, i_pre, f_pre, o_gate


def _mlstm_cell(carry, inp):
    """Stabilised mLSTM cell (paper eqs. 19-27)."""
    c, n, m = carry                    # (B,H,hdv,hdk), (B,H,hdk), (B,H)
    q_t, k_t, v_t, i_pre, f_pre = inp  # (B,H,hd) x3, (B,H) x2
    log_f = log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c = f_g[..., None, None] * c + i_g[..., None, None] \
        * (v_t[..., :, None] * k_t[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * k_t
    h_num = fixed_sum(c * q_t[..., None, :])                # (B, H, hdv)
    h_den = torch.maximum(torch.abs(fixed_sum(n * q_t)), torch.exp(-m_new))
    return (c, n, m_new), h_num / h_den[..., None]


def _mlstm_out(p, h: torch.Tensor, o_gate: torch.Tensor, dtype):
    h = rms_norm(h.to(ACT_DTYPE), p["norm"]) * o_gate.to(ACT_DTYPE)
    return weight_matmul(p["out_proj"], h).to(dtype)


def mlstm_forward(p, x: torch.Tensor, n_heads: int):
    """x: (B, T, D) -> ((B, T, D), the final state {"c", "n", "m"})."""
    b, t, d = x.shape
    hd = d // n_heads
    q, k, v, i_pre, f_pre, o_gate = _mlstm_qkvif(p, x, n_heads)
    dev = x.device
    carry = (torch.zeros((b, n_heads, hd, hd), dtype=torch.float32,
                         device=dev),
             torch.zeros((b, n_heads, hd), dtype=torch.float32, device=dev),
             torch.full((b, n_heads), M_INIT, dtype=torch.float32,
                        device=dev))
    hs = []
    for i in scan_steps(x, t):
        carry, h = _mlstm_cell(carry, (q[:, i], k[:, i], v[:, i],
                                       i_pre[:, i], f_pre[:, i]))
        hs.append(h)
    h = stack_steps(hs, t).reshape(b, t, d)
    return _mlstm_out(p, h, o_gate, x.dtype), \
        {"c": carry[0], "n": carry[1], "m": carry[2]}


def init_mlstm_cache(d_model: int, n_heads: int, batch: int, device):
    hd = d_model // n_heads
    return {"c": torch.zeros((batch, n_heads, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, n_heads, hd), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, n_heads), M_INIT, dtype=torch.float32,
                            device=device)}


def mlstm_step(p, x: torch.Tensor, cache: dict, n_heads: int):
    """Single-token decode, x (B, 1, D) -> ((B, 1, D), the new state)."""
    q, k, v, i_pre, f_pre, o_gate = _mlstm_qkvif(p, x, n_heads)
    carry, h = _mlstm_cell((cache["c"], cache["n"], cache["m"]),
                           (q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0],
                            f_pre[:, 0]))
    b, d = x.shape[0], x.shape[2]
    return _mlstm_out(p, h.reshape(b, 1, d), o_gate, x.dtype), \
        {"c": carry[0], "n": carry[1], "m": carry[2]}


# ---------------------------------------------------------------------------
# sLSTM: scalar memory, recurrent gate feedback (inherently sequential)
# ---------------------------------------------------------------------------

def _slstm_cell(p, carry, x_pre_t: torch.Tensor):
    """carry: (c, n, h, m) each (B, D) f32; x_pre_t: (B, 4D), the input
    projection, hoisted out of the time loop; only the recurrent ``r_in``
    product runs inside it."""
    c, n, h, m = carry
    pre = x_pre_t + weight_matmul(p["r_in"], h.to(ACT_DTYPE))
    z_pre, i_pre, f_pre, o_pre = pre.chunk(4, dim=-1)
    log_f = log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    z = torch.tanh(z_pre)
    c = f_g * c + i_g * z
    n = f_g * n + i_g
    h_new = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1.0)
    return (c, n, h_new, m_new)


def _slstm_out(p, h: torch.Tensor, dtype):
    h = rms_norm(h.to(ACT_DTYPE), p["norm"])
    return weight_matmul(p["out_proj"], h).to(dtype)


def slstm_forward(p, x: torch.Tensor):
    """x: (B, T, D) -> ((B, T, D), the final state {"c", "n", "h", "m"});
    the input projection is ONE (B*T, D) x (D, 4D) product."""
    b, t, d = x.shape
    x_pre = weight_matmul(p["w_in"], x)                     # (B, T, 4D)
    zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    carry = (zeros, zeros, zeros,
             torch.full((b, d), M_INIT, dtype=torch.float32, device=x.device))
    hs = []
    for i in scan_steps(x, t):
        carry = _slstm_cell(p, carry, x_pre[:, i])
        hs.append(carry[2])
    return _slstm_out(p, stack_steps(hs, t), x.dtype), \
        {"c": carry[0], "n": carry[1], "h": carry[2], "m": carry[3]}


def init_slstm_cache(d_model: int, batch: int, device, layout=None):
    """Zero decode state of ``batch`` rows, each (B, D) f32 (``m`` at its
    initial -1e30), or under a ``sharding.StateLayout`` ``h`` at the
    rank's block of D."""
    d0, d1 = (0, d_model) if layout is None else layout.slstm_block

    def zeros(d):
        return torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"c": zeros(d_model), "n": zeros(d_model), "h": zeros(d1 - d0),
            "m": torch.full((batch, d_model), M_INIT, dtype=torch.float32,
                            device=device)}


def keep_slstm_blocks(entry: dict, got: dict, layout=None) -> None:
    """Copy a prefill's whole final sLSTM state ``got`` into a cache
    entry: whole, or under ``layout`` the rank's block of ``h``'s D (``c``
    / ``n`` / ``m`` whole)."""
    d0, d1 = (0, got["h"].shape[-1]) if layout is None \
        else layout.slstm_block
    for k, t in entry.items():
        t.copy_((got[k][..., d0:d1] if k == "h" else got[k]).to(t.dtype))


def rank_slstm_step(p, x: torch.Tensor, cache: dict, layout=None):
    """The rank-local part of a single-token decode, x (B, 1, D), over
    this rank's block of ``h`` (``cache["h"]`` (B, D_local); ``c`` / ``n``
    / ``m`` (B, D) whole) under a ``sharding.StateLayout`` (None: the
    whole state, one device): a generator with ``ssm.rank_mamba_step``'s
    contract, each ``yield (t, dim, axis)`` a gather.  It returns ((B, 1,
    D), the rank's new state), with the whole step's bits:

      (a) ``w_in`` whole;
      (b) the rank's block of ``h`` cast to bf16 and gathered whole over
          D (the cast is elementwise, so the gathered bf16 is the whole
          ``h``'s cast, at half the bytes of the f32);
      (c) ``r_in``, the gates and the new ``c``, ``n``, ``m`` and ``h``
          whole on every rank, from the same inputs in the same order;
      (d) the output from the whole new ``h``, with no second gather.

    The rank keeps ``c``, ``n`` and ``m`` whole and its block of the new
    ``h``, a view of a fresh tensor that a caller may copy over the
    old one."""
    d = x.shape[-1]
    d0, d1 = (0, d) if layout is None else layout.slstm_block
    x_pre = weight_matmul(p["w_in"], x[:, 0])
    h = cache["h"].to(ACT_DTYPE)
    if d1 - d0 != d:
        h = yield h, -1, layout.slstm_axis
    c, n, h_new, m = _slstm_cell(p, (cache["c"], cache["n"], h, cache["m"]),
                                 x_pre)
    return _slstm_out(p, h_new[:, None, :], x.dtype), \
        {"c": c, "n": n, "h": h_new[..., d0:d1], "m": m}


def slstm_step(p, x: torch.Tensor, cache: dict, layout=None):
    """Single-token decode, x (B, 1, D) -> ((B, 1, D), the new state):
    :func:`rank_slstm_step` over the whole state, or under a
    ``sharding.StateLayout`` over the rank's block of ``h`` with its
    gather."""
    return run_rank(rank_slstm_step(p, x, cache, layout),
                    None if layout is None else layout.gather)
