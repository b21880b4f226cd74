"""Transformer primitives, dense path (port of ``repro/models/layers.py``):
norms, rotary embeddings, GQA attention, gated MLP, embeddings.

Conventions follow the reference: activations bf16 (``ACT_DTYPE`` casts in
the same places), matmuls accumulate in f32, norms and softmax in f32.
Attention is plain PyTorch following the reference's chunked softmax; the
reference computes it with plain jnp outside any Pallas kernel too.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.runtime.weights import WeightHandle

ACT_DTYPE = torch.bfloat16
KV_CHUNK = 2048


def weight_matmul(w, x: torch.Tensor) -> torch.Tensor:
    """Contract x's last axis against the (K, N) weight ``w`` -> f32.

    A WeightHandle runs its mode's canonical tiled contraction (dense /
    stream / fused give bitwise-equal results); a plain tensor runs the
    same contraction (``kernels/ops.py:tiled_matmul``), so an unassigned
    tree gives the dense mode's bits and every row's bits are independent
    of how many rows are multiplied together.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if isinstance(w, WeightHandle):
        out = w.matmul(x2)
    else:
        out = ops.tiled_matmul(x2, w)
    return out.reshape(lead + (out.shape[-1],))


# ---------------------------------------------------------------------------
# init helpers (distributions of the reference's dense_init / embed_init)
# ---------------------------------------------------------------------------

def _trunc_normal(shape, std: float, gen: torch.Generator, device,
                  dtype=ACT_DTYPE) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def dense_init(shape, gen, device, in_axis: int = -2, dtype=ACT_DTYPE):
    """Truncated normal (+-2 sigma) scaled by 1/sqrt(fan_in)."""
    return _trunc_normal(shape, 1.0 / math.sqrt(shape[in_axis]), gen,
                         device, dtype)


def embed_init(shape, gen, device, dtype=ACT_DTYPE):
    return _trunc_normal(shape, 0.02, gen, device, dtype)


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    # theta as a CPU scalar: a device copy of it would synchronise, which
    # a CUDA graph capture of the decode step refuses
    return torch.pow(torch.tensor(theta, dtype=torch.float32), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e6) -> torch.Tensor:
    """x: (..., T, H, hd), positions: broadcastable to (..., T)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    ang = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnParamsShape:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False


def init_attention(n_layers: int, s: AttnParamsShape, gen, device):
    """Stacked (L, ...) attention weights; with ``qk_norm`` also the
    per-head RMS-norm scales ``q_norm`` / ``k_norm`` (L, head_dim), zeros
    as in the reference."""
    hq, hkv = s.n_heads * s.head_dim, s.n_kv_heads * s.head_dim
    p = {
        "wq": dense_init((n_layers, s.d_model, hq), gen, device),
        "wk": dense_init((n_layers, s.d_model, hkv), gen, device),
        "wv": dense_init((n_layers, s.d_model, hkv), gen, device),
        "wo": dense_init((n_layers, hq, s.d_model), gen, device),
    }
    if s.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.zeros((n_layers, s.head_dim), dtype=ACT_DTYPE,
                                  device=device)
    return p


def _project_qkv(p, x, s: AttnParamsShape, positions, theta):
    b, t, _ = x.shape
    q = weight_matmul(p["wq"], x).reshape(b, t, s.n_heads, s.head_dim)
    k = weight_matmul(p["wk"], x).reshape(b, t, s.n_kv_heads, s.head_dim)
    v = weight_matmul(p["wv"], x).reshape(b, t, s.n_kv_heads, s.head_dim)
    q, k, v = q.to(ACT_DTYPE), k.to(ACT_DTYPE), v.to(ACT_DTYPE)
    if s.qk_norm:   # the reference's default eps, not cfg.norm_eps
        q, k = rms_norm(q, p["q_norm"]), rms_norm(k, p["k_norm"])
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def _chunk_scores(q, k, scale: float):
    """q (B,Tq,H,hd) x k (B,S,KV,hd) -> (B,H,Tq,S) f32, GQA via reshape."""
    b, tq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, tq, kv, h // kv, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float()) * scale
    return s.reshape(b, h, tq, s.shape[-1])


def _chunk_out(probs, v, h: int):
    """probs (B,H,Tq,S) x v (B,S,KV,hd) -> (B,Tq,H,hd) f32."""
    b, _, tq, s_len = probs.shape
    kv = v.shape[2]
    pg = probs.reshape(b, kv, h // kv, tq, s_len)
    out = torch.einsum("bkgts,bskh->btkgh", pg.float(), v.float())
    return out.reshape(b, tq, h, v.shape[-1])


def _heads_last(t):
    """(B, H, Tq, 1) -> (B, Tq, H, 1)."""
    return t.squeeze(-1).transpose(1, 2)[..., None]


def flash_attention(q, k, v, *, chunk: int = KV_CHUNK):
    """Causal streaming-softmax attention over KV chunks (the reference's
    algorithm, queries and keys from the same positions).
    q: (B, Tq, H, hd); k, v: (B, S, KV, hd)."""
    b, tq, h, hd = q.shape
    s_total = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, s_total)
    n_chunks = (s_total + chunk - 1) // chunk
    dev = q.device
    inf = torch.tensor(float("inf"), device=dev)
    m = torch.full((b, h, tq, 1), -math.inf, dtype=torch.float32, device=dev)
    denom = torch.zeros((b, h, tq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, tq, h, hd), dtype=torch.float32, device=dev)
    q_pos = torch.arange(tq, device=dev)[:, None]
    for c in range(n_chunks):
        lo = c * chunk
        hi = min(lo + chunk, s_total)
        kc, vc = k[:, lo:hi], v[:, lo:hi]
        scores = _chunk_scores(q, kc, scale)
        k_pos = lo + torch.arange(hi - lo, device=dev)[None, :]
        scores = torch.where((k_pos <= q_pos)[None, None], scores, -inf)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(scores - m_safe)
        p = torch.where(torch.isfinite(scores), p, 0.0)
        finite_m = torch.isfinite(m)
        correction = torch.exp(torch.where(finite_m, m - m_safe, -inf))
        correction = torch.where(finite_m, correction, 0.0)
        denom = denom * correction + p.sum(dim=-1, keepdim=True)
        acc = acc * _heads_last(correction) + _chunk_out(p.to(ACT_DTYPE),
                                                         vc, h)
        m = m_new
    denom = torch.clamp(denom, min=1e-30)
    return (acc / _heads_last(denom)).to(ACT_DTYPE)


def decode_attention(q, k_cache, v_cache, lengths):
    """Single-token decode: q (B, 1, H, hd) over caches (B, S, KV, hd);
    ``lengths`` (B,) valid entries per sequence."""
    h, hd = q.shape[2], q.shape[3]
    s_len = k_cache.shape[1]
    scores = _chunk_scores(q, k_cache, 1.0 / math.sqrt(hd))
    k_pos = torch.arange(s_len, device=q.device)[None, None, None, :]
    bias = torch.where(k_pos < lengths[:, None, None, None], 0.0, -1e30)
    scores = scores + bias
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    probs = p / p.sum(dim=-1, keepdim=True)
    return _chunk_out(probs.to(ACT_DTYPE), v_cache, h)


def attention_block(p, x, s: AttnParamsShape, positions, theta, *,
                    chunk=KV_CHUNK):
    """Full-sequence causal self attention (prefill). Returns
    (out, (k, v))."""
    q, k, v = _project_qkv(p, x, s, positions, theta)
    out = flash_attention(q, k, v, chunk=chunk)
    out = weight_matmul(p["wo"], out.reshape(x.shape[0], x.shape[1], -1))
    return out.to(x.dtype), (k, v)


def attention_decode_block(p, x, s: AttnParamsShape, cache_kv, lengths,
                           theta):
    """One-token decode step. x: (B, 1, D); cache_kv: (k, v) (B, S, KV, hd).

    Writes the new k/v at position ``lengths`` per sequence — in place, to
    save a cache copy per layer and step — then attends.
    """
    k_cache, v_cache = cache_kv
    q, k_new, v_new = _project_qkv(p, x, s, lengths[:, None], theta)
    bidx = torch.arange(x.shape[0], device=x.device)
    k_cache[bidx, lengths] = k_new[:, 0]
    v_cache[bidx, lengths] = v_new[:, 0]
    out = decode_attention(q, k_cache, v_cache, lengths + 1)
    out = weight_matmul(p["wo"], out.reshape(x.shape[0], 1, -1))
    return out.to(x.dtype), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# gated MLP, embeddings, head
# ---------------------------------------------------------------------------

def init_mlp(n_layers: int, d_model: int, d_ff: int, gen, device):
    return {
        "w_gate": dense_init((n_layers, d_model, d_ff), gen, device),
        "w_up": dense_init((n_layers, d_model, d_ff), gen, device),
        "w_down": dense_init((n_layers, d_ff, d_model), gen, device),
    }


def mlp_block(p, x):
    """SwiGLU MLP."""
    g = weight_matmul(p["w_gate"], x)
    u = weight_matmul(p["w_up"], x)
    h = (F.silu(g) * u).to(ACT_DTYPE)
    return weight_matmul(p["w_down"], h).to(x.dtype)


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor):
    return embedding[tokens].to(ACT_DTYPE)


def lm_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x (B, T, D) @ head (D, V) -> f32 logits, through the canonical tiled
    matmul (``kernels/ops.py:tiled_matmul``: the dense-tile kernel entry on
    the card, which takes the tied head ``embed.T`` as it is; the plain
    tiled matmul on the CPU), so a row's logits have the same bits at every
    batch size and in every weight mode."""
    b, t, d = x.shape
    out = ops.tiled_matmul(x.reshape(b * t, d).contiguous(), head)
    return out.reshape(b, t, out.shape[-1])
