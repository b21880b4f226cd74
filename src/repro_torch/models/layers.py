"""Transformer primitives (port of ``repro/models/layers.py``): norms,
rotary embeddings, GQA attention (causal, with an optional bidirectional
prefix), whisper's cross attention, gated MLP, embeddings, the
cross-entropy loss, and the fixed-order sums and f32 gate functions of the
recurrent blocks.

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
DECODE_CHUNK = 1024     # cache positions a decode step's sums take at once


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

def fixed_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by a fixed pairwise tree of elementwise adds
    (zero-padded to a power of two; element j and j + half first, as
    ``kernels/ref.py:tile_product``), so each output's bits depend on its
    own row alone: never on the batch, on a CUDA graph or on the library's
    choice of a reduction kernel for the shape."""
    n = t.shape[-1]
    width = 1 << max(0, (n - 1).bit_length())
    if width != n:
        t = F.pad(t, (0, width - n))
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        t = t[..., :h] + t[..., h:]
    return t[..., 0]


def fixed_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``fixed_sum(a * b)`` for f32 ``a`` and bf16-valued ``b``, the
    tree's first level taken in the products (``addcmul_``), so the full
    product is never written.  Each product of two bf16 values is exact
    in f32, so a fused multiply-add rounds as the separate add does."""
    n = max(a.shape[-1], b.shape[-1])
    if n == 1:
        return (a * b)[..., 0]
    h = 1 << ((n - 1).bit_length() - 1)     # half the padded width
    t = a[..., :h] * b[..., :h]
    if n > h:
        t[..., :n - h].addcmul_(a[..., h:], b[..., h:])
    return fixed_sum(t)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) in its own formula."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


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


def flash_attention(q, k, v, *, prefix_len: int = 0, chunk: int = KV_CHUNK):
    """Causal streaming-softmax attention over KV chunks (the reference's
    algorithm, queries and keys from the same positions); keys at
    positions < ``prefix_len`` are visible to every query (PaliGemma's
    bidirectional prefix).  q: (B, Tq, H, hd); k, v: (B, S, KV, hd)."""
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
        visible = (k_pos <= q_pos) | (k_pos < prefix_len)
        scores = torch.where(visible[None, None], scores, -inf)
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


def decode_attention(q, k_cache, v_cache, lengths=None):
    """Single-token decode: q (B, 1, H, hd) over caches (B, S, KV, hd);
    ``lengths`` (B,) valid entries per sequence (None: all S, as whisper's
    cross attention over the encoder memory).

    Every sum is a fixed-order sum of exact elementwise products (the
    scores over hd, the softmax denominator and P.V over S:
    :func:`fixed_dot` / :func:`fixed_sum` within a chunk of
    ``DECODE_CHUNK`` positions, the chunks added in order), so a row's
    bits do not depend on the batch around it: a library's batched
    product picks its kernel, and with it its summation order, by the
    batch's shape (on the card PaliGemma's single KV head gave a row
    other bits at batch 1 than at batch 4)."""
    b, _, h, hd = q.shape
    s_len, kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kv, h // kv, 1, hd).float()
    chunks = range(0, s_len, DECODE_CHUNK)
    parts = [fixed_dot(qg, k_cache[:, lo:lo + DECODE_CHUNK]
                       .permute(0, 2, 1, 3)[:, :, None]) for lo in chunks]
    scores = (parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)) \
        * (1.0 / math.sqrt(hd))                           # (B, KV, g, S)
    if lengths is not None:
        k_pos = torch.arange(s_len, device=q.device)
        scores = torch.where(k_pos < lengths[:, None, None, None], scores,
                             -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = out = None
    for lo in chunks:
        part = fixed_sum(p[..., lo:lo + DECODE_CHUNK])
        denom = part if denom is None else denom + part
    probs = (p / denom[..., None]).to(ACT_DTYPE).float()
    for lo in chunks:
        vc = v_cache[:, lo:lo + DECODE_CHUNK].permute(0, 2, 3, 1)
        part = fixed_dot(probs[..., None, lo:lo + DECODE_CHUNK],
                         vc[:, :, None])                  # (B, KV, g, hd)
        out = part if out is None else out + part
    return out.reshape(b, 1, h, hd)


def attention_block(p, x, s: AttnParamsShape, positions, theta, *,
                    prefix_len: int = 0, chunk=KV_CHUNK):
    """Full-sequence causal self attention (prefill), the first
    ``prefix_len`` positions visible to all (``prefix_len = T``: the
    reference's ``causal=False``, whisper's bidirectional encoder).
    Returns (out, (k, v))."""
    q, k, v = _project_qkv(p, x, s, positions, theta)
    out = flash_attention(q, k, v, prefix_len=prefix_len, chunk=chunk)
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
# cross attention (whisper decoder)
# ---------------------------------------------------------------------------

def init_cross_attention(n_layers: int, s: AttnParamsShape, gen, device):
    """Stacked (L, ...) cross-attention projections."""
    hq, hkv = s.n_heads * s.head_dim, s.n_kv_heads * s.head_dim
    return {
        "wq": dense_init((n_layers, s.d_model, hq), gen, device),
        "wk": dense_init((n_layers, s.d_model, hkv), gen, device),
        "wv": dense_init((n_layers, s.d_model, hkv), gen, device),
        "wo": dense_init((n_layers, hq, s.d_model), gen, device),
    }


def cross_memory(p, enc_out, s: AttnParamsShape):
    """The encoder-side K/V of one layer, computed once per sequence."""
    b, t, _ = enc_out.shape
    k = weight_matmul(p["wk"], enc_out).reshape(b, t, s.n_kv_heads,
                                                s.head_dim)
    v = weight_matmul(p["wv"], enc_out).reshape(b, t, s.n_kv_heads,
                                                s.head_dim)
    return k.to(ACT_DTYPE), v.to(ACT_DTYPE)


def cross_attention_block(p, x, memory_kv, s: AttnParamsShape, *,
                          decode: bool = False):
    """x (B, T, D) queries over the precomputed encoder memory (k, v),
    every memory position visible.  ``decode`` (T = 1) sums in the fixed
    pairwise order of :func:`decode_attention`, so a row's bits do not
    depend on the batch; the prompt runs :func:`flash_attention` with the
    whole memory as its visible prefix.  Either way the output is cast to
    bf16 before ``wo``, as the reference's flash attention returns it."""
    b, t, _ = x.shape
    k, v = memory_kv
    q = weight_matmul(p["wq"], x).reshape(b, t, s.n_heads, s.head_dim)
    q = q.to(ACT_DTYPE)
    if decode:
        out = decode_attention(q, k, v).to(ACT_DTYPE)
    else:
        out = flash_attention(q, k, v, prefix_len=k.shape[1])
    out = weight_matmul(p["wo"], out.reshape(b, t, -1))
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# gated MLP, embeddings, head, loss
# ---------------------------------------------------------------------------

def init_mlp(n_layers: int, d_model: int, d_ff: int, gen, device):
    return {
        "w_gate": dense_init((n_layers, d_model, d_ff), gen, device),
        "w_up": dense_init((n_layers, d_model, d_ff), gen, device),
        "w_down": dense_init((n_layers, d_ff, d_model), gen, device),
    }


def mlp_block(p, x, activation: str = "silu"):
    """Gated MLP: SwiGLU, or whisper's GELU gate in the tanh approximation
    (``jax.nn.gelu``'s default, which ``F.gelu`` needs asked for)."""
    g = weight_matmul(p["w_gate"], x)
    u = weight_matmul(p["w_up"], x)
    act = F.silu(g) if activation == "silu" else F.gelu(g, approximate="tanh")
    h = (act * u).to(ACT_DTYPE)
    return weight_matmul(p["w_down"], h).to(x.dtype)


class _EmbedLookup(torch.autograd.Function):
    """``embedding[tokens]`` whose backward is deterministic: the rows'
    gradients are accumulated in f32 by ``index_put_(accumulate=True)``
    under ``torch.use_deterministic_algorithms`` (scoped to that call),
    which on CUDA sorts the indices and sums each row's contributions in
    a fixed order instead of adding them with atomics; on the CPU it is
    a serial loop.  A resumed training run then gives the same bits as an
    uninterrupted one."""

    @staticmethod
    def forward(ctx, embedding, tokens):
        ctx.save_for_backward(tokens)
        ctx.shape, ctx.dtype = embedding.shape, embedding.dtype
        return embedding[tokens]

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        grad_embed = torch.zeros(ctx.shape, dtype=torch.float32,
                                 device=grad.device)
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            grad_embed.index_put_((tokens.reshape(-1),),
                                  grad.reshape(-1, ctx.shape[-1]).float(),
                                  accumulate=True)
        finally:
            torch.use_deterministic_algorithms(was)
        return grad_embed.to(ctx.dtype), None


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor):
    if torch.is_grad_enabled() and embedding.requires_grad:
        return _EmbedLookup.apply(embedding, tokens).to(ACT_DTYPE)
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


def cross_entropy(logits, targets, mask=None):
    """Mean next-token NLL in f32. logits (B, T, V), targets (B, T) int;
    with ``mask`` the mean over the masked-in positions."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
