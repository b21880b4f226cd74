"""Encoder-decoder backbone, whisper-tiny (port of
``repro/models/encdec.py``).  The conv audio frontend is a stub, as in the
reference: the encoder takes precomputed frame embeddings (B, T_a, D).
The encoder is bidirectional self attention + GELU MLP; the decoder is
causal self attention, cross attention over the encoder output and a GELU
MLP.

Parameters have the reference's layout: ``enc_stack`` and ``dec_stack``
(each leaf stacked over layers), ``embed``, ``enc_norm``, ``final_norm``
and an untied ``head``.  Weight handles (``runtime/weights.py``) may
replace leaves: each layer's slice is resolved just before it runs, and
every projection goes through ``layers.weight_matmul``'s canonical tiled
matmul, so dense / stream / fused give the same bits.

Serving is a one-shot prefill of ``{"frames", "tokens"}`` (encoder pass,
the decoder's prompt pass, the self-attention K/V and the cross-attention
memory ``mem_k`` / ``mem_v`` into the cache) followed by one-token decode
steps; :func:`decode_step` is the same step on fixed buffers, in place,
for ``runtime/captured.py`` to replay as a CUDA graph.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.runtime.weights import resolve as resolve_weights

from .layers import (ACT_DTYPE, attention_block, attention_decode_block,
                     cross_attention_block, cross_entropy, cross_memory,
                     dense_init, embed_init, embed_tokens, init_attention,
                     init_cross_attention, init_mlp, lm_logits, mlp_block,
                     rms_norm)
from .lm import _dense_leaf, attn_shape, layer_slice

ENC_LEN = 4096      # encoder frames of a serving cache (ENC_FRAMES_STUB)


def param_shapes(cfg) -> dict:
    """Leaf path -> shape of the tree :func:`init_params` builds."""
    s = attn_shape(cfg)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv = s.n_heads * s.head_dim, s.n_kv_heads * s.head_dim
    proj = {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d)}
    mlp = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    layer = {"enc_stack": ("pre_norm", "attn", "post_norm", "mlp"),
             "dec_stack": ("pre_norm", "attn", "xnorm", "xattn",
                           "post_norm", "mlp")}
    shapes = {"embed": (v, d), "enc_norm": (d,), "final_norm": (d,),
              "head": (d, v)}
    for stack, parts in layer.items():
        n = cfg.encoder_layers if stack == "enc_stack" else cfg.n_layers
        for part in parts:
            sub = {"mlp": mlp, "attn": proj, "xattn": proj}.get(part)
            if sub is None:
                shapes[f"{stack}/{part}"] = (n, d)
            else:
                for k, shape in sub.items():
                    shapes[f"{stack}/{part}/{k}"] = (n,) + shape
    return shapes


def abstract_params(cfg) -> dict:
    """The tree of :func:`init_params` as ``meta`` tensors (every leaf
    bf16)."""
    tree: dict = {}
    for path, shape in param_shapes(cfg).items():
        node, keys = tree, path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(shape, dtype=ACT_DTYPE, device="meta")
    return tree


def init_params(cfg, *, seed: int = 0, device="cuda"):
    """Seeded synthetic weights with the reference's distributions, made
    on ``device`` by a ``torch.Generator`` (the numbers differ from the
    reference's ``jax.random`` streams)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = attn_shape(cfg)
    d = cfg.d_model
    zeros = lambda *shape: torch.zeros(shape, dtype=ACT_DTYPE, device=dev)  # noqa: E731
    n_enc, n_dec = cfg.encoder_layers, cfg.n_layers
    enc = {"pre_norm": zeros(n_enc, d),
           "attn": init_attention(n_enc, s, gen, dev),
           "post_norm": zeros(n_enc, d),
           "mlp": init_mlp(n_enc, d, cfg.d_ff, gen, dev)}
    dec = {"pre_norm": zeros(n_dec, d),
           "attn": init_attention(n_dec, s, gen, dev),
           "xnorm": zeros(n_dec, d),
           "xattn": init_cross_attention(n_dec, s, gen, dev),
           "post_norm": zeros(n_dec, d),
           "mlp": init_mlp(n_dec, d, cfg.d_ff, gen, dev)}
    return {"enc_stack": enc, "dec_stack": dec,
            "embed": embed_init((cfg.vocab_size, d), gen, dev),
            "enc_norm": zeros(d), "final_norm": zeros(d),
            "head": dense_init((d, cfg.vocab_size), gen, dev)}


def _layer(params, stack: str, i: int):
    """Layer ``i`` of a stack, its weight handles resolved."""
    return resolve_weights(layer_slice(params[stack], i))


def _enc_layer_fwd(p, cfg, x, positions):
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    # every position visible to every query: the reference's causal=False
    out, _ = attention_block(p["attn"], h, attn_shape(cfg), positions,
                             cfg.rope_theta, prefix_len=x.shape[1])
    x = x + out
    return x + mlp_block(p["mlp"], rms_norm(x, p["post_norm"], cfg.norm_eps),
                         activation="gelu")


def _dec_layer_fwd(p, cfg, x, memory_kv, positions):
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    out, kv = attention_block(p["attn"], h, attn_shape(cfg), positions,
                              cfg.rope_theta)
    x = x + out
    x = x + cross_attention_block(
        p["xattn"], rms_norm(x, p["xnorm"], cfg.norm_eps), memory_kv,
        attn_shape(cfg))
    x = x + mlp_block(p["mlp"], rms_norm(x, p["post_norm"], cfg.norm_eps),
                      activation="gelu")
    return x, kv


def encode(params, cfg, frames):
    """frames (B, T_a, D) precomputed embeddings -> encoder output."""
    x = frames.to(ACT_DTYPE)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(cfg.encoder_layers):
        x = _enc_layer_fwd(_layer(params, "enc_stack", i), cfg, x, positions)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def decode_train(params, cfg, enc_out, tokens):
    """Teacher-forced decoder forward -> f32 logits (B, T, V)."""
    x = embed_tokens(_dense_leaf(params["embed"]), tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    s = attn_shape(cfg)
    for i in range(cfg.n_layers):
        p = _layer(params, "dec_stack", i)
        x, _ = _dec_layer_fwd(p, cfg, x, cross_memory(p["xattn"], enc_out, s),
                              positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(x, _dense_leaf(params["head"]))


def loss_fn(params, cfg, batch):
    """Mean NLL of ``targets[:, 1:]`` under ``logits[:, :-1]`` (the
    reference's own shift) -> (loss, {"nll", "aux"})."""
    enc_out = encode(params, cfg, batch["frames"])
    logits = decode_train(params, cfg, enc_out, batch["tokens"])
    loss = cross_entropy(logits[:, :-1], batch["targets"][:, 1:])
    return loss, {"nll": loss, "aux": torch.zeros((), device=loss.device)}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, enc_len: int = ENC_LEN,
               device="cuda"):
    """Self-attention K/V rings (L, B, max_len, KV, hd), the encoder memory
    ``mem_k`` / ``mem_v`` (L, B, enc_len, KV, hd) and the lengths: zeros
    (``device="meta"`` gives the shapes with nothing allocated)."""
    s = attn_shape(cfg)
    dev = resolve_device(device)

    def z(t):
        return torch.zeros((cfg.n_layers, batch, t, s.n_kv_heads,
                            s.head_dim), dtype=ACT_DTYPE, device=dev)

    return {"k": z(max_len), "v": z(max_len), "mem_k": z(enc_len),
            "mem_v": z(enc_len),
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(params, cfg, frames, tokens, max_len: int):
    """Encoder pass + decoder prompt pass; builds the self and cross
    caches.  Returns (last-token logits (B, V), cache)."""
    enc_out = encode(params, cfg, frames)
    s = attn_shape(cfg)
    b, t = tokens.shape
    cache = init_cache(cfg, b, max_len, enc_out.shape[1],
                       device=enc_out.device)
    x = embed_tokens(_dense_leaf(params["embed"]), tokens)
    positions = torch.arange(t, device=x.device)[None, :]
    for i in range(cfg.n_layers):
        p = _layer(params, "dec_stack", i)
        memory = cross_memory(p["xattn"], enc_out, s)
        cache["mem_k"][i], cache["mem_v"][i] = memory
        x, kv = _dec_layer_fwd(p, cfg, x, memory, positions)
        cache["k"][i, :, :t], cache["v"][i, :, :t] = kv
    cache["lengths"] = torch.full((b,), t, dtype=torch.int32,
                                  device=x.device)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = _dense_leaf(params["head"])
    return lm_logits(x[:, -1:], head)[:, 0], cache


def decode_fn(params, cfg, cache, tokens: torch.Tensor):
    """One decoder token per row. tokens: (B,) int.  Returns (logits
    (B, V), cache); the self-attention K/V are written in place."""
    s = attn_shape(cfg)
    x = embed_tokens(_dense_leaf(params["embed"]), tokens[:, None])
    lengths = cache["lengths"].to(torch.int64)
    for i in range(cfg.n_layers):
        sl = layer_slice(params["dec_stack"], i)
        # the memory's K/V are in the cache: xattn's wk / wv are not read
        # (nor decoded, in stream mode)
        sl["xattn"] = {k: sl["xattn"][k] for k in ("wq", "wo")}
        p = resolve_weights(sl)
        h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
        out, _ = attention_decode_block(p["attn"], h, s,
                                        (cache["k"][i], cache["v"][i]),
                                        lengths, cfg.rope_theta)
        x = x + out
        x = x + cross_attention_block(
            p["xattn"], rms_norm(x, p["xnorm"], cfg.norm_eps),
            (cache["mem_k"][i], cache["mem_v"][i]), s, decode=True)
        x = x + mlp_block(p["mlp"], rms_norm(x, p["post_norm"], cfg.norm_eps),
                          activation="gelu")
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(x, _dense_leaf(params["head"]))[:, 0]
    return logits, dict(cache, lengths=cache["lengths"] + 1)


def init_step_state(cfg, slots: int, max_len: int, enc_len: int = ENC_LEN,
                    device="cuda"):
    """The buffers of :func:`decode_step`, allocated once: the cache of
    ``slots`` rows (:func:`init_cache`), each row's last token (int64)
    and the step's f32 logits."""
    state = init_cache(cfg, slots, max_len, enc_len, device=device)
    dev = state["lengths"].device
    state["tokens"] = torch.zeros((slots,), dtype=torch.int64, device=dev)
    state["logits"] = torch.zeros((slots, cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
    return state


def load_prefill(state, cache, row: int) -> None:
    """Copy a one-row prefill's cache into row ``row`` of the step
    buffers (its K/V at their positions, its whole encoder memory, its
    length); the memory length must equal the buffers'."""
    t = cache["k"].shape[2]
    for k in ("k", "v"):
        state[k][:, row, :t].copy_(cache[k][:, 0])
    for k in ("mem_k", "mem_v"):
        state[k][:, row].copy_(cache[k][:, 0])
    state["lengths"][row].copy_(cache["lengths"][0])


def decode_step(params, cfg, state, bucket: int) -> None:
    """One decode step over rows ``[0, bucket)`` of
    :func:`init_step_state`'s buffers, in place: :func:`decode_fn` on a
    view of them, then the logits, each row's greedy token and its length
    + 1 copied back.  Nothing it allocates outlives it, and it copies
    nothing from the host, so a CUDA graph of it replays on fixed
    addresses; its bits are :func:`decode_fn`'s on the same rows."""
    sub = {k: state[k][:, :bucket] for k in ("k", "v", "mem_k", "mem_v")}
    sub["lengths"] = state["lengths"][:bucket]
    logits, _ = decode_fn(params, cfg, sub, state["tokens"][:bucket])
    state["logits"][:bucket].copy_(logits)
    state["tokens"][:bucket].copy_(torch.argmax(logits, dim=-1))
    state["lengths"][:bucket].add_(1)
