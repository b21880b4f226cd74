"""Decoder-only LM, dense and MoE families (port of those paths of
``repro/models/lm.py``): init, prefill and one-token decode, and the
serving engine's decode step over fixed buffers (:func:`decode_step`).

Parameters are a nested dict with the reference's layout: ``embed``,
``period`` (a list with one dict per program position whose leaves are
stacked over layers), ``final_norm`` and, untied, ``head``.  Weight
handles (``runtime/weights.py``) may replace leaves; the layer loop is a
Python loop that takes layer ``i`` of every stacked leaf.  When
``cfg.overlap`` allows it and the period holds streamed weights, the loop
runs as the decode-prefetch pipeline of ``runtime/overlap.py`` (layer
i+1's batched decode issued before layer i's compute, on a side stream on
the card); the logits are bitwise equal either way.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.runtime.overlap import (build_schedule, overlap_enabled,
                                         pipeline_unrolled)
from repro_torch.runtime.weights import is_handle
from repro_torch.runtime.weights import resolve as resolve_weights

from . import moe as moe_lib
from .layers import (ACT_DTYPE, AttnParamsShape, attention_block,
                     attention_decode_block, dense_init, embed_init,
                     embed_tokens, init_attention, init_mlp, lm_logits,
                     mlp_block, rms_norm)


class BlockDesc(NamedTuple):
    seq: str               # attn
    ffn: Optional[str]     # mlp | moe


def block_program(cfg) -> list:
    """cfg -> list[BlockDesc] (one period); the dense and MoE families."""
    if cfg.family == "dense":
        return [BlockDesc("attn", "mlp")]
    if cfg.family == "moe":
        return [BlockDesc("attn", "moe")]
    raise ValueError(f"{cfg.name}: family {cfg.family!r} is not ported yet")


def attn_shape(cfg) -> AttnParamsShape:
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    return AttnParamsShape(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd,
                           cfg.qk_norm)


def param_shapes(cfg) -> dict:
    """The parameter tree's leaf shapes, keyed by path ("period/0/attn/wq");
    the layout :func:`init_params` builds."""
    program = block_program(cfg)
    n, d, s = cfg.n_layers // len(program), cfg.d_model, attn_shape(cfg)
    hq, hkv = s.n_heads * s.head_dim, s.n_kv_heads * s.head_dim
    shapes = {"embed": (cfg.vocab_size, d), "final_norm": (d,)}
    for pos, desc in enumerate(program):
        pre = f"period/{pos}"
        shapes.update({
            f"{pre}/pre_norm": (n, d), f"{pre}/post_norm": (n, d),
            f"{pre}/attn/wq": (n, d, hq), f"{pre}/attn/wk": (n, d, hkv),
            f"{pre}/attn/wv": (n, d, hkv), f"{pre}/attn/wo": (n, hq, d)})
        if desc.ffn == "mlp":
            shapes.update({f"{pre}/mlp/w_gate": (n, d, cfg.d_ff),
                           f"{pre}/mlp/w_up": (n, d, cfg.d_ff),
                           f"{pre}/mlp/w_down": (n, cfg.d_ff, d)})
        else:
            e, f = cfg.n_experts, cfg.moe_d_ff
            shapes.update({f"{pre}/moe/router": (n, d, e),
                           f"{pre}/moe/e_gate": (n, e, d, f),
                           f"{pre}/moe/e_up": (n, e, d, f),
                           f"{pre}/moe/e_down": (n, e, f, d)})
        if s.qk_norm:
            shapes.update({f"{pre}/attn/q_norm": (n, s.head_dim),
                           f"{pre}/attn/k_norm": (n, s.head_dim)})
    if not cfg.tie_embeddings:
        shapes["head"] = (d, cfg.vocab_size)
    return shapes


def param_dtype(path: str) -> torch.dtype:
    """A leaf's dtype: the MoE router is f32, every other leaf bf16."""
    return torch.float32 if path.endswith("/router") else ACT_DTYPE


def abstract_params(cfg) -> dict:
    """The parameter tree of :func:`init_params` as ``meta`` tensors:
    shapes and dtypes with nothing allocated (what a restore fills)."""
    tree: dict = {}
    for path, shape in param_shapes(cfg).items():
        node, keys = tree, path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(shape, dtype=param_dtype(path),
                                     device="meta")
    tree["period"] = [tree["period"][str(i)]
                      for i in range(len(tree["period"]))]
    return tree


def init_params(cfg, *, seed: int = 0, device="cuda"):
    """Seeded synthetic weights with the reference's distributions, made
    on ``device`` by a ``torch.Generator`` (the numbers differ from the
    reference's ``jax.random`` streams; tests carry JAX weights over with
    ``convert.params_from_jax`` instead)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    program = block_program(cfg)
    n_periods = cfg.n_layers // len(program)
    zeros = lambda *shape: torch.zeros(shape, dtype=ACT_DTYPE, device=dev)  # noqa: E731
    period = []
    for desc in program:
        p = {"pre_norm": zeros(n_periods, cfg.d_model),
             "attn": init_attention(n_periods, attn_shape(cfg), gen, dev),
             "post_norm": zeros(n_periods, cfg.d_model)}
        if desc.ffn == "mlp":
            p["mlp"] = init_mlp(n_periods, cfg.d_model, cfg.d_ff, gen, dev)
        else:
            p["moe"] = moe_lib.init_moe(n_periods, cfg.d_model, cfg.moe_d_ff,
                                        cfg.n_experts, gen, dev)
        period.append(p)
    params = {"embed": embed_init((cfg.vocab_size, cfg.d_model), gen, dev),
              "period": period, "final_norm": zeros(cfg.d_model)}
    if not cfg.tie_embeddings:
        params["head"] = dense_init((cfg.d_model, cfg.vocab_size), gen, dev)
    return params


def layer_slice(tree, i: int):
    """Layer ``i`` of every stacked tensor / handle in a period subtree."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree.layer(i) if is_handle(tree) else tree[i]


def _dense_leaf(leaf):
    """Materialize a top-level weight handle (embed / head)."""
    return leaf.materialize() if is_handle(leaf) else leaf


def _ffn(p, cfg, h):
    """The block's FFN on the normed ``h``: the gated MLP or the MoE
    (its aux losses are the trainer's; serving drops them)."""
    if "mlp" in p:
        return mlp_block(p["mlp"], h)
    out, _ = moe_lib.moe_block(p["moe"], h, cfg.experts_per_token,
                               cfg.moe_combine_dtype, cfg.moe_dispatch_a2a)
    return out


def _apply_position(p, cfg, x, positions):
    """Full-sequence forward of one attn + mlp/moe block -> (x, K/V)."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    out, kv = attention_block(p["attn"], h, attn_shape(cfg), positions,
                              cfg.rope_theta, chunk=cfg.attn_chunk)
    x = x + out
    x = x + _ffn(p, cfg, rms_norm(x, p["post_norm"], cfg.norm_eps))
    return x, {"k": kv[0], "v": kv[1]}


def _apply_position_step(p, cfg, x, cache, lengths):
    """One-token decode of one attn + mlp/moe block -> (x, K/V)."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    out, kv = attention_decode_block(p["attn"], h, attn_shape(cfg),
                                     (cache["k"], cache["v"]), lengths,
                                     cfg.rope_theta)
    x = x + out
    x = x + _ffn(p, cfg, rms_norm(x, p["post_norm"], cfg.norm_eps))
    return x, {"k": kv[0], "v": kv[1]}


def _head(params, cfg, embed):
    """The (D, V) head, in whatever layout the weight mode gives it (a
    stream handle materializes an untied head as a transposed view; the
    tied head is ``embed.T``): ``lm_logits``' canonical tiled matmul gives
    each layout the same bits, so no mode copies the head."""
    if cfg.tie_embeddings:
        return embed.T
    return _dense_leaf(params["head"])


def _run_layers(params, cfg, x, apply_position, extra=None):
    """Every period over ``x``: ``apply_position(p, x, pos, extra_i) ->
    (x, y)`` runs one resolved program position of layer i (``extra_i``:
    layer i of ``extra``, a pytree of leading-(P,) tensors).  Returns x
    and, per layer, the list of each position's y.  Serial, or the
    prefetch pipeline when ``cfg.overlap`` enables it for this period."""
    n_positions = len(block_program(cfg))
    n_periods = cfg.n_layers // n_positions
    period = params["period"]

    def run_period(x, sliced, extra_i):
        ys = []
        for pos in range(n_positions):
            x, y = apply_position(sliced[pos], x, pos, extra_i)
            ys.append(y)
        return x, ys

    if overlap_enabled(getattr(cfg, "overlap", "auto"), period):
        schedule = build_schedule(period, n_periods)
        return pipeline_unrolled(
            schedule, lambda x, sliced, extra_i, _i: run_period(
                x, sliced, extra_i), x, xs_extra=extra)
    ys = []
    for i in range(n_periods):
        sliced = [resolve_weights(layer_slice(p, i)) for p in period]
        extra_i = None if extra is None else [
            {k: e[k][i] for k in e} for e in extra]
        x, y = run_period(x, sliced, extra_i)
        ys.append(y)
    return x, ys


def forward(params, cfg, tokens: torch.Tensor):
    """Prompt forward. Returns (normed x, per-position stacked K/V, head)."""
    program = block_program(cfg)
    embed = _dense_leaf(params["embed"])
    x = embed_tokens(embed, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, kvs = _run_layers(
        params, cfg, x,
        lambda p, x, pos, _: _apply_position(p, cfg, x, positions))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    caches = [{k: torch.stack([layer[pos][k] for layer in kvs])
               for k in ("k", "v")} for pos in range(len(program))]
    return x, caches, _head(params, cfg, embed)


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    program = block_program(cfg)
    n_periods = cfg.n_layers // len(program)
    s = attn_shape(cfg)
    dev = resolve_device(device)
    shape = (n_periods, batch, max_len, s.n_kv_heads, s.head_dim)
    entries = [{"k": torch.zeros(shape, dtype=ACT_DTYPE, device=dev),
                "v": torch.zeros(shape, dtype=ACT_DTYPE, device=dev)}
               for _ in program]
    return {"entries": entries,
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill_fn(params, cfg, batch: dict, max_len: int):
    """Run the prompt, build the cache. Returns (last_token_logits, cache)."""
    tokens = batch["tokens"]
    x, caches, head = forward(params, cfg, tokens)
    b, t = x.shape[0], x.shape[1]
    logits = lm_logits(x[:, -1:], head)[:, 0]
    cache = init_cache(cfg, b, max_len, device=x.device)
    for entry, got in zip(cache["entries"], caches):
        entry["k"][:, :, :t] = got["k"].to(ACT_DTYPE)
        entry["v"][:, :, :t] = got["v"].to(ACT_DTYPE)
    cache["lengths"] = torch.full((b,), t, dtype=torch.int32,
                                  device=x.device)
    return logits, cache


def decode_fn(params, cfg, cache, tokens: torch.Tensor):
    """One decode step. tokens: (B,) int. Returns (logits (B, V), cache);
    the cache's K/V tensors are updated in place."""
    embed = _dense_leaf(params["embed"])
    x = embed_tokens(embed, tokens[:, None])
    lengths = cache["lengths"].to(torch.int64)
    x, _ = _run_layers(
        params, cfg, x,
        lambda p, x, pos, entries: _apply_position_step(
            p, cfg, x, entries[pos], lengths),
        extra=cache["entries"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(x, _head(params, cfg, embed))[:, 0]
    return logits, dict(cache, lengths=cache["lengths"] + 1)


def init_step_state(cfg, slots: int, max_len: int, device="cuda"):
    """The buffers of :func:`decode_step`, allocated once: the KV ring of
    ``slots`` slots (``init_cache``), each slot's last token (int64) and
    the step's f32 logits."""
    state = init_cache(cfg, slots, max_len, device=device)
    dev = state["lengths"].device
    state["tokens"] = torch.zeros((slots,), dtype=torch.int64, device=dev)
    state["logits"] = torch.zeros((slots, cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
    return state


def decode_step(params, cfg, state, bucket: int) -> None:
    """One decode step over the slots ``[0, bucket)`` of
    :func:`init_step_state`'s buffers, in place: :func:`decode_fn` on a
    view of the ring (it writes each row's K/V at its length), then the
    step's logits, each row's greedy token and its length + 1 are copied
    into the buffers.  Nothing it allocates outlives it, so a CUDA graph
    of it (``runtime/captured.py``) replays on fixed addresses; its bits
    are :func:`decode_fn`'s on the same rows."""
    sub = {"entries": [{k: e[k][:, :bucket] for k in ("k", "v")}
                       for e in state["entries"]],
           "lengths": state["lengths"][:bucket]}
    logits, _ = decode_fn(params, cfg, sub, state["tokens"][:bucket])
    state["logits"][:bucket].copy_(logits)
    state["tokens"][:bucket].copy_(torch.argmax(logits, dim=-1))
    state["lengths"][:bucket].add_(1)
