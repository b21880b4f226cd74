"""Unified decoder-only LM (port of ``repro/models/lm.py``) covering the
dense, MoE, xLSTM, Jamba-hybrid and prefix-VLM families through per-period
block programs: init, prefill and one-token decode, and the serving
engine's decode step over fixed buffers (:func:`decode_step`), and the
training loss (:func:`loss_fn`, differentiated by autograd).

A *block program* is one period of per-layer descriptors; the model is
``n_layers // len(program)`` repetitions of it (xLSTM: period 4 = mLSTM x3
+ sLSTM; Jamba: period 8 = Mamba x7 with attention at position 4, MoE at
odd positions and MLP at even ones; dense, MoE and VLM: period 1).
Parameters are a nested dict with the reference's layout: ``embed``,
``period`` (a list with one dict per program position whose leaves are
stacked over periods), ``final_norm`` and, untied, ``head``.  Weight
handles (``runtime/weights.py``) may replace leaves; the layer loop is a
Python loop that takes layer ``i`` of every stacked leaf.  When
``cfg.overlap`` allows it, the period holds streamed weights and there is
more than one period, the loop runs as the decode-prefetch pipeline of
``runtime/overlap.py`` (period i+1's batched decode issued before period
i's compute, on a side stream on the card); the logits are bitwise equal
either way.

The decode cache holds, per program position, the attention K/V ring or
the recurrent state (Mamba ``h`` / ``conv``, mLSTM ``c`` / ``n`` / ``m``,
sLSTM ``c`` / ``n`` / ``h`` / ``m``), stacked over periods.  A decode step
updates every one of them in place, so the engine's step runs on fixed
buffers and replays as a CUDA graph.
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
from . import ssm as ssm_lib
from . import xlstm as xlstm_lib
from .layers import (ACT_DTYPE, AttnParamsShape, attention_block,
                     attention_decode_block, cross_entropy, dense_init,
                     embed_init, embed_tokens, init_attention, init_mlp,
                     lm_logits, mlp_block, rms_norm)


class BlockDesc(NamedTuple):
    seq: str               # attn | mamba | mlstm | slstm
    ffn: Optional[str]     # mlp | moe | None


def block_program(cfg) -> list:
    """cfg -> list[BlockDesc] (one period)."""
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return [BlockDesc("attn", "mlp")]
    if fam == "moe":
        return [BlockDesc("attn", "moe")]
    if fam == "ssm":      # xLSTM 3:1 mLSTM:sLSTM
        return [BlockDesc("mlstm", None), BlockDesc("mlstm", None),
                BlockDesc("mlstm", None), BlockDesc("slstm", None)]
    if fam == "hybrid":   # Jamba: attn 1-of-8, MoE every other layer
        return [BlockDesc("attn" if i == 4 else "mamba",
                          "moe" if i % 2 == 1 else "mlp") for i in range(8)]
    raise ValueError(f"{cfg.name}: family {fam!r} is not ported yet")


def attn_shape(cfg) -> AttnParamsShape:
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    return AttnParamsShape(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd,
                           cfg.qk_norm)


# leaves kept in f32 (every other leaf is bf16)
F32_LEAVES = frozenset({"router", "a_log", "d_skip", "wi", "wf"})


def _position_shapes(desc: BlockDesc, cfg) -> dict:
    """One layer of one program position: relative path -> (shape,
    dtype), the layout :func:`init_params` builds."""
    d, bf = cfg.d_model, ACT_DTYPE
    out = {"pre_norm": ((d,), bf)}
    if desc.seq == "attn":
        s = attn_shape(cfg)
        hq, hkv = s.n_heads * s.head_dim, s.n_kv_heads * s.head_dim
        out.update({"attn/wq": ((d, hq), bf), "attn/wk": ((d, hkv), bf),
                    "attn/wv": ((d, hkv), bf), "attn/wo": ((hq, d), bf)})
        if s.qk_norm:
            out.update({"attn/q_norm": ((s.head_dim,), bf),
                        "attn/k_norm": ((s.head_dim,), bf)})
    else:
        leaves = {"mamba": lambda: ssm_lib.mamba_shapes(
                      d, cfg.ssm_state, cfg.conv_dim),
                  "mlstm": lambda: xlstm_lib.mlstm_shapes(d, cfg.n_heads),
                  "slstm": lambda: xlstm_lib.slstm_shapes(d)}[desc.seq]()
        out.update({f"{desc.seq}/{k}": v for k, v in leaves.items()})
    if desc.ffn is not None:
        out["post_norm"] = ((d,), bf)
    if desc.ffn == "mlp":
        f = cfg.d_ff
        out.update({"mlp/w_gate": ((d, f), bf), "mlp/w_up": ((d, f), bf),
                    "mlp/w_down": ((f, d), bf)})
    elif desc.ffn == "moe":
        e, f = cfg.n_experts, cfg.moe_d_ff
        out.update({"moe/router": ((d, e), torch.float32),
                    "moe/e_gate": ((e, d, f), bf),
                    "moe/e_up": ((e, d, f), bf),
                    "moe/e_down": ((e, f, d), bf)})
    return out


def param_shapes(cfg) -> dict:
    """The parameter tree's leaf shapes, keyed by path ("period/0/attn/wq");
    the layout :func:`init_params` builds."""
    program = block_program(cfg)
    n, d = cfg.n_layers // len(program), cfg.d_model
    shapes = {"embed": (cfg.vocab_size, d), "final_norm": (d,)}
    for pos, desc in enumerate(program):
        for rel, (shape, _) in _position_shapes(desc, cfg).items():
            shapes[f"period/{pos}/{rel}"] = (n,) + shape
    if not cfg.tie_embeddings:
        shapes["head"] = (d, cfg.vocab_size)
    return shapes


def param_dtype(path: str) -> torch.dtype:
    """A leaf's dtype: the MoE router, Mamba's ``a_log`` / ``d_skip`` and
    mLSTM's gate projections ``wi`` / ``wf`` are f32, every other leaf
    bf16."""
    return torch.float32 if path.rsplit("/", 1)[-1] in F32_LEAVES \
        else ACT_DTYPE


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
    n = cfg.n_layers // len(program)
    d = cfg.d_model
    zeros = lambda *shape: torch.zeros(shape, dtype=ACT_DTYPE, device=dev)  # noqa: E731
    period = []
    for desc in program:
        p = {"pre_norm": zeros(n, d)}
        if desc.seq == "attn":
            p["attn"] = init_attention(n, attn_shape(cfg), gen, dev)
        elif desc.seq == "mamba":
            p["mamba"] = ssm_lib.init_mamba(n, d, cfg.ssm_state,
                                            cfg.conv_dim, gen, dev)
        elif desc.seq == "mlstm":
            p["mlstm"] = xlstm_lib.init_mlstm(n, d, cfg.n_heads, gen, dev)
        else:
            p["slstm"] = xlstm_lib.init_slstm(n, d, gen, dev)
        if desc.ffn is not None:
            p["post_norm"] = zeros(n, d)
        if desc.ffn == "mlp":
            p["mlp"] = init_mlp(n, d, cfg.d_ff, gen, dev)
        elif desc.ffn == "moe":
            p["moe"] = moe_lib.init_moe(n, d, cfg.moe_d_ff, cfg.n_experts,
                                        gen, dev)
        period.append(p)
    params = {"embed": embed_init((cfg.vocab_size, d), gen, dev),
              "period": period, "final_norm": zeros(d)}
    if not cfg.tie_embeddings:
        params["head"] = dense_init((d, cfg.vocab_size), gen, dev)
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
    """The block's FFN on the normed ``h`` -> (out, aux): the gated MLP
    (aux None) or the MoE (aux its ``lb_loss + 1e-3 * z_loss``, the
    trainer's; serving drops it)."""
    if "mlp" in p:
        return mlp_block(p["mlp"], h), None
    out, aux = moe_lib.moe_block(p["moe"], h, cfg.experts_per_token,
                                 cfg.moe_combine_dtype, cfg.moe_dispatch_a2a)
    return out, aux["lb_loss"] + 1e-3 * aux["z_loss"]


def _apply_position(p, desc: BlockDesc, cfg, x, positions,
                    prefix_len: int = 0):
    """Full-sequence forward of one block -> (x, its cache entry: the
    attention K/V or the final recurrent state, its FFN's aux or None)."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if desc.seq == "attn":
        out, kv = attention_block(p["attn"], h, attn_shape(cfg), positions,
                                  cfg.rope_theta, prefix_len=prefix_len,
                                  chunk=cfg.attn_chunk)
        entry = {"k": kv[0], "v": kv[1]}
    elif desc.seq == "mamba":
        out, entry = ssm_lib.mamba_forward(p["mamba"], h, cfg.ssm_state,
                                           cfg.conv_dim)
    elif desc.seq == "mlstm":
        out, entry = xlstm_lib.mlstm_forward(p["mlstm"], h, cfg.n_heads)
    else:
        out, entry = xlstm_lib.slstm_forward(p["slstm"], h)
    x = x + out
    aux = None
    if desc.ffn is not None:
        out, aux = _ffn(p, cfg, rms_norm(x, p["post_norm"], cfg.norm_eps))
        x = x + out
    return x, entry, aux


def _apply_position_step(p, desc: BlockDesc, cfg, x, cache, lengths):
    """One-token decode of one block; its cache entry (one layer's view of
    the K/V ring or of the recurrent state) is updated in place."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if desc.seq == "attn":     # writes the new K/V at ``lengths`` itself
        out, _ = attention_decode_block(p["attn"], h, attn_shape(cfg),
                                        (cache["k"], cache["v"]), lengths,
                                        cfg.rope_theta)
    else:
        if desc.seq == "mamba":
            out, new = ssm_lib.mamba_step(p["mamba"], h, cache,
                                          cfg.ssm_state)
        elif desc.seq == "mlstm":
            out, new = xlstm_lib.mlstm_step(p["mlstm"], h, cache,
                                            cfg.n_heads)
        else:
            out, new = xlstm_lib.slstm_step(p["slstm"], h, cache)
        for k, v in new.items():   # never a view of the old state
            cache[k].copy_(v)
    x = x + out
    if desc.ffn is not None:
        x = x + _ffn(p, cfg, rms_norm(x, p["post_norm"], cfg.norm_eps))[0]
    return x


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

    def run_period(x, sliced, extra_i, resolve=False):
        ys = []
        for pos in range(n_positions):
            p = resolve_weights(sliced[pos]) if resolve else sliced[pos]
            x, y = apply_position(p, x, pos, extra_i)
            ys.append(y)
        return x, ys

    if overlap_enabled(getattr(cfg, "overlap", "auto"), period, n_periods):
        schedule = build_schedule(period, n_periods)
        return pipeline_unrolled(
            schedule, lambda x, sliced, extra_i, _i: run_period(
                x, sliced, extra_i), x, xs_extra=extra)
    ys = []
    for i in range(n_periods):
        # each position's weights resolved just before it runs, as the
        # reference's period body does: one position decoded at a time
        sliced = [layer_slice(p, i) for p in period]
        extra_i = None if extra is None else [
            {k: e[k][i] for k in e} for e in extra]
        x, y = run_period(x, sliced, extra_i, resolve=True)
        ys.append(y)
    return x, ys


def _assemble_inputs(params, cfg, batch: dict):
    """tokens (+ the optional prefix embeddings, a bidirectional prefix)
    -> (x, positions, prefix_len)."""
    embed = _dense_leaf(params["embed"])
    x = embed_tokens(embed, batch["tokens"])
    prefix_len = 0
    if cfg.prefix_embed and "prefix_embeds" in batch:
        pe = batch["prefix_embeds"].to(ACT_DTYPE)
        x = torch.cat([pe, x], dim=1)
        prefix_len = pe.shape[1]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return embed, x, positions, prefix_len


def _forward(params, cfg, batch: dict):
    """Prompt forward -> (normed x, per layer the list of each position's
    (cache entry, aux), head, prefix_len)."""
    program = block_program(cfg)
    embed, x, positions, prefix_len = _assemble_inputs(params, cfg, batch)

    def apply(p, x, pos, _):
        x, entry, aux = _apply_position(p, program[pos], cfg, x, positions,
                                        prefix_len)
        return x, (entry, aux)

    x, ys = _run_layers(params, cfg, x, apply)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, ys, _head(params, cfg, embed), prefix_len


def forward(params, cfg, batch: dict):
    """Prompt forward. Returns (normed x, each position's cache entries
    stacked over periods, head, prefix_len)."""
    x, ys, head, prefix_len = _forward(params, cfg, batch)
    caches = [{k: torch.stack([layer[pos][0][k] for layer in ys])
               for k in ys[0][pos][0]} for pos in range(len(ys[0]))]
    return x, caches, head, prefix_len


def loss_fn(params, cfg, batch: dict):
    """Mean NLL of ``targets[:, 1:]`` under the text positions'
    ``logits[:, :-1]`` (the reference's own shift; ``loss_mask`` masks
    positions) plus ``1e-2 *`` the MoE blocks' aux losses (summed in each
    period in position order, then over periods, as the reference sums
    them) -> (total, {"nll", "aux"})."""
    x, ys, head, prefix_len = _forward(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in ys:
        period = torch.zeros((), dtype=torch.float32, device=x.device)
        for _, a in layer:
            if a is not None:
                period = period + a
        aux = aux + period
    logits = lm_logits(x[:, prefix_len:], head)
    mask = batch.get("loss_mask")
    loss = cross_entropy(logits[:, :-1], batch["targets"][:, 1:],
                         None if mask is None else mask[:, 1:])
    return loss + 1e-2 * aux, {"nll": loss, "aux": aux}


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """The decode cache of ``batch`` rows, stacked over periods: zeros,
    and the stabilisers ``m`` of the xLSTM blocks at their initial -1e30
    (``device="meta"`` gives the shapes with nothing allocated)."""
    program = block_program(cfg)
    n_periods = cfg.n_layers // len(program)
    dev = resolve_device(device)
    entries = []
    for desc in program:
        if desc.seq == "attn":
            s = attn_shape(cfg)
            shape = (n_periods, batch, max_len, s.n_kv_heads, s.head_dim)
            entries.append({k: torch.zeros(shape, dtype=ACT_DTYPE,
                                           device=dev) for k in ("k", "v")})
            continue
        if desc.seq == "mamba":
            one = ssm_lib.init_mamba_cache(cfg.d_model, cfg.ssm_state,
                                           cfg.conv_dim, batch, dev)
        elif desc.seq == "mlstm":
            one = xlstm_lib.init_mlstm_cache(cfg.d_model, cfg.n_heads, batch,
                                             dev)
        else:
            one = xlstm_lib.init_slstm_cache(cfg.d_model, batch, dev)
        entries.append({k: v[None].repeat((n_periods,) + (1,) * v.ndim)
                        for k, v in one.items()})
    return {"entries": entries,
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill_fn(params, cfg, batch: dict, max_len: int):
    """Run the prompt (and its prefix embeddings), build the cache: the
    attention K/V into the ring's first positions, the recurrent states
    wholesale.  Returns (last_token_logits, cache)."""
    x, caches, head, _ = forward(params, cfg, batch)
    b, t = x.shape[0], x.shape[1]
    logits = lm_logits(x[:, -1:], head)[:, 0]
    cache = init_cache(cfg, b, max_len, device=x.device)
    for desc, entry, got in zip(block_program(cfg), cache["entries"],
                                caches):
        if desc.seq == "attn":
            for k in ("k", "v"):
                entry[k][:, :, :t] = got[k].to(ACT_DTYPE)
        else:
            for k in entry:
                entry[k].copy_(got[k].to(entry[k].dtype))
    cache["lengths"] = torch.full((b,), t, dtype=torch.int32,
                                  device=x.device)
    return logits, cache


def decode_fn(params, cfg, cache, tokens: torch.Tensor):
    """One decode step. tokens: (B,) int. Returns (logits (B, V), cache);
    the cache's tensors (K/V and recurrent states) are updated in place."""
    program = block_program(cfg)
    embed = _dense_leaf(params["embed"])
    x = embed_tokens(embed, tokens[:, None])
    lengths = cache["lengths"].to(torch.int64)
    x, _ = _run_layers(
        params, cfg, x,
        lambda p, x, pos, entries: (_apply_position_step(
            p, program[pos], cfg, x, entries[pos], lengths), None),
        extra=cache["entries"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(x, _head(params, cfg, embed))[:, 0]
    return logits, dict(cache, lengths=cache["lengths"] + 1)


def init_step_state(cfg, slots: int, max_len: int, device="cuda"):
    """The buffers of :func:`decode_step`, allocated once: the cache of
    ``slots`` slots (``init_cache``: K/V ring and recurrent states), each
    slot's last token (int64) and the step's f32 logits."""
    state = init_cache(cfg, slots, max_len, device=device)
    dev = state["lengths"].device
    state["tokens"] = torch.zeros((slots,), dtype=torch.int64, device=dev)
    state["logits"] = torch.zeros((slots, cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
    return state


def decode_step(params, cfg, state, bucket: int) -> None:
    """One decode step over the slots ``[0, bucket)`` of
    :func:`init_step_state`'s buffers, in place: :func:`decode_fn` on a
    view of the cache (it writes each row's K/V at its length and renews
    each row's recurrent state), then the step's logits, each row's greedy
    token and its length + 1 are copied into the buffers.  Nothing it allocates outlives it, so a CUDA graph
    of it (``runtime/captured.py``) replays on fixed addresses; its bits
    are :func:`decode_fn`'s on the same rows."""
    sub = {"entries": [{k: t[:, :bucket] for k, t in e.items()}
                       for e in state["entries"]],
           "lengths": state["lengths"][:bucket]}
    logits, _ = decode_fn(params, cfg, sub, state["tokens"][:bucket])
    state["logits"][:bucket].copy_(logits)
    state["tokens"][:bucket].copy_(torch.argmax(logits, dim=-1))
    state["lengths"][:bucket].add_(1)
