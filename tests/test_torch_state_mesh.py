"""The recurrent states and the encoder memory on the port's serving mesh
(``runtime/sharding.py:state_layout`` / ``memory_layout``,
``models/ssm.py:rank_mamba_step``, ``models/xlstm.py:rank_slstm_step``,
``layers.cross_attention_block`` over a sharded memory), against the
reference's rules, one device and the reference's greedy tokens.

  * ``port_cache_pspecs`` equal to the reference's ``cache_pspecs`` on
    every leaf of every smoke cache (Mamba's ``h`` by d_state and
    ``conv`` by channels, an sLSTM's ``h`` by D, whisper's ``mem_k`` /
    ``mem_v`` by sequence), except a K/V ring or memory that the
    1024-chunk rule keeps whole, its layout saying why;
  * in one process, A ranks on ``AbstractMesh`` coordinates, each in a
    thread whose gathers meet the others' (:class:`_Exchange`):
    ``mamba_step``'s rank blocks at A = 1, 2, 4, 8 assembled bitwise the
    whole step's ``h``, ``conv`` and output over several steps (at A = 8
    the smoke d_state 4 does not divide: ``conv`` shards, ``h`` stays
    whole), ``slstm_step``'s likewise (at A = 3 the smoke D 64 does not
    divide: ``h`` stays whole), and the cross attention's rank parts
    bitwise the whole memory's in both routes;
  * gloo worlds of 2 and 4 CPU ranks: jamba and xlstm smoke through
    ``serve.main --tp A`` and jamba / whisper / xlstm smoke through the
    mesh steps (``build_prefill_step`` / ``build_decode_step(mesh=)``, on
    (1, A) and, rows on "data", (2, 2)), every rank's logits bitwise one
    device's, greedy tokens the reference's (JAX on the CPU; the weights
    made by the reference and carried over by ``convert.params_from_
    jax``; xlstm's logits within its stated ulps of the reference's),
    each rank holding 1/A of ``h``, ``conv``, ``mem_k`` and ``mem_v``
    and gathering the layout's bytes a step;
  * the dry-run's jamba, whisper and xlstm serving cells holding 1/A of
    these leaves on rank 0, their program line saying so.

One module fixture makes the reference's weights and tokens, starts both
worlds (6 processes, one thread each) and makes the single-device runs
while they run.  The serve runs use 1024-element blocks (``serve.Codec``
patched, as ``tests/test_torch_mesh.py`` does) so the smoke leaves
stream and shard.  Whisper's frames are 2048 positions: a memory of
2 x 1024 on 2 model ranks.
"""
import contextlib
import functools
import io
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS

ROOT = Path(__file__).resolve().parents[1]
TIME_LIMIT_S = 240
BLOCK_ELEMS = 1024
JAMBA, WHISPER, XLSTM = "jamba_v0_1_52b", "whisper_tiny", "xlstm_125m"
MODES = ("dense", "stream", "fused")
# serve.main's requests
BATCH, PROMPT, TOKENS = 2, 12, 4
SERVE = ["--smoke", "--device", "cpu", "--batch", str(BATCH),
         "--prompt-len", str(PROMPT), "--tokens", str(TOKENS),
         "--min-bytes", "1024"]
# xlstm's logits against the reference's: bf16 ulps of the larger of 1
# and the reference's magnitude (tests/test_torch_families.py:LOGIT_ULPS)
LOGIT_ULP, XLSTM_ULPS = 2.0 ** -8, 4
# the mesh steps' requests (the reference's tokens): prompts of 8 tokens
# from numpy seed 1, three decode steps; whisper's frames from the same
# seed, 2048 of them
STEP_PROMPT, STEPS, FRAMES = 8, 3, 2048
MAX_LEN = STEP_PROMPT + STEPS + 1
# each world's runs: serve.main --arch --tp A in a mode; the mesh steps
# of an arch on a (data, model) grid
WORLD_SERVE = {2: [(a, 2, m) for a in (JAMBA, XLSTM) for m in MODES],
               4: [(JAMBA, 4, m) for m in MODES] + [(JAMBA, 2, "dense"),
                                                    (XLSTM, 4, "dense")]}
WORLD_STEPS = {2: [(JAMBA, (1, 2)), (WHISPER, (1, 2)), (XLSTM, (1, 2))],
               4: [(JAMBA, (1, 4)), (JAMBA, (2, 2)), (WHISPER, (2, 2)),
                   (XLSTM, (1, 4)), (XLSTM, (2, 2))]}
STEP_ARCHS = (JAMBA, WHISPER, XLSTM)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's torch work on one thread, as the suite runs it
    beside other workers on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 \
        else t.view(torch.int16)


def _mesh(grid, rank: int = 0):
    from repro_torch.launch.mesh import AbstractMesh
    return AbstractMesh(grid, ("data", "model"), rank=rank, device="cpu")


# ---------------------------------------------------------------------------
# the rules against the reference's
# ---------------------------------------------------------------------------

GRIDS = {"1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2},
         "2x2x2": {"pod": 2, "data": 2, "model": 2},
         "1x4": {"data": 1, "model": 4}}
RINGS = (16, 4096)
HELD = ("h", "conv", "mem_k", "mem_v", "c", "n", "m")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_cache_pspecs_equal_the_reference(arch):
    """Every leaf of the smoke cache (whisper's memory 4096 positions) at
    batches 1, 2, 4, rings of 16 and 4096 positions, on four grids gets
    the reference's spec: Mamba's ``h`` / ``conv``, an sLSTM's ``h``,
    the mLSTM / sLSTM ``c`` / ``n`` / ``m``, ``lengths``; a K/V ring or
    memory where a rank's slice would not be whole 1024-position chunks
    stays whole, its layout saying why, and is the reference's on every
    other dim."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.registry import cache_specs as jax_cache_specs
    from repro.runtime import sharding as jax_sharding
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import cache_specs
    from repro_torch.runtime import sharding
    from repro_torch.runtime.weights import tree_leaves
    checked = kept_whole = 0
    for b in (1, 2, 4):
        for ring in RINGS:
            jcache = jax_cache_specs(jax_smoke_config(arch), b, ring)
            cache = cache_specs(get_smoke_config(arch), b, ring)
            shapes = {p: tuple(t.shape) for p, t in tree_leaves(cache)}
            for label, grid in GRIDS.items():
                mesh = SimpleNamespace(shape=grid)
                flat, _ = jax.tree_util.tree_flatten_with_path(
                    jax_sharding.cache_pspecs(jcache, mesh, b),
                    is_leaf=lambda x: isinstance(x, P))
                want = {jax_sharding._path_str(p): tuple(s)
                        for p, s in flat}
                layout = sharding.kv_layout(mesh, ring, batch=b)
                got = dict(sharding.spec_leaves(sharding.port_cache_pspecs(
                    cache, mesh, b, layout)))
                assert set(got) == set(want)
                for path, spec in got.items():
                    name = path.rsplit("/", 1)[-1]
                    where = (arch, b, ring, label, path)
                    if name in ("k", "v", "mem_k", "mem_v"):
                        seq = layout if name in ("k", "v") else \
                            sharding.memory_layout(mesh, shapes[path][2],
                                                   batch=b)
                        if not seq.sharded:
                            assert spec[2] is None and seq.why, where
                            kept_whole += want[path][2] is not None
                            spec = spec[:2] + want[path][2:3] + spec[3:]
                        else:
                            assert spec[2] == seq.spec(), where
                    assert spec == want[path], where
                    checked += 1
    assert checked
    if arch != XLSTM:       # the rings of 16 positions stay whole
        assert kept_whole


@pytest.mark.parametrize("A,h_split,conv_split", [
    (1, False, False), (2, True, True), (4, True, True), (8, False, True),
    (3, False, False)])
def test_state_layout_rule(A, h_split, conv_split):
    """Each leaf decided alone by the reference's ``_maybe(last dim,
    "model")``: smoke jamba's d_state 4 and d_inner 128; a leaf kept
    whole is named in ``why``; blocks tile the dims in rank order."""
    from repro_torch.runtime import sharding
    blocks = []
    for r in range(A):
        layout = sharding.state_layout(_mesh((1, A), r), 128, 4)
        assert (layout.h_axis == "model") == h_split
        assert (layout.conv_axis == "model") == conv_split
        assert layout.sharded == (h_split or conv_split)
        if A > 1 and not h_split:
            assert "h: d_state 4" in layout.why
        if A > 1 and not conv_split:
            assert "conv: channels 128" in layout.why
        blocks.append((layout.state_block, layout.channel_block))
        assert "whole" not in layout.describe().split(" (")[0] \
            or not (h_split and conv_split)
    s = [b[0] for b in blocks] if h_split else [(0, 4)]
    c = [b[1] for b in blocks] if conv_split else [(0, 128)]
    for spans, n in ((s, 4), (c, 128)):
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    layout = sharding.state_layout(_mesh((2, 2), 3), 128, 4, batch=2)
    assert layout.rows == "data" and layout.state_block == (2, 4)


# ---------------------------------------------------------------------------
# A ranks in one process
# ---------------------------------------------------------------------------

class _Exchange:
    """A ranks' gathers in one process: each rank's thread posts its part
    and takes the parts of every rank, concatenated in rank order."""

    def __init__(self, A: int):
        self.parts = [None] * A
        self.barrier = threading.Barrier(A, timeout=60)

    def gather(self, rank: int, t, dim: int):
        self.parts[rank] = t
        self.barrier.wait()
        out = torch.cat(self.parts, dim=dim)
        self.barrier.wait()
        return out


class _RankLayout:
    """A layout of rank ``rank`` (its blocks and offsets) whose gathers
    go through ``exchange``."""

    def __init__(self, layout, exchange: _Exchange, rank: int):
        self._layout, self._exchange, self._rank = layout, exchange, rank

    def __getattr__(self, name):
        return getattr(self._layout, name)

    def gather(self, t, dim, *_axis):
        return self._exchange.gather(self._rank, t, dim)


def _run_ranks(A: int, fn) -> list:
    """``fn(rank, exchange)`` on A threads at once; their results."""
    exchange, out, errors = _Exchange(A), [None] * A, []

    def one(r):
        try:
            out[r] = fn(r, exchange)
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errors.append(e)
            exchange.barrier.abort()

    threads = [threading.Thread(target=one, args=(r,)) for r in range(A)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _mamba_layer(batch: int, seed: int):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import ssm
    cfg = get_smoke_config(JAMBA)
    gen = torch.Generator().manual_seed(seed)
    p = {k: v[0] for k, v in ssm.init_mamba(
        1, cfg.d_model, cfg.ssm_state, cfg.conv_dim, gen, "cpu").items()}
    # a live state and a non-zero a_log spread, as after a prefill
    p["a_log"] = p["a_log"] + 0.1 * torch.randn(p["a_log"].shape,
                                                generator=gen)
    p["conv_b"] = (0.1 * torch.randn(p["conv_b"].shape, generator=gen)
                   ).bfloat16()
    c, _ = ssm.mamba_dims(cfg.d_model, cfg.ssm_state)
    cache = {"h": torch.randn((batch, c, cfg.ssm_state), generator=gen),
             "conv": torch.randn((batch, cfg.conv_dim - 1, c),
                                 generator=gen).bfloat16()}
    us = [torch.randn((batch, 1, cfg.d_model), generator=gen).bfloat16()
          for _ in range(3)]
    return cfg, p, cache, us


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("A", [1, 2, 4, 8])
def test_mamba_step_rank_blocks_are_the_whole_step(A, batch):
    """Each rank's ``mamba_step`` over its blocks of ``h`` and ``conv``
    (A ranks of a (1, A) mesh, in threads): over three steps, every
    rank's output is the whole step's bit for bit, and the ranks' blocks
    together are the whole state."""
    from repro_torch.models import ssm
    from repro_torch.runtime import sharding
    cfg, p, cache, us = _mamba_layer(batch, seed=A + 10 * batch)
    whole = dict(cache)
    want = []
    for u in us:
        out, whole = ssm.mamba_step(p, u, whole, cfg.ssm_state)
        want.append(out)
    c = whole["conv"].shape[-1]

    def rank(r, exchange):
        layout = _RankLayout(sharding.state_layout(
            _mesh((1, A), r), c, cfg.ssm_state), exchange, r)
        s0, s1 = layout.state_block
        c0, c1 = layout.channel_block
        state = {"h": cache["h"][..., s0:s1].clone(),
                 "conv": cache["conv"][..., c0:c1].clone()}
        outs = []
        for u in us:
            out, state = ssm.mamba_step(p, u, state, cfg.ssm_state, layout)
            outs.append(out)
        return outs, state, layout.sharded

    ranks = _run_ranks(A, rank)
    for r, (outs, _, _) in enumerate(ranks):
        for got, ref in zip(outs, want):
            assert torch.equal(_bits(got), _bits(ref)), r
    assert ranks[0][2] == (A > 1)
    for key in ("h", "conv"):
        parts = [state[key] for _, state, _ in ranks]
        joined = parts[0] if parts[0].shape == whole[key].shape \
            else torch.cat(parts, dim=-1)
        assert torch.equal(_bits(joined), _bits(whole[key])), key
        if A == 8 and key == "h":       # d_state 4 does not divide by 8
            assert all(p.shape == whole["h"].shape for p in parts)


def _slstm_layer(batch: int, seed: int):
    """One smoke sLSTM layer, a live state (``n`` above its clamp, ``m``
    finite, as after a prefill) and three inputs."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import xlstm
    d = get_smoke_config(XLSTM).d_model
    gen = torch.Generator().manual_seed(seed)
    p = {k: v[0] for k, v in xlstm.init_slstm(1, d, gen, "cpu").items()}
    p["norm"] = (0.1 * torch.randn(p["norm"].shape, generator=gen)
                 ).bfloat16()
    cache = {"c": torch.randn((batch, d), generator=gen),
             "n": 0.5 + 2 * torch.rand((batch, d), generator=gen),
             "h": torch.randn((batch, d), generator=gen),
             "m": torch.randn((batch, d), generator=gen)}
    xs = [torch.randn((batch, 1, d), generator=gen).bfloat16()
          for _ in range(3)]
    return d, p, cache, xs


def _slstm_step_before(p, x, cache):
    """``slstm_step`` as it was before it took a layout: the whole state,
    no gather."""
    from repro_torch.models import xlstm
    from repro_torch.models.layers import weight_matmul
    carry = xlstm._slstm_cell(p, (cache["c"], cache["n"], cache["h"],
                                  cache["m"]),
                              weight_matmul(p["w_in"], x[:, 0]))
    return xlstm._slstm_out(p, carry[2][:, None, :], x.dtype), \
        dict(zip(("c", "n", "h", "m"), carry))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("A", [1, 2, 4, 8, 3])
def test_slstm_step_rank_blocks_are_the_whole_step(A, batch):
    """Each rank's ``slstm_step`` over its block of ``h``'s D (A ranks of
    a (1, A) mesh, in threads; ``c`` / ``n`` / ``m`` whole): over three
    steps every rank's output and ``c`` / ``n`` / ``m`` are the whole
    step's bit for bit and the ranks' blocks together are its ``h``;
    ``slstm_step`` with no layout is the step as it was before it took
    one.  At A = 3 the smoke D 64 does not divide: ``h`` stays whole and
    the layout says why."""
    from repro_torch.models import xlstm
    from repro_torch.runtime import sharding
    d, p, cache, xs = _slstm_layer(batch, seed=A + 10 * batch)
    whole, before, want = dict(cache), dict(cache), []
    for x in xs:
        out, whole = xlstm.slstm_step(p, x, whole)
        ref, before = _slstm_step_before(p, x, before)
        assert torch.equal(_bits(out), _bits(ref))
        want.append(out)
    for k in whole:
        assert torch.equal(_bits(whole[k]), _bits(before[k])), k

    def rank(r, exchange):
        layout = _RankLayout(sharding.state_layout(
            _mesh((1, A), r), 0, 0, d_slstm=d), exchange, r)
        d0, d1 = layout.slstm_block
        state = dict(cache, h=cache["h"][..., d0:d1].clone())
        outs = []
        for x in xs:
            out, state = xlstm.slstm_step(p, x, state, layout)
            outs.append(out)
        return outs, state, layout

    ranks = _run_ranks(A, rank)
    for r, (outs, state, layout) in enumerate(ranks):
        assert layout.sharded == (A in (2, 4, 8))
        assert (A == 3) == ("sLSTM h: D 64 % 3 model ranks" in layout.why)
        for got, ref in zip(outs, want):
            assert torch.equal(_bits(got), _bits(ref)), r
        for k in ("c", "n", "m"):
            assert torch.equal(_bits(state[k]), _bits(whole[k])), (r, k)
    parts = [state["h"] for _, state, _ in ranks]
    joined = parts[0] if not ranks[0][2].sharded else torch.cat(parts, -1)
    assert all(t.shape[-1] == d // (A if ranks[0][2].sharded else 1)
               for t in parts)
    assert torch.equal(_bits(joined), _bits(whole["h"]))


@pytest.mark.parametrize("score_shard", [False, True],
                         ids=["scores", "flash"])
@pytest.mark.parametrize("A", [2, 4])
def test_cross_attention_rank_parts_are_the_whole_memory(A, score_shard):
    """Whisper's decode cross attention over each rank's positions of a
    4096-position memory (``memory_layout`` on (1, A), in threads), by
    either route: every rank's output is the whole memory's bit for
    bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers, lm
    from repro_torch.runtime import sharding
    cfg = get_smoke_config(WHISPER)
    s = lm.attn_shape(cfg)
    gen = torch.Generator().manual_seed(A)
    p = {k: v[0] for k, v in layers.init_cross_attention(
        1, s, gen, "cpu").items()}
    x = torch.randn((3, 1, cfg.d_model), generator=gen).bfloat16()
    mem = [torch.randn((3, 4096, s.n_kv_heads, s.head_dim),
                       generator=gen).bfloat16() for _ in range(2)]
    want = layers.cross_attention_block(p, x, mem, s, decode=True)

    def rank(r, exchange):
        layout = _RankLayout(sharding.memory_layout(_mesh((1, A), r), 4096),
                             exchange, r)
        lo, n = layout.offset, layout.local_length
        return layers.cross_attention_block(
            p, x, [m[:, lo:lo + n] for m in mem], s, decode=True,
            layout=layout, score_shard=score_shard), n

    for r, (got, n) in enumerate(_run_ranks(A, rank)):
        assert n == 4096 // A
        assert torch.equal(_bits(got), _bits(want)), r


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _serve(argv):
    """``serve.main`` with 1024-element blocks, quietly."""
    from repro_torch.core.codec_api import Codec
    from repro_torch.launch import serve
    serve.Codec = functools.partial(Codec, block_elems=BLOCK_ELEMS)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return serve.main(argv)
    finally:
        serve.Codec = Codec


def _keep(out) -> dict:
    keys = ("logits", "tokens", "links", "step_kv_bytes", "state_bytes",
            "state_leaf_bytes", "state_layout", "mesh", "step_launches")
    return {k: out[k] for k in keys}


def _inputs(arch: str) -> dict:
    """The mesh steps' global batch: prompts (and whisper's frames) from
    numpy seed 1."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(1)
    batch = {}
    if arch == WHISPER:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, FRAMES, cfg.d_model)).astype(np.float32)).bfloat16()
    batch["tokens"] = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, STEP_PROMPT)))
    return batch


def _held_bytes(cache) -> dict:
    """Bytes of the cache's recurrent states and encoder memory, by leaf
    name."""
    from repro_torch.runtime.weights import tree_leaves
    out = dict.fromkeys(HELD, 0)
    for path, t in tree_leaves(cache):
        name = path.rsplit("/", 1)[-1]
        if name in out and isinstance(t, torch.Tensor):
            out[name] += t.numel() * t.element_size()
    return out


def _steps_run(arch: str, params, mesh=None) -> dict:
    """The steps of one arch on ``mesh`` (None: one device) over the
    global batch: the prefill and ``STEPS`` decode steps, each rank's rows
    of the logits, the global greedy tokens, the cache's held bytes and
    layouts, and the dense bytes each decode step gathered."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.codec_api import Codec, use_codec
    from repro_torch.launch.mesh import gather_whole
    from repro_torch.models import build_model
    from repro_torch.runtime import collectives, sharding
    from repro_torch.runtime.steps import (build_decode_step,
                                           build_prefill_step)
    from repro_torch.runtime.streaming import assign_weight_modes
    model = build_model(get_smoke_config(arch))
    tree = assign_weight_modes(params, mode="dense", min_bytes=1024)
    if mesh is not None:
        tree = collectives.place_serving_tree(tree, mesh)
    batch = _inputs(arch)
    rows = batch["tokens"].shape[0]
    ba = None if mesh is None else sharding.batch_axis(mesh, rows)

    def whole_rows(t):      # every data rank's rows: a check's gather
        if ba is None:
            return t
        return gather_whole([t], [(ba,) + (None,) * (t.ndim - 1)], mesh,
                            link=None)[0]

    codec = Codec()
    with use_codec(codec):
        prefill = build_prefill_step(model, MAX_LEN, mesh)
        decode = build_decode_step(model, mesh)
        logits, cache = prefill(tree, batch)
        held = _held_bytes(cache)
        layouts = {k: cache[k].describe() for k in ("state_layout",
                                                    "mem_layout")
                   if k in cache}
        out, gathered = [logits], []
        tok = torch.argmax(whole_rows(logits), -1)
        toks = [tok]
        for _ in range(STEPS):
            before = codec.link_stats()["d2d_allgather"]["dense_bytes"]
            logits, cache = decode(tree, cache, tok)
            gathered.append(codec.link_stats()["d2d_allgather"][
                "dense_bytes"] - before)
            tok = torch.argmax(whole_rows(logits), -1)
            out.append(logits)
            toks.append(tok)
    return {"logits": torch.stack(out), "tokens": torch.stack(toks),
            "held": held, "layouts": layouts, "gathered": gathered}


def _worker(out_dir: Path, world: int) -> None:
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    rank = int(os.environ["RANK"])
    params = torch.load(out_dir / "params.pt", weights_only=False)
    res = {"rank": rank, "serve": {}, "steps": {}}
    for arch, tp, mode in WORLD_SERVE[world]:
        res["serve"][arch, tp, mode] = _keep(_serve(
            SERVE + ["--arch", arch, "--mode", mode, "--tp", str(tp)]))
    for arch, grid in WORLD_STEPS[world]:
        mesh = make_host_mesh(model=grid[1], device="cpu")
        res["steps"][arch, grid] = {"coords": mesh.coords,
                                    **_steps_run(arch, params[arch], mesh)}
    torch.save(res, out_dir / f"w{world}_rank{rank}.pt")


# ---------------------------------------------------------------------------
# the fixture: the reference, both worlds and the single-device runs
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_world(out_dir: Path, world: int) -> list:
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), os.environ.get("PYTHONPATH",
                                                          "")]))
        log = open(out_dir / f"w{world}_rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, "--worker", str(out_dir),
             str(world)], env=env, stdout=log, stderr=subprocess.STDOUT),
            log))
    return procs


def _join_world(procs, out_dir: Path, world: int, deadline: float) -> list:
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    failed = [r for r, (p, _) in enumerate(procs) if p.returncode]
    assert not failed, "world %d: rank(s) %s failed:\n%s" % (
        world, failed, "\n".join(
            (out_dir / f"w{world}_rank{r}.log").read_text()[-3000:]
            for r in failed))
    return [torch.load(out_dir / f"w{world}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def _reference(arch: str):
    """The reference's smoke weights (``jax.random.key(0)``) carried over
    to the port, and a function giving its greedy tokens and logits on
    one device (prefill and ``STEPS`` decode steps) for the mesh steps'
    batch: jamba's and whisper's under ``jax.jit`` (eagerly they take
    ≈ 45 s on this CPU, and the tokens are the same), xlstm's eagerly
    (≈ 5 s), whose logits are held within ``XLSTM_ULPS`` (``jax.jit``
    moves them by many ulps through XLA's fusions)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import build_model as jax_build_model
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    model = jax_build_model(jax_smoke_config(arch))
    jparams = jax.jit(model.init)(jax.random.key(0))
    params = params_from_jax(jax.device_get(jparams), "cpu",
                             cfg=get_smoke_config(arch))

    def tokens():
        batch = _inputs(arch)
        jbatch = {"tokens": jnp.asarray(batch["tokens"].numpy(), jnp.int32)}
        if "frames" in batch:
            jbatch["frames"] = jnp.asarray(
                batch["frames"].float().numpy()).astype(jnp.bfloat16)
        prefill, decode = model.prefill_fn, model.decode_fn
        if arch != XLSTM:
            prefill = jax.jit(prefill, static_argnums=2)
            decode = jax.jit(decode)
        logits, cache = prefill(jparams, jbatch, MAX_LEN)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks, out = [np.asarray(tok)], [np.asarray(logits)]
        for _ in range(STEPS):
            logits, cache = decode(jparams, cache, tok)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            out.append(np.asarray(logits))
        return np.stack(toks), np.stack(out)

    return params, tokens


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("state_mesh")
    refs = {arch: _reference(arch) for arch in STEP_ARCHS}
    params = {arch: p for arch, (p, _) in refs.items()}
    torch.save(params, out_dir / "params.pt")
    procs = {w: _start_world(out_dir, w) for w in WORLD_SERVE}
    deadline = time.monotonic() + TIME_LIMIT_S
    try:
        single = {("serve", arch, mode): _keep(_serve(
            SERVE + ["--arch", arch, "--mode", mode]))
            for arch in (JAMBA, XLSTM) for mode in MODES}
        for arch in STEP_ARCHS:
            single[arch] = _steps_run(arch, params[arch])
        tokens = {arch: fn() for arch, (_, fn) in refs.items()}
    finally:
        ranks = {w: _join_world(p, out_dir, w, deadline)
                 for w, p in procs.items()}
    return ranks, single, tokens


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _serve_runs(arch: str):
    return [(w, tp, mode) for w, runs in WORLD_SERVE.items()
            for a, tp, mode in runs if a == arch]


def _step_runs():
    return [(w, arch, grid) for w, runs in WORLD_STEPS.items()
            for arch, grid in runs]


@pytest.mark.parametrize("world,tp,mode", _serve_runs(JAMBA))
def test_jamba_serve_on_the_mesh_bitwise_to_one_device(worlds, world, tp,
                                                       mode):
    """``serve --tp A``: every rank's logits are one device's bit for bit;
    each rank holds 1/tp of the Mamba states (d_state 4 and d_inner 128
    divide), its blocks the layout's; a step gathers the layout's bytes
    for its 7 Mamba layers (the ring of 16 positions stays whole); the
    step's kernel launches are one device's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.runtime import sharding
    ranks, single, _ = worlds
    want = single["serve", JAMBA, mode]
    cfg = get_smoke_config(JAMBA)
    assert want["state_layout"] is None and want["state_bytes"] > 0
    for r in ranks[world]:
        got = r["serve"][JAMBA, tp, mode]
        assert got["mesh"] == {"data": world // tp, "model": tp}
        assert torch.equal(_bits(got["logits"]), _bits(want["logits"]))
        assert torch.equal(got["tokens"], want["tokens"])
        assert got["state_bytes"] * tp == want["state_bytes"]
        coord = r["rank"] % tp
        layout = sharding.state_layout(
            SimpleNamespace(shape=got["mesh"], coords={"model": coord}),
            2 * cfg.d_model, cfg.ssm_state)
        assert got["state_layout"]["describe"] == layout.describe()
        assert got["state_layout"]["state_block"] == [
            coord * 4 // tp, (coord + 1) * 4 // tp]
        assert got["step_kv_bytes"] == [7 * layout.step_gather_bytes(
            BATCH)] * (TOKENS - 1)
        assert got["step_launches"] == want["step_launches"]


@pytest.mark.parametrize("world,tp,mode", _serve_runs(XLSTM))
def test_xlstm_serve_on_the_mesh_bitwise_to_one_device(worlds, world, tp,
                                                       mode):
    """``serve --arch xlstm_125m --tp A``: every rank's logits are one
    device's bit for bit; each rank holds 1/tp of the sLSTM ``h`` (D 64
    divides), its block the layout's, and all of ``c`` / ``n`` / ``m``
    (the mLSTM's and the sLSTM's); a step gathers the bf16 ``h`` of the
    one sLSTM layer; the step's kernel launches are one device's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.runtime import sharding
    ranks, single, _ = worlds
    want = single["serve", XLSTM, mode]
    d = get_smoke_config(XLSTM).d_model
    assert want["state_layout"] is None and want["state_bytes"] > 0
    for r in ranks[world]:
        got = r["serve"][XLSTM, tp, mode]
        assert got["mesh"] == {"data": world // tp, "model": tp}
        assert torch.equal(_bits(got["logits"]), _bits(want["logits"]))
        assert torch.equal(got["tokens"], want["tokens"])
        held, whole = got["state_leaf_bytes"], want["state_leaf_bytes"]
        assert held["h"] * tp == whole["h"] > 0
        assert all(held[k] == whole[k] > 0 for k in ("c", "n", "m"))
        assert sum(held.values()) == got["state_bytes"]
        coord = r["rank"] % tp
        layout = sharding.state_layout(
            SimpleNamespace(shape=got["mesh"], coords={"model": coord}),
            0, 0, d_slstm=d)
        assert got["state_layout"]["describe"] == layout.describe()
        assert got["state_layout"]["slstm_block"] == [
            coord * d // tp, (coord + 1) * d // tp]
        assert got["step_kv_bytes"] == [
            (tp - 1) * BATCH * d * 2] * (TOKENS - 1)
        assert layout.step_gather_bytes(BATCH, mamba=0, slstm=1) \
            == (tp - 1) * BATCH * d * 2
        assert got["step_launches"] == want["step_launches"]


@pytest.mark.parametrize("world,arch,grid", _step_runs())
def test_mesh_steps_bitwise_and_hold_their_share(worlds, world, arch, grid):
    """The mesh prefill and decode steps (rows on "data" on (2, 2)): every
    rank's logits are its rows of one device's bit for bit, its greedy
    tokens the reference's (xlstm's logits within ``XLSTM_ULPS`` of the
    reference's); it holds 1/A of ``h`` / ``conv`` (jamba), ``mem_k`` /
    ``mem_v`` (whisper) or the sLSTM ``h`` (xlstm, whose ``c`` / ``n`` /
    ``m`` stay whole over "model"), A its data x model ranks, and a
    decode step gathers the layouts' bytes."""
    from repro_torch.configs import get_smoke_config
    ranks, single, tokens = worlds
    want = single[arch]
    ref_tokens, ref_logits = tokens[arch]
    cfg = get_smoke_config(arch)
    data, model = grid
    rows = 2 // data
    if arch == XLSTM:
        np.testing.assert_allclose(
            want["logits"].numpy(), ref_logits, rtol=0,
            atol=XLSTM_ULPS * LOGIT_ULP * max(1.0, np.abs(ref_logits).max()))
    for r in ranks[world]:
        got = r["steps"][arch, grid]
        d = got["coords"]["data"]
        assert torch.equal(_bits(got["logits"]),
                           _bits(want["logits"][:, d * rows:(d + 1) * rows]))
        np.testing.assert_array_equal(got["tokens"].numpy(), ref_tokens)
        np.testing.assert_array_equal(want["tokens"].numpy(), ref_tokens)
        leaves = {JAMBA: ("h", "conv"), WHISPER: ("mem_k", "mem_v"),
                  XLSTM: ("h",)}[arch]
        for name in leaves:
            assert got["held"][name] * data * model == want["held"][name] \
                > 0, name
        if arch == XLSTM:
            for name in ("c", "n", "m"):
                assert got["held"][name] * data == want["held"][name] > 0
        key = "mem_layout" if arch == WHISPER else "state_layout"
        assert "whole" not in got["layouts"][key].split(", c / n / m")[0]
        if arch == JAMBA:
            c, s = 2 * cfg.d_model, cfg.ssm_state
            # x (rows, C) bf16 and the products (rows, C, S) f32, 7 layers
            per_layer = (model - 1) * rows * c * (2 + 4 * s)
            assert got["gathered"] == [7 * per_layer] * STEPS
        elif arch == XLSTM:
            # the bf16 h (rows, D) of the one sLSTM layer
            per_layer = (model - 1) * rows * cfg.d_model * 2
            assert got["gathered"] == [per_layer] * STEPS
        else:
            assert all(g > 0 for g in got["gathered"])
    assert want["layouts"] == {} and all(g == 0 for g in want["gathered"])


@pytest.mark.parametrize("arch", [JAMBA, WHISPER, XLSTM])
@pytest.mark.parametrize("grid", [(1, 2), (1, 4)])
def test_dryrun_serving_cells_hold_the_ranks_share(tmp_path, arch, grid):
    """The dry-run's decode cell of the smoke config on a (1, A) abstract
    mesh: rank 0's cache holds 1/A of ``h`` and ``conv`` (jamba), of
    ``mem_k`` / ``mem_v`` (whisper's 4096 positions) or of the sLSTM
    ``h`` (xlstm, ``c`` / ``n`` / ``m`` whole), the cell runs, and its
    program line says what the rank holds instead of "whole"; the
    prefill cell runs too."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import cache_specs
    from repro_torch.runtime import sharding
    cfg = get_smoke_config(arch)
    A = grid[1]
    mesh = dryrun.AbstractMesh(grid, ("data", "model"), rank=0)
    whole = cache_specs(cfg, 1, 32)
    layout = sharding.kv_layout(mesh, 32, batch=1)
    local = dryrun.rank_cache(whole, mesh, 1, layout)
    want, got = _held_bytes(whole), _held_bytes(local)
    leaves = {JAMBA: ("h", "conv"), WHISPER: ("mem_k", "mem_v"),
              XLSTM: ("h",)}[arch]
    for name in leaves:
        assert got[name] * A == want[name] > 0, name
    if arch == XLSTM:
        assert all(got[k] == want[k] > 0 for k in ("c", "n", "m"))
    key = "mem_layout" if arch == WHISPER else "state_layout"
    assert local[key].sharded
    for kind in ("decode", "prefill"):
        shape = ShapeSpec(f"{kind}_smoke", 32 if kind == "decode" else 16,
                          1, kind)
        rec = dryrun.run_cell(arch, shape.name, tmp_path, ["single"],
                              mesh_shape=grid, cfg=cfg, shape=shape)
        assert rec["status"] == "ok", rec
        line = rec["single"]["full"]["program"]
        assert "whole on the rank's rows" not in line
        if arch == JAMBA:
            assert "Mamba states h d_state 0:" in line, line
        elif arch == XLSTM:
            assert (f"sLSTM states h D 0:{cfg.d_model // A} of "
                    f"{cfg.d_model} over model") in line, line
        elif kind == "decode":
            assert "encoder memory sequence-sharded" in line, line


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, str(ROOT / "src"))
    _worker(Path(sys.argv[2]), int(sys.argv[3]))
    torch.distributed.destroy_process_group()
