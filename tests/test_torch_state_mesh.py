"""The recurrent states and the encoder memory on the port's serving mesh
(``runtime/sharding.py:state_layout`` / ``memory_layout``,
``models/ssm.py:rank_mamba_step``, ``layers.cross_attention_block`` over
a sharded memory), against the reference's rules, one device and the
reference's greedy tokens.

  * ``port_cache_pspecs`` equal to the reference's ``cache_pspecs`` on
    Mamba's ``h`` (by d_state) and ``conv`` (by channels) and whisper's
    ``mem_k`` / ``mem_v`` (by sequence, where the 1024-chunk rule holds;
    whole, saying why, where it does not) on the smoke caches;
  * in one process, A ranks on ``AbstractMesh`` coordinates, each in a
    thread whose gathers meet the others' (:class:`_Exchange`):
    ``mamba_step``'s rank blocks at A = 1, 2, 4, 8 assembled bitwise the
    whole step's ``h``, ``conv`` and output over several steps (at A = 8
    the smoke d_state 4 does not divide: ``conv`` shards, ``h`` stays
    whole), and the cross attention's rank parts bitwise the whole
    memory's in both routes;
  * gloo worlds of 2 and 4 CPU ranks: jamba smoke through ``serve.main
    --tp A`` in three modes and jamba / whisper smoke through the mesh
    steps (``build_prefill_step`` / ``build_decode_step(mesh=)``, on
    (1, A) and, rows on "data", (2, 2)), every rank's logits bitwise one
    device's, greedy tokens the reference's (JAX on the CPU; the weights
    made by the reference and carried over by ``convert.params_from_
    jax``), each rank holding 1/A of ``h``, ``conv``, ``mem_k`` and
    ``mem_v`` and gathering the layout's bytes a step;
  * the dry-run's jamba and whisper serving cells holding 1/A of these
    leaves on rank 0, their program line saying so.

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

ROOT = Path(__file__).resolve().parents[1]
TIME_LIMIT_S = 240
BLOCK_ELEMS = 1024
JAMBA, WHISPER = "jamba_v0_1_52b", "whisper_tiny"
MODES = ("dense", "stream", "fused")
# serve.main's requests
BATCH, PROMPT, TOKENS = 2, 12, 4
SERVE = ["--smoke", "--device", "cpu", "--arch", JAMBA, "--batch",
         str(BATCH), "--prompt-len", str(PROMPT), "--tokens", str(TOKENS),
         "--min-bytes", "1024"]
# the mesh steps' requests (the reference's tokens): prompts of 8 tokens
# from numpy seed 1, three decode steps; whisper's frames from the same
# seed, 2048 of them
STEP_PROMPT, STEPS, FRAMES = 8, 3, 2048
MAX_LEN = STEP_PROMPT + STEPS + 1
# each world's runs: serve.main --tp A in a mode; the mesh steps of an
# arch on a (data, model) grid
WORLD_SERVE = {2: [(2, m) for m in MODES],
               4: [(4, m) for m in MODES] + [(2, "dense")]}
WORLD_STEPS = {2: [(JAMBA, (1, 2)), (WHISPER, (1, 2))],
               4: [(JAMBA, (1, 4)), (JAMBA, (2, 2)), (WHISPER, (2, 2))]}


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
         "2x2x2": {"pod": 2, "data": 2, "model": 2}}
LEAVES = ("h", "conv", "mem_k", "mem_v")


@pytest.mark.parametrize("arch", [JAMBA, WHISPER])
def test_port_cache_pspecs_equal_the_reference(arch):
    """On the jamba and whisper smoke caches (whisper's memory 4096
    positions) at batches 1, 2, 4 on three grids: ``h``, ``conv``,
    ``mem_k`` and ``mem_v`` get the reference's specs; a memory where a
    rank's slice would not be whole 1024-position chunks stays whole, its
    layout saying why."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.registry import cache_specs as jax_cache_specs
    from repro.runtime import sharding as jax_sharding
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import cache_specs
    from repro_torch.runtime import sharding
    checked = 0
    for b in (1, 2, 4):
        jcache = jax_cache_specs(jax_smoke_config(arch), b, 16)
        cache = cache_specs(get_smoke_config(arch), b, 16)
        for label, grid in GRIDS.items():
            mesh = SimpleNamespace(shape=grid)
            flat, _ = jax.tree_util.tree_flatten_with_path(
                jax_sharding.cache_pspecs(jcache, mesh, b),
                is_leaf=lambda x: isinstance(x, P))
            want = {jax_sharding._path_str(p): tuple(s) for p, s in flat}
            layout = sharding.kv_layout(mesh, 16, batch=b)
            got = dict(sharding.spec_leaves(sharding.port_cache_pspecs(
                cache, mesh, b, layout)))
            assert set(got) == set(want)
            for path, spec in got.items():
                name = path.rsplit("/", 1)[-1]
                if name not in LEAVES:
                    continue
                if name.startswith("mem"):
                    memory = sharding.memory_layout(mesh, 4096, batch=b)
                    if not memory.sharded:
                        assert spec[2] is None and memory.why, (path, label)
                        assert spec[:2] == want[path][:2]
                        continue
                    assert spec[2] == memory.spec()
                assert spec == want[path], (arch, b, label, path)
                checked += 1
    assert checked


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
            "state_layout", "mesh", "step_launches")
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
    """Bytes of the cache's Mamba states and encoder memory, by leaf
    name."""
    from repro_torch.runtime.weights import tree_leaves
    out = dict.fromkeys(LEAVES, 0)
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
    for tp, mode in WORLD_SERVE[world]:
        res["serve"][tp, mode] = _keep(_serve(
            SERVE + ["--mode", mode, "--tp", str(tp)]))
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
    to the port, and a function giving its greedy tokens on one device
    (prefill and ``STEPS`` decode steps, each under ``jax.jit``: eagerly
    they take ≈ 45 s on this CPU, and the tokens are the same) for the
    mesh steps' batch."""
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
        prefill = jax.jit(model.prefill_fn, static_argnums=2)
        decode = jax.jit(model.decode_fn)
        logits, cache = prefill(jparams, jbatch, MAX_LEN)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks = [np.asarray(tok)]
        for _ in range(STEPS):
            logits, cache = decode(jparams, cache, tok)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
        return np.stack(toks)

    return params, tokens


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("state_mesh")
    refs = {arch: _reference(arch) for arch in (JAMBA, WHISPER)}
    params = {arch: p for arch, (p, _) in refs.items()}
    torch.save(params, out_dir / "params.pt")
    procs = {w: _start_world(out_dir, w) for w in WORLD_SERVE}
    deadline = time.monotonic() + TIME_LIMIT_S
    try:
        single = {("serve", mode): _keep(_serve(SERVE + ["--mode", mode]))
                  for mode in MODES}
        for arch in (JAMBA, WHISPER):
            single[arch] = _steps_run(arch, params[arch])
        tokens = {arch: fn() for arch, (_, fn) in refs.items()}
    finally:
        ranks = {w: _join_world(p, out_dir, w, deadline)
                 for w, p in procs.items()}
    return ranks, single, tokens


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _serve_runs():
    return [(w, tp, mode) for w, runs in WORLD_SERVE.items()
            for tp, mode in runs]


def _step_runs():
    return [(w, arch, grid) for w, runs in WORLD_STEPS.items()
            for arch, grid in runs]


@pytest.mark.parametrize("world,tp,mode", _serve_runs())
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
    want = single["serve", mode]
    cfg = get_smoke_config(JAMBA)
    assert want["state_layout"] is None and want["state_bytes"] > 0
    for r in ranks[world]:
        got = r["serve"][tp, mode]
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


@pytest.mark.parametrize("world,arch,grid", _step_runs())
def test_mesh_steps_bitwise_and_hold_their_share(worlds, world, arch, grid):
    """The mesh prefill and decode steps (rows on "data" on (2, 2)): every
    rank's logits are its rows of one device's bit for bit, its greedy
    tokens the reference's; it holds 1/A of ``h`` / ``conv`` (jamba) or
    ``mem_k`` / ``mem_v`` (whisper), A its data x model ranks, and a
    decode step gathers the layouts' bytes."""
    from repro_torch.configs import get_smoke_config
    ranks, single, tokens = worlds
    want = single[arch]
    cfg = get_smoke_config(arch)
    data, model = grid
    rows = 2 // data
    for r in ranks[world]:
        got = r["steps"][arch, grid]
        d = got["coords"]["data"]
        assert torch.equal(_bits(got["logits"]),
                           _bits(want["logits"][:, d * rows:(d + 1) * rows]))
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      tokens[arch])
        np.testing.assert_array_equal(want["tokens"].numpy(), tokens[arch])
        leaves = ("h", "conv") if arch == JAMBA else ("mem_k", "mem_v")
        for name in leaves:
            assert got["held"][name] * data * model == want["held"][name] \
                > 0, name
        key = "state_layout" if arch == JAMBA else "mem_layout"
        assert "whole" not in got["layouts"][key]
        if arch == JAMBA:
            c, s = 2 * cfg.d_model, cfg.ssm_state
            # x (rows, C) bf16 and the products (rows, C, S) f32, 7 layers
            per_layer = (model - 1) * rows * c * (2 + 4 * s)
            assert got["gathered"] == [7 * per_layer] * STEPS
        else:
            assert all(g > 0 for g in got["gathered"])
    assert want["layouts"] == {} and all(g == 0 for g in want["gathered"])


@pytest.mark.parametrize("arch", [JAMBA, WHISPER])
@pytest.mark.parametrize("grid", [(1, 2), (1, 4)])
def test_dryrun_serving_cells_hold_the_ranks_share(tmp_path, arch, grid):
    """The dry-run's decode cell of the smoke config on a (1, A) abstract
    mesh: rank 0's cache holds 1/A of ``h`` and ``conv`` (jamba) or of
    ``mem_k`` / ``mem_v`` (whisper's 4096 positions), the cell runs, and
    its program line says what the rank holds instead of "whole"; the
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
    leaves = ("h", "conv") if arch == JAMBA else ("mem_k", "mem_v")
    for name in leaves:
        assert got[name] * A == want[name] > 0, name
    key = "state_layout" if arch == JAMBA else "mem_layout"
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
        elif kind == "decode":
            assert "encoder memory sequence-sharded" in line, line


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, str(ROOT / "src"))
    _worker(Path(sys.argv[2]), int(sys.argv[3]))
    torch.distributed.destroy_process_group()
