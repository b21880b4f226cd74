"""Expert-parallel MoE serving on the port's serving mesh
(``runtime/sharding.py:expert_layout``, ``runtime/collectives.py``'s
expert placement and exchanges, ``models/moe.py``'s rank block), against
the reference's rules, one device, and the reference's greedy tokens.

  * the layout's specs against the reference's ``param_pspec`` in
    ``mode="serve"`` and ``"serve_ep"``: E on "model" as the reference
    puts it; on "data" each expert matrix's output dim (the reference's
    F of ``e_gate`` / ``e_up`` under ``serve``; ``e_down``'s D and, under
    ``serve_ep``, every matrix's output dim where the reference splits a
    contracting dim: ``docs/PORT.md`` convention 11), the same bytes a
    rank;
  * a column slice of ``tiled_matmul_ref`` bitwise the slice of the
    whole product;
  * ``localize_ct``: a rank's own experts of a compressed stack decode to
    the whole decode's experts bit for bit, and a stack whose stream
    shards cut an expert is refused;
  * gloo worlds of 2 and 4 CPU ranks serving phi3_5_moe (E = 4) and
    qwen3_moe (E = 8) smoke configs through ``serve.main --tp A`` in
    dense, stream and fused mode, and dense on the (2, 2) mesh: every
    rank's logits bitwise one device's, no expert byte gathered (the step
    gathers only the other placed streams), each rank holding 1/A of the
    expert bytes, the MoE blocks' exchanged bytes a step the layout's
    formula, greedy tokens the reference's on the same weights (its own
    mesh tests are red on this JAX); a stream checkpoint restored onto 2
    ranks, each uploading only its own experts' shard rows;
  * the mesh steps (``build_prefill_step`` / ``build_decode_step(mesh=)``)
    on the (2, 2) mesh with the rows on "data": the dispatch's all-gather
    and the return's all-to-all over real gloo, each rank's rows bitwise
    one device's;
  * the dry-run's ``ep_*`` cells of phi3_5_moe smoke on a 2x2 abstract
    mesh: ``status: "ok"``, rank 0's expert bytes the formula.

One module fixture starts both worlds (6 processes, one thread each)
and, while they run, makes the single-device runs and the reference's
tokens here.  The serve runs use 1024-element blocks (``serve.Codec``
patched, as ``tests/test_torch_mesh.py`` does) so the smoke expert stacks
compress and shard.
"""
import contextlib
import functools
import io
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TIME_LIMIT_S = 240
BLOCK_ELEMS = 1024
ARCHS = ("phi3_5_moe_42b_a6_6b", "qwen3_moe_235b_a22b")
MODES = ("dense", "stream", "fused")
BATCH, PROMPT, TOKENS = 2, 12, 4
SERVE = ["--smoke", "--device", "cpu", "--batch", str(BATCH),
         "--prompt-len", str(PROMPT), "--tokens", str(TOKENS),
         "--min-bytes", "1024"]
# each world's serve runs: (--tp, arch, mode)
WORLD_RUNS = {2: [(2, a, m) for a in ARCHS for m in MODES],
              4: [(4, a, m) for a in ARCHS for m in MODES]
              + [(2, a, "dense") for a in ARCHS]}
STEPS_ARCH = "phi3_5_moe_42b_a6_6b"     # the mesh steps' rows on "data"
# a stream checkpoint (--shards 2) written here, restored on 2 ranks
CKPT = "ckpt"
RESTORE = SERVE + ["--arch", STEPS_ARCH, "--mode", "stream", "--ckpt"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's torch work on one thread, as the suite runs it
    beside other workers on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    keys = ("logits", "tokens", "links", "step_gather_bytes",
            "gather_nbytes", "step_ep_bytes", "expert_placement", "mesh",
            "step_launches", "mode_mix", "restore")
    return {k: out[k] for k in keys}


def _bits(t):
    return t.view(torch.int32)


# ---------------------------------------------------------------------------
# the layout's rules against the reference's
# ---------------------------------------------------------------------------

GRIDS = {"16x16": {"data": 16, "model": 16}, "2x2": {"data": 2, "model": 2},
         "1x4": {"data": 1, "model": 4}, "4x1": {"data": 4, "model": 1},
         "2x3": {"data": 2, "model": 3}, "pod": {"pod": 2, "data": 2,
                                                 "model": 2}}
SHAPES = {"phi": (16, 4096, 6400), "qwen": (128, 4096, 1536),
          "smoke": (4, 128, 64), "odd": (6, 96, 40)}


@pytest.mark.parametrize("mode", ["serve", "serve_ep"])
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("dims", list(SHAPES))
def test_layout_specs_against_the_reference(dims, grid, mode):
    """E goes where the reference puts it; on "data" the port splits each
    matrix's output dim where the reference splits that dim or a
    contracting one, and a rank holds the reference's bytes."""
    from repro.runtime import sharding as ref
    from repro_torch.runtime import sharding
    e, d, f = SHAPES[dims]
    mesh = SimpleNamespace(shape=GRIDS[grid])
    layout = sharding.expert_layout(mesh, e, d, f, mode=mode)
    gate = ref.param_pspec("period/0/moe/e_gate", (2, e, d, f), mesh,
                           mode=mode)
    down = ref.param_pspec("period/0/moe/e_down", (2, e, f, d), mesh,
                           mode=mode)
    assert layout.expert_axis == gate[1] == down[1]
    assert layout.leaf_spec(4)[:3] == (None, gate[1], None)
    ref_data = {gate[2], gate[3], down[2], down[3]} - {None}
    if mode == "serve" and layout.data_axis is not None:
        # the same split of e_gate / e_up; e_down's output dim for F
        assert (gate[2], gate[3]) == (None, "data")
        assert (down[2], down[3]) == ("data", None)
    if mode == "serve_ep" and layout.data_axis is not None:
        # every contracting dim in the reference, every output dim here
        assert (gate[2], gate[3]) == ("data", None)
        assert (down[2], down[3]) == ("data", None)
    if layout.data_axis is not None:
        assert ref_data == {"data"}
        assert layout.leaf_spec(4) == (None, gate[1], None, "data")
        # the reference's rank holds the same bytes
        A = mesh.shape["data"] * (mesh.shape["model"] if gate[1] else 1)
        assert layout.nbytes(1) * A == 3 * e * d * f * 2
    else:
        # the port splits on "data" only where both output dims divide
        assert not (f % mesh.shape.get("data", 1) == 0
                    and d % mesh.shape.get("data", 1) == 0
                    and mesh.shape.get("data", 1) > 1)
    assert sharding.expert_layout(mesh, e, d, f, dense=False,
                                  mode=mode).data_axis is None


def test_layout_refuses_an_unknown_mode_and_reads_held_shares():
    from repro_torch.runtime import sharding
    mesh = SimpleNamespace(shape={"data": 2, "model": 2},
                           coords={"data": 1, "model": 1})
    with pytest.raises(ValueError, match="serve_ep"):
        sharding.expert_layout(mesh, 4, 128, 64, mode="train")
    held = sharding.held_expert_layout(mesh, 4, 128, (2, 128, 32),
                                       (2, 64, 64))
    assert (held.expert_axis, held.data_axis, held.offset) == \
        ("model", "data", 2)
    whole = sharding.held_expert_layout(mesh, 4, 128, (4, 128, 64),
                                        (4, 64, 128))
    assert (whole.expert_axis, whole.data_axis) == (None, None)
    with pytest.raises(ValueError, match="no expert layout"):
        sharding.held_expert_layout(mesh, 4, 128, (3, 128, 64),
                                    (3, 64, 128))
    with pytest.raises(ValueError, match="no expert layout"):
        sharding.held_expert_layout(mesh, 4, 128, (4, 128, 32),
                                    (4, 64, 128))


@pytest.mark.parametrize("k,n,m", [(128, 384, 3), (200, 300, 5),
                                   (4096 // 16, 6400 // 8, 2)])
def test_column_slice_of_the_canonical_product_is_bitwise(k, n, m):
    """A rank's output columns of ``tiled_matmul_ref`` (any start and
    width, tile-aligned or not) are the whole product's columns bit for
    bit: each output's k order is whole."""
    from repro_torch.kernels.ref import tiled_matmul_ref
    gen = torch.Generator().manual_seed(k + n)
    x = torch.randn((m, k), generator=gen).bfloat16()
    w = (torch.randn((k, n), generator=gen) * 0.05).bfloat16()
    whole = tiled_matmul_ref(x, w)
    for lo, hi in ((0, n // 2), (n // 2, n), (37, 37 + n // 3), (0, n)):
        part = tiled_matmul_ref(x, w[:, lo:hi].clone())
        assert torch.equal(_bits(part), _bits(whole[:, lo:hi])), (lo, hi)


def _expert_stack(e=4, d=128, f=64, layers=2, shards=4):
    from repro_torch.core.codec_api import Codec
    gen = torch.Generator().manual_seed(5)
    w = (torch.randn((layers, e, d, f), generator=gen) * 0.05).bfloat16()
    codec = Codec(block_elems=BLOCK_ELEMS)
    return w, codec, codec.compress_stacked(w, shards=shards)


@pytest.mark.parametrize("A,coord", [(2, 0), (2, 1), (4, 3)])
def test_localize_ct_decodes_the_ranks_experts(A, coord):
    from repro_torch.core.api import slice_stacked
    from repro_torch.runtime import collectives, sharding
    w, codec, ct = _expert_stack()
    mesh = SimpleNamespace(shape={"data": 1, "model": A},
                           coords={"data": 0, "model": coord},
                           axis_index=lambda a: coord if a == "model" else 0)
    layout = sharding.expert_layout(mesh, 4, 128, 64, dense=False)
    for held in (ct, collectives.place_ct(ct, mesh)):
        local = collectives.localize_ct(held, layout)
        assert local.shards == 4 // A and tuple(local.shape) == (4 // A, 128,
                                                                64)
        assert not collectives.is_placed(local)
        lo = coord * 4 // A
        for layer in range(2):
            got = codec.decompress_array(slice_stacked(local, layer))
            assert torch.equal(got.view(torch.int16),
                               w[layer, lo:lo + 4 // A].view(torch.int16))
        assert local.nbytes_device() * A == ct.nbytes_device()


def test_localize_ct_refuses_shards_that_cut_an_expert():
    from repro_torch.runtime import collectives, sharding
    mesh = SimpleNamespace(shape={"data": 1, "model": 2},
                           coords={"data": 0, "model": 0},
                           axis_index=lambda a: 0)
    # 4 experts of 128 x 66 elements: 33 blocks of 1024 pad to 34, 17 a
    # shard, so the second shard starts inside the third expert
    _, _, ct = _expert_stack(e=4, d=128, f=66, shards=2)
    layout = sharding.expert_layout(mesh, 4, 128, 66, dense=False)
    with pytest.raises(ValueError, match="expert boundaries"):
        collectives.localize_ct(ct, layout)
    _, _, ct = _expert_stack(shards=3)
    with pytest.raises(ValueError, match="multiple of 2"):
        collectives.localize_ct(ct, layout)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _steps_scenario(mesh) -> dict:
    """``build_prefill_step`` / ``build_decode_step(mesh=)`` of the smoke
    phi3.5 in dense mode with the batch's rows on "data": this rank's rows
    of the prefill's and one decode step's logits."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.runtime import collectives
    from repro_torch.runtime.steps import (build_decode_step,
                                           build_prefill_step)
    from repro_torch.runtime.streaming import assign_weight_modes
    cfg = get_smoke_config(STEPS_ARCH)
    model = build_model(cfg)
    tree = assign_weight_modes(model.init(device="cpu"), mode="dense",
                               min_bytes=1024)
    placed = collectives.place_serving_tree(tree, mesh)
    tokens = _prompts(cfg.vocab_size)
    before = collectives.expert_exchange_bytes()
    logits, cache = build_prefill_step(model, PROMPT + 2, mesh)(
        placed, {"tokens": tokens})
    prefill_ep = collectives.expert_exchange_bytes() - before
    step, _ = build_decode_step(model, mesh, expert_mode="serve_ep")(
        placed, cache, torch.argmax(_whole_rows(logits, mesh), -1))
    return {"prefill": logits, "step": step, "prefill_ep": prefill_ep}


def _whole_rows(t, mesh):
    """Every data rank's rows of ``t`` (a check's gather, not a path)."""
    from repro_torch.launch.mesh import gather_whole
    return gather_whole([t], [("data",) + (None,) * (t.ndim - 1)], mesh,
                        link=None)[0]


def _worker(out_dir: Path, world: int) -> None:
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    rank = int(os.environ["RANK"])
    res = {"rank": rank, "serve": {}}
    for tp, arch, mode in WORLD_RUNS[world]:
        res["serve"][tp, arch, mode] = _keep(_serve(
            SERVE + ["--arch", arch, "--mode", mode, "--tp", str(tp)]))
    if world == 4:
        res["steps"] = _steps_scenario(make_host_mesh(model=2, device="cpu"))
    else:
        deadline = time.monotonic() + TIME_LIMIT_S
        while not (out_dir / "ckpt_ready").exists():
            if time.monotonic() > deadline:
                raise TimeoutError("the checkpoint never came")
            time.sleep(0.2)
        res["restore"] = _keep(_serve(RESTORE + [str(out_dir / CKPT),
                                                 "--tp", "2"]))
    torch.save(res, out_dir / f"w{world}_rank{rank}.pt")


# ---------------------------------------------------------------------------
# the fixture: both worlds, the single-device runs and the reference
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


def _prompts(vocab: int) -> torch.Tensor:
    """The prompts ``serve.main`` draws."""
    return torch.randint(0, vocab, (BATCH, PROMPT),
                         generator=torch.Generator().manual_seed(1))


def _reference_tokens(arch: str) -> np.ndarray:
    """The reference's greedy tokens on one device (its prefill and
    ``TOKENS - 1`` decode steps, dense, eagerly) on the port's seeded
    weights as numpy arrays, for the prompts ``serve.main`` draws."""
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import build_model as jax_build_model
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.runtime.streaming import tree_map_with_path

    def to_jax(_, t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(
                jnp.bfloat16)
        return jnp.asarray(t.numpy())

    cfg = get_smoke_config(arch)
    jparams = tree_map_with_path(to_jax, build_model(cfg).init(device="cpu"))
    model = jax_build_model(jax_smoke_config(arch))
    logits, cache = model.prefill_fn(
        jparams, {"tokens": jnp.asarray(_prompts(cfg.vocab_size).numpy(),
                                        jnp.int32)}, PROMPT + TOKENS)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    for _ in range(TOKENS - 1):
        logits, cache = model.decode_fn(jparams, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    return np.stack(toks, 1)


def _single_steps() -> dict:
    """One device's prefill and decode-step logits of the mesh steps'
    scenario."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.runtime.streaming import assign_weight_modes
    cfg = get_smoke_config(STEPS_ARCH)
    model = build_model(cfg)
    tree = assign_weight_modes(model.init(device="cpu"), mode="dense",
                               min_bytes=1024)
    logits, cache = model.prefill_fn(
        tree, {"tokens": _prompts(cfg.vocab_size)}, PROMPT + 2)
    step, _ = model.decode_fn(tree, cache, torch.argmax(logits, -1))
    return {"prefill": logits, "step": step}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("ep")
    procs = {w: _start_world(out_dir, w) for w in WORLD_RUNS}
    deadline = time.monotonic() + TIME_LIMIT_S
    ckpt = str(out_dir / CKPT)
    try:
        single = {(arch, mode): _keep(_serve(
            SERVE + ["--arch", arch, "--mode", mode, "--shards", "2"]
            + (["--save-ckpt", ckpt] if (arch, mode) == (STEPS_ARCH,
                                                         "stream") else [])))
            for arch in ARCHS for mode in MODES}
        (out_dir / "ckpt_ready").touch()
        single["restore"] = _keep(_serve(RESTORE + [ckpt, "--shards", "2"]))
        single["steps"] = _single_steps()
        refs = {arch: _reference_tokens(arch) for arch in ARCHS}
    finally:
        (out_dir / "ckpt_ready").touch()
        ranks = {w: _join_world(p, out_dir, w, deadline)
                 for w, p in procs.items()}
    return ranks, single, refs


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _runs():
    return [(w, *run) for w, runs in WORLD_RUNS.items() for run in runs]


def _layout_of(run, arch, mode, rank):
    from repro_torch.configs import get_smoke_config
    from repro_torch.runtime import sharding
    cfg = get_smoke_config(arch)
    tp = run["mesh"]["model"]
    mesh = SimpleNamespace(shape=run["mesh"], coords={"model": rank % tp,
                                                      "data": rank // tp})
    return cfg, sharding.expert_layout(mesh, cfg.n_experts, cfg.d_model,
                                       cfg.moe_d_ff, dense=mode == "dense")


@pytest.mark.parametrize("world,tp,arch,mode", _runs())
def test_ep_serve_bitwise_to_one_device(worlds, world, tp, arch, mode):
    """Every rank's logits equal one device's bit for bit, and its greedy
    tokens the reference's on the same weights and prompts."""
    ranks, single, refs = worlds
    want = single[arch, mode]
    for r in ranks[world]:
        got = r["serve"][tp, arch, mode]
        assert got["mesh"] == {"data": world // tp, "model": tp}
        assert torch.equal(_bits(got["logits"]), _bits(want["logits"]))
        np.testing.assert_array_equal(got["tokens"].numpy(), refs[arch])


@pytest.mark.parametrize("world,tp,arch,mode", _runs())
def test_ep_serve_holds_its_share_and_gathers_no_expert(worlds, world, tp,
                                                        arch, mode):
    """Each rank holds 1/A of the expert bytes (A its experts' and
    columns' ranks) and the ranks together hold them all; no expert stack
    is left placed to gather: a step gathers (A - 1) x the other placed
    streams' bytes, nothing more, and the MoE blocks exchange the layout's
    formula's activation bytes (2 rows, capacity 1, an f32 combine)."""
    ranks, single, _ = worlds
    whole = single[arch, mode]["expert_placement"]
    assert whole["placed"] == 0 and whole["bytes"] > 0
    held = []
    for r in ranks[world]:
        got = r["serve"][tp, arch, mode]
        cfg, layout = _layout_of(got, arch, mode, r["rank"])
        share = layout.expert_count * layout.data_count
        assert share == (world if mode == "dense" else tp)
        placement = got["expert_placement"]
        assert placement["placed"] == 0
        assert placement["bytes"] * share == whole["bytes"]
        assert placement["stream_nbytes"] == whole["stream_nbytes"]
        assert placement["layout"] == layout.describe()
        held.append(placement["bytes"])
        assert got["step_gather_bytes"] == \
            [(tp - 1) * got["gather_nbytes"]] * (TOKENS - 1)
        assert (placement["stream_nbytes"] > 0) == (mode != "dense")
        assert got["step_ep_bytes"] == [
            cfg.n_layers * layout.exchange_bytes(BATCH, 1, 4)] * (TOKENS - 1)
        assert got["links"]["d2d_allgather"]["dense_bytes"] == 0
    assert sum(held) == whole["bytes"] * world // share


def test_mesh_restore_uploads_each_ranks_own_experts(worlds):
    """A stream checkpoint (``--shards 2``) restored onto 2 ranks: each
    rank uploads its shard rows of every placed record, its own experts'
    of the expert stacks (over the ranks, the single-device restore's
    bytes of those records, each about half), holds half the expert bytes
    and gathers none of them; logits bitwise the single-device restore's,
    tokens the reference's."""
    from repro_torch.runtime.sharding import is_expert_leaf
    ranks, single, refs = worlds
    want = single["restore"]
    one = want["restore"]["record_h2d"]
    placed = ranks[2][0]["restore"]["restore"]["placed_records"]
    experts = [n for n in placed if is_expert_leaf(n)]
    assert len(experts) == 3
    for r in ranks[2]:
        got = r["restore"]
        assert torch.equal(_bits(got["logits"]), _bits(want["logits"]))
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      refs[STEPS_ARCH])
        assert got["restore"]["placed_records"] == placed
        placement = got["expert_placement"]
        assert placement["placed"] == 0
        assert 2 * placement["bytes"] == want["expert_placement"]["bytes"]
        assert got["step_gather_bytes"] == [got["gather_nbytes"]] * (
            TOKENS - 1)
    for rec in placed:
        mine = [r["restore"]["restore"]["record_h2d"][rec]
                for r in ranks[2]]
        assert sum(mine) == one[rec], rec
        assert all(abs(2 * m - one[rec]) <= 0.05 * one[rec]
                   for m in mine), (rec, mine, one[rec])


def test_mesh_steps_with_rows_on_data_bitwise(worlds):
    """The rows on "data" (rank (d, m) holds row d): the dispatch
    gathers the own experts' rows over "data" and the return is one
    all-to-all; each rank's prefill and decode-step rows are one device's
    bit for bit, and the prefill exchanged activation bytes."""
    ranks, single, _ = worlds
    want = single["steps"]
    for r in ranks[4]:
        d = r["rank"] // 2
        got = r["steps"]
        for key in ("prefill", "step"):
            assert torch.equal(_bits(got[key]), _bits(want[key][d:d + 1]))
        assert got["prefill_ep"] > 0


@pytest.mark.parametrize("variant", ["ep_contract", "ep_contract_bf16",
                                     "ep_a2a"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_dryrun_ep_cells_run(tmp_path, variant, kind):
    """The ``ep_*`` cells run (no longer skipped) on a 2x2 abstract mesh:
    rank 0 holds the formula's expert bytes, a quarter of the pool; the
    program line names the layout and ``serve_ep``; the return's
    all-to-all over "data" is recorded."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    arch = "phi3_5_moe_42b_a6_6b"
    shape = ShapeSpec("decode_32k", 32, 2, "decode") if kind == "decode" \
        else ShapeSpec("prefill_32k", 16, 2, "prefill")
    rec = dryrun.run_cell(arch, shape.name, tmp_path, ["single"],
                          variant=variant, mesh_shape=(2, 2),
                          cfg=get_smoke_config(arch), shape=shape)
    assert rec["status"] == "ok", rec
    full = rec["single"]["full"]
    experts = full["experts"]
    assert experts["bytes"] == experts["formula_bytes"] \
        == experts["whole_bytes"] // 4
    assert "serve_ep" in full["program"] and "MoE experts" in full["program"]
    assert full["collectives"]["all-to-all"]["count"] == 2   # its 2 layers


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, str(ROOT / "src"))
    _worker(Path(sys.argv[2]), int(sys.argv[3]))
    torch.distributed.destroy_process_group()
