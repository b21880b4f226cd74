"""The port's serving mesh (``launch/mesh.py``, ``runtime/collectives.py``,
``serve --tp``) in a gloo world of 4 CPU ranks, against the port on one
device and the reference's greedy tokens.

One module fixture starts the world once (4 processes, one thread each,
under a time limit of their own) and runs every scenario in it; the tests
assert on what the ranks sent back:

  * ``gather_ct`` and ``shard_local_decode`` bitwise for bf16, fp16 and
    fp32 (and a stacked tensor), with the ``d2d_allgather`` ledger's bytes
    (``(A - 1) x stream_nbytes``, no dense byte) and ops;
  * ``place_serving_tree`` leaving each rank only its shard's rows;
  * the smoke llama through ``serve.main --tp`` on meshes (1, 4) and
    (2, 2), dense / stream / fused with overlap off and on: every rank's
    logits bitwise equal to the single-device port's with the same
    ``--shards``, greedy tokens equal to the reference's on the same
    weights and prompts, a step's gathered bytes ``(A - 1)`` times the
    placed streams' ``stream_nbytes``;
  * a mesh restore of a stream checkpoint written by each package
    (``--shards 4``): logits bitwise, each rank's h2d bytes of the placed
    records summing over the ranks to the single-device restore's;
  * the K/V ring sequence-sharded: ``serve --tp 2`` (fused) with a
    2048-position ring and a prompt of 2044 that crosses the ranks'
    boundary at 1024, in both decode-attention routes (the scores
    gathered; the config's ``decode_score_shard``): each rank holding its
    half of one device's ring, logits bitwise one device's, greedy
    tokens the reference's, the flash route gathering fewer bytes;
  * no-op gathers of raw, const, unsharded and indivisible tensors, and
    the refusals (``--tp`` beyond the world, an expert store on a mesh).

The serve runs use 1024-element blocks (``serve.Codec`` patched in the
ranks and here alike) so the smoke layer leaves stream and shard; fused
tiles keep their 16384-element blocks, so in fused mode only the embedding
shards, as in the reference at this size.  The reference's own sharded
serve is not run: it fails on this JAX (ROADMAP, Queue 3).
"""
import contextlib
import dataclasses
import functools
import io
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIME_LIMIT_S = 300
BLOCK_ELEMS = 1024
SERVE = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "12",
         "--tokens", "4", "--min-bytes", "1024"]
RUNS = [("dense", "off"), ("stream", "off"), ("stream", "on"),
        ("fused", "off"), ("fused", "on")]
TPS = (4, 2)
# the sequence-sharded ring: max_len 2048 = 2 ranks x 1024 positions
SP_SERVE = ["--smoke", "--device", "cpu", "--batch", "1", "--prompt-len",
            "2044", "--tokens", "4", "--min-bytes", "1024", "--mode",
            "fused"]
SP_ROUTES = ("scores", "flash")
DTYPES = ("bfloat16", "float16", "float32")
CKPTS = ("port", "reference")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's torch work on one thread, as the suite runs it
    beside other workers on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def _serve(argv):
    """``serve.main`` with 1024-element blocks, quietly."""
    from repro_torch.core.codec_api import Codec
    from repro_torch.launch import serve
    serve.Codec = functools.partial(Codec, block_elems=BLOCK_ELEMS)
    try:
        return _quiet(serve.main, argv)
    finally:
        serve.Codec = Codec


def _keep(out) -> dict:
    keys = ("logits", "tokens", "links", "step_gather_bytes",
            "gather_nbytes", "overlap", "mode_mix", "mesh", "restore",
            "ring_bytes", "kv_layout", "step_kv_bytes")
    return {k: out[k] for k in keys}


def _serve_route(argv, route: str):
    """:func:`_serve` with the smoke config's ``decode_score_shard`` set
    for the flash route (serve has no flag for it: the config selects
    it, as in the reference)."""
    from repro_torch.launch import serve
    if route == "scores":
        return _serve(argv)
    config = serve.get_smoke_config
    serve.get_smoke_config = lambda arch: dataclasses.replace(
        config(arch), decode_score_shard=True)
    try:
        return _serve(argv)
    finally:
        serve.get_smoke_config = config


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _codec_scenarios(mesh) -> dict:
    from repro_torch.core.codec_api import Codec, use_codec
    from repro_torch.runtime import collectives as col
    rng = np.random.default_rng(0)
    x32 = rng.standard_normal((64, 4096)).astype(np.float32)
    out = {}
    for name in DTYPES:
        x = torch.from_numpy(x32).to(getattr(torch, name))
        c = Codec()
        ct = c.compress_array(x, shards=4)      # 16 blocks: 4 a rank
        placed = col.place_ct(ct, mesh)
        c.reset_transfer_stats()
        g = col.gather_ct(placed, mesh, codec=c)
        link = c.link_stats()["d2d_allgather"]
        with use_codec(c), col.use_serving_mesh(mesh):
            ambient = col.maybe_gather_ct(placed, c)
        out[name] = {
            "mode": ct.mode, "own_rows": placed.streams.mask.shape[0],
            "streams_equal": all(torch.equal(a, b) for a, b in
                                 zip(g.streams, ct.streams)),
            "ambient_equal": all(torch.equal(a, b) for a, b in
                                 zip(ambient.streams, ct.streams)),
            "identity_without_mesh": col.maybe_gather_ct(placed, c)
            is placed,
            "decode_equal": torch.equal(c.decompress_array(g),
                                        c.decompress_array(ct)),
            "link": link, "stream_nbytes": col.stream_nbytes(ct),
            "n_arrays": len(ct.streams),
            "piece": col.shard_local_decode(placed, mesh, codec=c),
            "piece_of_whole": col.shard_local_decode(ct, mesh, codec=c),
            "whole": c.decompress_array(ct).reshape(-1)}
    # a layer stack: the shard dim is 1, each owner's rows strided
    x = torch.from_numpy(rng.standard_normal((2, 256, 1024)).astype(
        np.float32)).to(torch.bfloat16)
    c = Codec()
    ct = c.compress_stacked(x, shards=4)
    g = col.gather_ct(col.place_ct(ct, mesh), mesh, codec=c)
    out["stacked"] = {"mode": ct.mode, "streams_equal": all(
        torch.equal(a, b) for a, b in zip(g.streams, ct.streams)),
        "link": c.link_stats()["d2d_allgather"],
        "stream_nbytes": col.stream_nbytes(ct)}
    # no-ops, and the refusals of shard_local_decode
    c = Codec()
    noop = {"const": c.compress_array(torch.ones((128, 128),
                                                 dtype=torch.bfloat16)),
            "raw": c.compress_array(torch.arange(64, dtype=torch.int32)),
            "unsharded": c.compress_array(x[0]),
            "indivisible": c.compress_array(x[0], shards=3)}
    out["noop"] = {k: (col.gather_ct(t, mesh, codec=c) is t
                       and col.place_ct(t, mesh) is t)
                   for k, t in noop.items()}
    out["noop_ops"] = c.link_stats()["d2d_allgather"]["ops"]
    refusals = {}
    for k, t in (("raw", noop["raw"]), ("unsharded", noop["unsharded"]),
                 ("indivisible", noop["indivisible"]), ("stacked", ct)):
        try:
            col.shard_local_decode(t, mesh, codec=c)
            refusals[k] = None
        except ValueError as e:
            refusals[k] = str(e)
    out["refusals"] = refusals
    return out


def _place_scenario(mesh) -> dict:
    """The smoke llama's stream tree placed: each sharded stream keeps this
    rank's rows (``local_shard`` of the whole under its spec), the rest is
    the whole tree's own tensors."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.codec_api import Codec, use_codec
    from repro_torch.models import build_model
    from repro_torch.runtime import collectives as col
    from repro_torch.runtime import sharding
    from repro_torch.runtime.streaming import assign_weight_modes
    cfg = get_smoke_config("llama3_2_1b")
    codec = Codec(block_elems=BLOCK_ELEMS)
    with use_codec(codec):
        tree = assign_weight_modes(build_model(cfg).init(device="cpu"),
                                   mode="stream", min_bytes=1024, shards=4,
                                   codec=codec)
    placed = col.place_serving_tree(tree, mesh)
    whole = dict(col.tree_leaves(tree))
    sharded = kept = 0
    rows_ok = same_ok = True
    local = total = 0
    for path, leaf in col.tree_leaves(placed):
        ct = getattr(leaf, "ct", None)
        if ct is not None and col.is_placed(ct):
            sharded += 1
            specs = sharding.ct_pspecs(whole[path].ct, mesh)
            for a, b, spec in zip(ct.streams, whole[path].ct.streams, specs):
                rows_ok &= torch.equal(a, sharding.local_shard(b, spec,
                                                               mesh))
                local += a.numel() * a.element_size()
                total += b.numel() * b.element_size()
        else:
            kept += 1
            same_ok &= leaf is whole[path]
    return {"sharded": sharded, "kept": kept, "rows_ok": rows_ok,
            "same_ok": same_ok, "local_bytes": local, "whole_bytes": total}


def _worker(out_dir: Path) -> None:
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    mesh4 = make_host_mesh(model=4, device="cpu")
    mesh22 = make_host_mesh(model=2, device="cpu")
    res = {"rank": mesh4.rank, "backend": torch.distributed.get_backend(),
           "mesh4": (mesh4.shape, mesh4.coords, mesh4.axis_ranks("model")),
           "mesh22": (mesh22.shape, mesh22.coords,
                      mesh22.axis_ranks("model"), mesh22.axis_ranks("data")),
           "codec": _codec_scenarios(mesh4), "place": _place_scenario(mesh4),
           "serve": {}, "restore": {}, "sp": {}}
    for tp in TPS:
        for mode, overlap in RUNS:
            res["serve"][tp, mode, overlap] = _keep(_serve(
                SERVE + ["--tp", str(tp), "--mode", mode,
                         "--overlap", overlap]))
    for route in SP_ROUTES:
        res["sp"][route] = _keep(_serve_route(SP_SERVE + ["--tp", "2"],
                                              route))
    deadline = time.monotonic() + TIME_LIMIT_S
    while not (out_dir / "ckpts_ready").exists():
        if time.monotonic() > deadline:
            raise TimeoutError("the checkpoints never came")
        time.sleep(0.2)
    for name in CKPTS:
        res["restore"][name] = _keep(_serve(
            SERVE + ["--tp", "4", "--mode", "stream",
                     "--ckpt", str(out_dir / name)]))
    try:
        _serve(["--arch", "phi3_5_moe_42b_a6_6b", "--expert-cache-mb", "0",
                "--tp", "4"] + SERVE)
        res["store_refusal"] = None
    except ValueError as e:
        res["store_refusal"] = str(e)
    torch.save(res, out_dir / f"rank{res['rank']}.pt")


# ---------------------------------------------------------------------------
# the fixture: the world, the single-device runs and the reference
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_world(out_dir: Path) -> list:
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), os.environ.get("PYTHONPATH",
                                                          "")]))
        log = open(out_dir / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, "--worker", str(out_dir)], env=env,
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _join_world(procs, out_dir: Path) -> list:
    deadline = time.monotonic() + TIME_LIMIT_S
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
    assert not failed, "rank(s) %s failed:\n%s" % (failed, "\n".join(
        (out_dir / f"rank{r}.log").read_text()[-3000:] for r in failed))
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _port_prompts(vocab: int, batch: int = 2, length: int = 12
                  ) -> torch.Tensor:
    """The prompts ``serve.main`` draws."""
    return torch.randint(0, vocab, (batch, length),
                         generator=torch.Generator().manual_seed(1))


def _reference_tokens(jparams, prompts, max_len: int = 16) -> np.ndarray:
    """The reference's greedy tokens on one device: its prefill and three
    decode steps, dense, on the same weights and prompts (batch, 4)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import build_model as jax_build_model
    model = jax_build_model(jax_smoke_config("llama3_2_1b"))
    logits, cache = model.prefill_fn(
        jparams, {"tokens": jnp.asarray(prompts.numpy(), jnp.int32)},
        max_len)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    for _ in range(3):
        logits, cache = model.decode_fn(jparams, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    return np.stack(toks, 1)


def _to_jax(tree):
    """The port's tensors as the reference's arrays (bf16 by its bits)."""
    import jax.numpy as jnp
    from repro_torch.runtime.streaming import tree_map_with_path

    def one(_, t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    return tree_map_with_path(one, tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("mesh")
    procs = _start_world(out_dir)
    try:
        single, refs = _single_device_side(out_dir)
    finally:
        (out_dir / "ckpts_ready").touch()
        ranks = _join_world(procs, out_dir)
    return ranks, single, refs


def _single_device_side(out_dir: Path) -> tuple:
    """While the ranks run: both packages' checkpoints (written first, the
    ranks wait for them), the single-device port runs of the same
    arguments, and the reference's tokens."""
    import jax.numpy as jnp
    from repro.checkpoint.ckpt import CheckpointManager as JaxManager
    from repro.core.codec_api import Codec as JaxCodec
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.lm import abstract_params
    from repro_torch.runtime.streaming import tree_map_with_path
    cfg = get_smoke_config("llama3_2_1b")
    single = {}
    out = _serve(SERVE + ["--mode", "stream", "--shards", "4",
                          "--save-ckpt", str(out_dir / "port")])
    single[4, "stream"] = _keep(out)
    rng = np.random.default_rng(3)
    jparams = tree_map_with_path(
        lambda _, m: jnp.asarray(
            (rng.standard_normal(tuple(m.shape)) * 0.02).astype(np.float32),
            jnp.dtype(str(m.dtype).split(".")[-1])), abstract_params(cfg))
    JaxManager(out_dir / "reference", serving_layout="stream",
               serving_min_bytes=1024, serving_shards=4,
               codec=JaxCodec(block_elems=BLOCK_ELEMS)).save(
        0, {"params": jparams}, blocking=True)
    (out_dir / "ckpts_ready").touch()
    for shards in TPS:
        for mode in ("dense", "stream", "fused"):
            if (shards, mode) not in single:
                single[shards, mode] = _keep(_serve(
                    SERVE + ["--mode", mode, "--shards", str(shards)]))
    for name in CKPTS:
        single["restore", name] = _keep(_serve(
            SERVE + ["--mode", "stream", "--shards", "4",
                     "--ckpt", str(out_dir / name)]))
    single["sp"] = _keep(_serve(SP_SERVE + ["--shards", "2"]))
    prompts = _port_prompts(cfg.vocab_size)
    port = _to_jax(build_model(cfg).init(device="cpu"))
    refs = {"port": _reference_tokens(port, prompts),
            "reference": _reference_tokens(jparams, prompts),
            "sp": _reference_tokens(port, _port_prompts(
                cfg.vocab_size, 1, 2044), 2048)}
    return single, refs


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_world_of_four_ranks_on_gloo(world):
    ranks, _, _ = world
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    assert {r["backend"] for r in ranks} == {"gloo"}
    for r in ranks:
        shape, coords, model = r["mesh4"]
        assert shape == {"data": 1, "model": 4}
        assert coords == {"data": 0, "model": r["rank"]}
        assert model == (0, 1, 2, 3)
        shape, coords, model, data = r["mesh22"]
        assert shape == {"data": 2, "model": 2}
        assert coords == {"data": r["rank"] // 2, "model": r["rank"] % 2}
        assert model == (2 * (r["rank"] // 2), 2 * (r["rank"] // 2) + 1)
        assert data == (r["rank"] % 2, r["rank"] % 2 + 2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_ct_bitwise_with_its_ledger(world, dtype):
    """Every rank ends with the whole streams, bit for bit; the ledger
    holds (A - 1) x stream_nbytes compressed bytes, no dense byte, and one
    op a stream array, as the reference counts one gather."""
    ranks, _, _ = world
    for r in ranks:
        res = r["codec"][dtype]
        assert res["mode"] == "enec" and res["own_rows"] == 1
        assert res["streams_equal"] and res["decode_equal"]
        assert res["ambient_equal"] and res["identity_without_mesh"]
        assert res["link"] == {
            "compressed_bytes": (WORLD - 1) * res["stream_nbytes"],
            "dense_bytes": 0, "ops": res["n_arrays"]}


@pytest.mark.parametrize("dtype", DTYPES)
def test_shard_local_decode_pieces_are_the_whole_decode(world, dtype):
    ranks, _, _ = world
    whole = ranks[0]["codec"][dtype]["whole"]
    pieces = [r["codec"][dtype]["piece"] for r in ranks]
    assert torch.equal(torch.cat(pieces).view(torch.uint8),
                       whole.view(torch.uint8))
    for r in ranks:
        res = r["codec"][dtype]
        assert torch.equal(res["piece"].view(torch.uint8),
                           res["piece_of_whole"].view(torch.uint8))


def test_stacked_gather_bitwise(world):
    ranks, _, _ = world
    for r in ranks:
        res = r["codec"]["stacked"]
        assert res["mode"] == "enec" and res["streams_equal"]
        assert res["link"]["compressed_bytes"] == \
            (WORLD - 1) * res["stream_nbytes"]


@pytest.mark.parametrize("kind", ["const", "raw", "unsharded",
                                  "indivisible"])
def test_gather_is_a_no_op_where_nothing_shards(world, kind):
    ranks, _, _ = world
    for r in ranks:
        assert r["codec"]["noop"][kind]
        assert r["codec"]["noop_ops"] == 0


@pytest.mark.parametrize("kind", ["raw", "unsharded", "indivisible",
                                  "stacked"])
def test_shard_local_decode_refuses(world, kind):
    ranks, _, _ = world
    want = {"raw": "enec tensor", "unsharded": "unsharded",
            "indivisible": "not divisible", "stacked": "per-layer"}[kind]
    for r in ranks:
        assert want in (r["codec"]["refusals"][kind] or "")


def test_place_serving_tree_keeps_each_ranks_rows(world):
    ranks, _, _ = world
    for r in ranks:
        p = r["place"]
        assert p["sharded"] == 8 and p["kept"] > 0
        assert p["rows_ok"] and p["same_ok"]
        assert p["local_bytes"] * WORLD == p["whole_bytes"]


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("mode,overlap", RUNS)
@pytest.mark.parametrize("tp", TPS)
def test_mesh_serve_bitwise_to_one_device(world, tp, mode, overlap):
    """Every rank's logits equal the single-device port's with the same
    ``--shards`` (the mesh's model width), and its greedy tokens the
    reference's on the same weights and prompts."""
    ranks, single, refs = world
    want = single[tp, mode]
    for r in ranks:
        got = r["serve"][tp, mode, overlap]
        assert got["mesh"] == {"data": WORLD // tp, "model": tp}
        assert torch.equal(_bits(got["logits"]), _bits(want["logits"]))
        np.testing.assert_array_equal(got["tokens"].numpy(), refs["port"])
        assert got["overlap"]["enabled"] == (mode == "stream"
                                             and overlap == "on")


@pytest.mark.parametrize("mode,overlap", RUNS)
@pytest.mark.parametrize("tp", TPS)
def test_mesh_serve_gathers_compressed_bytes_only(world, tp, mode, overlap):
    """No dense byte crosses between ranks; each decode step gathers every
    placed stream once: (A - 1) x their stream_nbytes."""
    ranks, _, _ = world
    for r in ranks:
        got = r["serve"][tp, mode, overlap]
        link = got["links"]["d2d_allgather"]
        assert link["dense_bytes"] == 0
        if mode == "dense":
            assert got["gather_nbytes"] == 0 and link["ops"] == 0
            continue
        assert got["gather_nbytes"] > 0
        assert got["step_gather_bytes"] == \
            [(tp - 1) * got["gather_nbytes"]] * 3
        # the prefills (one a request) gather as much as a step
        assert link["compressed_bytes"] == (2 + 3) * (tp - 1) * \
            got["gather_nbytes"]


@pytest.mark.parametrize("name", CKPTS)
def test_mesh_restore_bitwise_with_own_uploads(world, name):
    """A stream checkpoint (``--shards 4``) written by either package,
    restored onto the (1, 4) mesh: logits bitwise equal to the
    single-device restore, tokens the reference's; each rank uploaded
    only its shards of the placed records: over the ranks, the
    single-device restore's bytes of those records, each rank about a
    quarter."""
    ranks, single, refs = world
    want = single["restore", name]
    one = want["restore"]["record_h2d"]
    placed = ranks[0]["restore"][name]["restore"]["placed_records"]
    assert len(placed) == 8
    for r in ranks:
        got = r["restore"][name]
        assert torch.equal(_bits(got["logits"]), _bits(want["logits"]))
        np.testing.assert_array_equal(got["tokens"].numpy(), refs[name])
        assert got["restore"]["placed_records"] == placed
        assert got["links"]["d2d_allgather"]["dense_bytes"] == 0
    for rec in placed:
        mine = [r["restore"][name]["restore"]["record_h2d"][rec]
                for r in ranks]
        assert sum(mine) == one[rec], rec
        assert all(abs(m * WORLD - one[rec]) <= 0.02 * one[rec]
                   for m in mine), (rec, mine, one[rec])
    total = sum(one[rec] for rec in placed)
    for r in ranks:
        h2d = r["restore"][name]["restore"]["record_h2d"]
        assert abs(sum(h2d[rec] for rec in placed) * WORLD - total) \
            <= 0.02 * total


@pytest.mark.parametrize("route", SP_ROUTES)
def test_sequence_sharded_ring_bitwise_to_one_device(world, route):
    """``serve --tp 2`` on the (2, 2) mesh over a 2048-position ring: each
    rank holds its model coordinate's 1024 positions, half of one
    device's ring; its logits are one device's bit for bit and its greedy
    tokens the reference's, the prompt and the decoded positions crossing
    the ranks' boundary at 1024; every step's decode attention gathered
    dense bytes over the model axis."""
    ranks, single, refs = world
    want = single["sp"]
    assert want["kv_layout"] is None and want["ring_bytes"] > 0
    for r in ranks:
        got = r["sp"][route]
        assert got["mesh"] == {"data": 2, "model": 2}
        assert got["kv_layout"] == {
            "sharded": True, "axes": ["model"], "positions": 1024,
            "offset": 1024 * (r["rank"] % 2), "why": ""}
        assert 2 * got["ring_bytes"] == want["ring_bytes"]
        assert torch.equal(_bits(got["logits"]), _bits(want["logits"]))
        np.testing.assert_array_equal(got["tokens"].numpy(), refs["sp"])
        assert len(got["step_kv_bytes"]) == 3
        assert all(b > 0 for b in got["step_kv_bytes"])
        assert got["links"]["d2d_allgather"]["dense_bytes"] \
            == sum(got["step_kv_bytes"])


def test_flash_route_gathers_fewer_bytes(world):
    """A step of the flash route (maxima, denominator and P.V partials)
    gathers fewer bytes than the scores route (the scores and the P.V
    partials), the same on every step and rank."""
    ranks, _, _ = world
    steps = {route: {b for r in ranks for b in r["sp"][route][
        "step_kv_bytes"]} for route in SP_ROUTES}
    assert all(len(v) == 1 for v in steps.values())
    assert max(steps["flash"]) < max(steps["scores"])


def test_expert_store_refuses_a_mesh(world):
    ranks, _, _ = world
    for r in ranks:
        assert "does not compose with --tp" in (r["store_refusal"] or "")


def test_tp_beyond_the_world_names_the_launcher():
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="torch.distributed.run "
                                         "--nproc-per-node 2"):
        _quiet(serve.main, SERVE + ["--tp", "2"])


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, str(ROOT / "src"))
    _worker(Path(sys.argv[2]))
    torch.distributed.destroy_process_group()
