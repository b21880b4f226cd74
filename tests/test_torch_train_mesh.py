"""The port's training mesh (``runtime/elastic.py``,
``optim/grad_compress.py``, the mesh step of ``runtime/steps.py``, the
collective checkpoint save and the elastic restore, ``train --mesh``) in a
gloo world of 4 CPU ranks, against the port on one device and the
reference.

One module fixture starts the world once (4 processes, one thread each,
under a time limit of their own) and runs every scenario in it; the tests
assert on what the ranks sent back:

  * ``compressed_allreduce`` over a 4-rank axis and over the "data" axis
    of a (2, 2) mesh in bf16, fp16 and fp32, at a size that is not a
    multiple of the block: bitwise equal on every rank to the rank-ordered
    f32 sum cast back, each rank's streams byte-identical to the
    reference's ``encode_blocks(to_blocks(...))`` of its input, and
    ``d2d_psum`` counted as the reference counts it;
  * the smoke llama trained 3 steps on meshes (1, 4), (2, 2) and (4, 1):
    on (1, 4) bitwise equal to the single-device port, elsewhere every
    rank's gathered state bitwise equal to every other's and the losses
    within LOSS_RTOL of one device's; each rank's resident leaves are the
    shapes of ``local_shard`` under ``param_pspecs(mode="train")``, as
    tensors of their own;
  * the (2, 2) run's collective save byte-identical, file by file, to a
    single-device save of the same gathered state; a single-device
    checkpoint of step 2 resumed on (1, 4) to step 4 bitwise equal to the
    uninterrupted single-device run; a checkpoint of the reference's
    single-device ``train_loop`` (saved uncompressed: its eager encoder
    costs seconds a leaf shape, and the mesh restore reads any record the
    same way) restored onto (2, 2), bitwise the saved state;
  * ``train.main``: ``--mesh 2x2`` prints its mesh, the automatic mesh is
    ``best_mesh_for``'s, ``--mesh 3x1`` raises;
  * the straggler watchdog: one slow step on rank 1 only makes every rank
    strike and save at that step, and the world ends;
  * the pod axis (meshes over ("pod", "data", "model"), the reference's
    pod-DP layout): (2, 2, 1) trained bitwise as the 4-rank ("data",)
    mesh and (2, 1, 2) as (2, 2) (the gradient summed over ("pod",
    "data") in one rank-ordered f32 sum, pod-major; the pod runs sum each
    leaf in pieces of POD_REDUCE_CHUNK elements, the flat runs whole
    leaves), the two pods holding
    the same shards, each rank its (data, model) shard; the (2, 2, 1)
    save byte-identical to the one-device save; the one-device checkpoint
    of step 2 resumed on (2, 1, 2) bitwise as on (2, 2);
    ``compressed_allreduce`` over "pod" of (2, 2, 1) bitwise the
    rank-ordered sum over "pod" (the port's counterpart of the
    reference's 8-device ``test_compressed_allreduce_bit_identical_2pods``);
    the step's mean over the row blocks (``steps.mean_over_row_blocks``)
    on (2, 2, 1), over f32 blocks whose sum depends on the order (1e8, 1,
    -1e8, 1 rotated along the elements), bitwise the one pod-major sum.
"""
import contextlib
import io
import json
import os
import shutil
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
TIME_LIMIT_S = 240
MESHES = ((1, 4), (2, 2), (4, 1))
POD_AXES = ("pod", "data", "model")
# each pod mesh and the mesh it must train bitwise as: (P, D, M) as
# (P·D, M), (4,) being the 4-rank ("data",) mesh
POD_MESHES = {(2, 2, 1): (4,), (2, 1, 2): (2, 2)}
# elements a gather of the pod runs' gradient sum (``steps.REDUCE_CHUNK``):
# a smoke leaf is cut into pieces, the last one short
POD_REDUCE_CHUNK = 4099
STEPS, RESUME_FROM, RESUME_TO = 3, 2, 4
SEQ, BATCH = 16, 4
DTYPES = ("bfloat16", "float16", "float32")
AR_NUMEL, AR_BLOCK = 10_000, 4096       # 3 blocks, the last one padded
SLOW_STEP = 4
# Meshes with D > 1 average the ranks' losses and sum their bf16 gradients
# in f32, where one device reduces the whole batch at once: measured over
# the 3 steps of (2, 2) and (4, 1), the losses differ from one device's by
# at most 5.35e-6 relative (step 0: 7.6e-8 and 0), the gradient norms by
# at most 4.40e-4 (bf16 gradients rounded at another point).
LOSS_RTOL = 1e-3
# the row-block mean's check: each block's f32 elements are these values
# rotated by the block's pod-major index and the element's, so that every
# order of the four blocks gives some element another f32 sum
ROW_VALUES, ROW_NUMEL = (1e8, 1.0, -1e8, 1.0), 5000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's torch work on one thread, as the suite runs it
    beside other workers on every core (the ranks run with one thread
    too, so one device's bits are theirs)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup():
    """The smoke llama, AdamW and the data every run here shares."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    cfg = get_smoke_config("llama3_2_1b")
    opt_cfg = adamw.AdamWConfig(lr=3e-4,
                                schedule=adamw.warmup_cosine(20, RESUME_TO))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH)
    return build_model(cfg), opt_cfg, data


def _loop(steps: int, **kw):
    from repro_torch.runtime.train_loop import TrainLoopConfig
    return TrainLoopConfig(total_steps=steps, ckpt_every=1000,
                           log_every=1000, **kw)


def _train(steps: int, **kw) -> dict:
    from repro_torch.runtime import train_loop
    model, opt_cfg, data = _setup()
    with contextlib.redirect_stdout(io.StringIO()):
        return train_loop.run(model, opt_cfg, data, _loop(steps),
                              device="cpu", **kw)


def _ar_input(dtype: str, rank: int) -> torch.Tensor:
    rng = np.random.default_rng(100 + rank)
    x = rng.standard_normal(AR_NUMEL).astype(np.float32) * 1e-3
    x[rank::97] = -0.0
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _search(dtype: str):
    """One codec parameterization for every rank: searched on all the
    ranks' inputs together."""
    from repro_torch.core import search_for_array
    from repro_torch.core.dtypes import format_for
    xs = torch.cat([_ar_input(dtype, r) for r in range(WORLD)])
    fmt = format_for(xs.dtype)
    bits = xs.view(fmt.bits_dtype).numpy()
    return search_for_array(bits, fmt, block_elems=AR_BLOCK)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _allreduce_scenarios(meshes) -> dict:
    from repro_torch.core.codec_api import Codec
    from repro_torch.core.codec import to_blocks
    from repro_torch.core.dtypes import format_for, to_bits
    from repro_torch.kernels import ops
    from repro_torch.optim.grad_compress import compressed_allreduce
    out = {}
    for label, (mesh, axis) in meshes.items():
        for dtype in DTYPES:
            x, p = _ar_input(dtype, mesh.rank), _search(dtype)
            codec = Codec()
            got = compressed_allreduce(x, mesh, axis, p,
                                       block_elems=AR_BLOCK, codec=codec)
            own = ops.encode_blocks(to_blocks(to_bits(x), AR_BLOCK),
                                    format_for(x.dtype), p)
            out[label, dtype] = {"out": got, "streams": tuple(own),
                                 "link": codec.link_stats()["d2d_psum"],
                                 "ranks": mesh.axis_ranks(axis)}
    return out


def _state(out) -> dict:
    return {"params": out["params"], "opt": out["opt_state"]}


def _gathered(out) -> dict:
    from repro_torch.runtime import elastic
    return elastic.gather_tree(_state(out), out["mesh"], out["pspecs"],
                               link=None)


def _axes(shape) -> tuple:
    """The axes of a mesh of ``shape`` here: ("data",), ("data", "model")
    or ``POD_AXES``."""
    return {1: ("data",), 2: ("data", "model"), 3: POD_AXES}[len(shape)]


def _resident(out) -> dict:
    from repro_torch.core.api import tree_leaves
    return {path: (tuple(t.shape), t.is_contiguous()
                   and t.untyped_storage().nbytes()
                   == t.numel() * t.element_size())
            for path, t in tree_leaves(_state(out))}


def _launcher_scenarios(out_dir: Path) -> dict:
    from repro_torch.launch import train
    args = ["--smoke", "--device", "cpu", "--steps", "1", "--global-batch",
            str(BATCH), "--seq", str(SEQ)]
    res = {}
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        train.main(args + ["--mesh", "2x2", "--ckpt",
                           str(out_dir / "main22")])
        auto = train.main(args + ["--ckpt", str(out_dir / "main_auto")])
    res["printed"] = text.getvalue()
    res["auto_mesh"] = dict(auto["mesh"].shape)
    try:
        train.main(args + ["--mesh", "3x1", "--ckpt", str(out_dir / "bad")])
        res["bad_mesh"] = None
    except ValueError as e:
        res["bad_mesh"] = str(e)
    return res


def _watchdog_scenario(mesh, out_dir: Path) -> list:
    """Step SLOW_STEP sleeps on rank 1 only; returns the steps at which
    this rank's ``on_straggler`` ran."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.steps import build_train_step
    model, opt_cfg, data = _setup()
    step = build_train_step(model, opt_cfg, mesh)
    calls = []

    def slow_step(params, opt_state, batch):
        out = step(params, opt_state, batch)
        if mesh.rank == 1 and len(calls) == SLOW_STEP:
            time.sleep(1.5)
        calls.append(1)
        return out

    saves = []
    wd = train_loop.WatchdogConfig(max_strikes=1, warmup_steps=2)
    with contextlib.redirect_stdout(io.StringIO()):
        train_loop.run(model, opt_cfg, data,
                       _loop(SLOW_STEP + 2, watchdog=wd),
                       ckpt=CheckpointManager(out_dir / "watchdog",
                                              device="cpu"),
                       train_step=slow_step, on_straggler=saves.append,
                       mesh=mesh)
    return saves


def _row_block(b: int) -> torch.Tensor:
    """Row block ``b``'s (pod-major) f32 gradient of the row-sum check."""
    i = torch.arange(ROW_NUMEL)
    return torch.tensor(ROW_VALUES, dtype=torch.float32)[(b + i) % 4]


def _row_sum_scenario(mesh) -> torch.Tensor:
    """``steps.mean_over_row_blocks`` of this rank's row block over
    ("pod", "data") of a (2, 2, 1) mesh, in pieces of POD_REDUCE_CHUNK
    elements."""
    from repro_torch.runtime import steps
    b = mesh.coords["pod"] * mesh.shape["data"] + mesh.coords["data"]
    whole_leaf = steps.REDUCE_CHUNK
    steps.REDUCE_CHUNK = POD_REDUCE_CHUNK
    try:
        return steps.mean_over_row_blocks(_row_block(b), mesh,
                                          ("pod", "data"))
    finally:
        steps.REDUCE_CHUNK = whole_leaf


def _worker(out_dir: Path) -> None:
    torch.set_num_threads(1)
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.launch.mesh import make_mesh
    mesh4 = make_mesh((WORLD,), ("data",), "cpu")
    meshes = {shape: make_mesh(shape, _axes(shape), "cpu")
              for shape in MESHES + tuple(POD_MESHES)}
    meshes[WORLD, ] = mesh4
    res = {"rank": mesh4.rank, "train": {}}
    res["allreduce"] = _allreduce_scenarios(
        {"4": (mesh4, "data"), "2x2": (meshes[2, 2], "data"),
         "pod": (meshes[2, 2, 1], "pod")})
    res["row_sum"] = _row_sum_scenario(meshes[2, 2, 1])
    saved = {(2, 2): "mesh22", (2, 2, 1): "pod221"}
    from repro_torch.runtime import steps
    whole_leaf = steps.REDUCE_CHUNK
    for shape, mesh in meshes.items():
        ckpt = (CheckpointManager(out_dir / saved[shape], device="cpu")
                if shape in saved else None)
        # the pod meshes sum a leaf in many pieces, the flat ones whole
        steps.REDUCE_CHUNK = POD_REDUCE_CHUNK if len(shape) == 3 \
            else whole_leaf
        out = _train(STEPS, mesh=mesh, ckpt=ckpt)
        steps.REDUCE_CHUNK = whole_leaf
        res["train"][shape] = {"history": out["history"],
                               "state": _gathered(out),
                               "resident": _resident(out)}
        if len(shape) == 3:
            res["train"][shape]["local"] = _state(out)
        if shape == (2, 2):
            like = _state(out)
    res["launcher"] = _launcher_scenarios(out_dir)
    res["watchdog"] = _watchdog_scenario(meshes[2, 2], out_dir)
    deadline = time.monotonic() + TIME_LIMIT_S
    while not (out_dir / "ckpts_ready").exists():
        if time.monotonic() > deadline:
            raise TimeoutError("the checkpoints never came")
        time.sleep(0.2)
    out = _train(RESUME_TO, mesh=meshes[1, 4],
                 ckpt=CheckpointManager(out_dir / "single", device="cpu"))
    res["resume"] = {"history": out["history"], "state": _gathered(out)}
    for shape in ((2, 1, 2), (2, 2)):
        out = _train(RESUME_TO, mesh=meshes[shape], ckpt=CheckpointManager(
            out_dir / f"single_{'x'.join(map(str, shape))}", device="cpu"))
        res["resume", shape] = {"history": out["history"],
                                "state": _gathered(out)}
    from repro_torch.runtime import elastic
    state, manifest = CheckpointManager(
        out_dir / "reference", device="cpu").load(
            like, mesh=meshes[2, 2], pspecs=elastic.train_pspecs(
                _abstract(), meshes[2, 2]))
    res["reference"] = {"step": manifest["step"], "state": elastic.gather_tree(
        state, meshes[2, 2], elastic.train_pspecs(_abstract(), meshes[2, 2]),
        link=None)}
    torch.save(res, out_dir / f"rank{res['rank']}.pt")


def _abstract():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import abstract_params
    return abstract_params(get_smoke_config("llama3_2_1b"))


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


def _join_world(procs, out_dir: Path) -> tuple:
    t0 = time.monotonic()
    deadline = t0 + TIME_LIMIT_S
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


def _reference_checkpoint(out_dir: Path) -> dict:
    """One step of the reference's single-device ``train_loop``, saved
    uncompressed; returns its state by the port's leaf paths."""
    import jax
    from repro.checkpoint.ckpt import CheckpointManager as JaxManager
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.data.pipeline import DataConfig as JaxDataConfig
    from repro.models import build_model as jax_build_model
    from repro.optim import adamw as jax_adamw
    from repro.runtime import train_loop as jax_train_loop
    cfg = jax_smoke_config("llama3_2_1b")
    with contextlib.redirect_stdout(io.StringIO()):
        out = jax_train_loop.run(
            jax_build_model(cfg),
            jax_adamw.AdamWConfig(lr=3e-4, schedule=jax_adamw.warmup_cosine(
                20, RESUME_TO)),
            JaxDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                          global_batch=BATCH),
            jax_train_loop.TrainLoopConfig(total_steps=1),
            ckpt=JaxManager(out_dir / "reference", compress=False))
    state = {"params": out["params"], "opt": out["opt_state"]}
    return {"/".join(str(getattr(k, "key", getattr(k, "name",
                                                   getattr(k, "idx", k))))
                     for k in path): np.asarray(jax.device_get(v))
            for path, v in jax.tree_util.tree_flatten_with_path(state)[0]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("train_mesh")
    procs = _start_world(out_dir)
    try:
        single = {"resume_source": _train(RESUME_FROM, ckpt=_manager(
            out_dir / "single"))}
        for shape in ((2, 1, 2), (2, 2)):
            # a copy each: every resume saves its own final step there
            shutil.copytree(out_dir / "single", out_dir / (
                "single_" + "x".join(map(str, shape))))
        single["reference"] = _reference_checkpoint(out_dir)
        (out_dir / "ckpts_ready").touch()
        single["steps"] = _train(STEPS)
        single["resume_target"] = _train(RESUME_TO)
    finally:
        (out_dir / "ckpts_ready").touch()
        ranks = _join_world(procs, out_dir)
    return ranks, single, out_dir


def _manager(root):
    from repro_torch.checkpoint.ckpt import CheckpointManager
    return CheckpointManager(root, device="cpu")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _flat(state) -> dict:
    from repro_torch.core.api import tree_leaves
    return dict(tree_leaves(state))


def _assert_state_equal(got, want, what: str):
    got, want = _flat(got), _flat(want)
    assert list(got) == list(want), what
    for path in want:
        a, b = got[path], want[path]
        assert a.dtype == b.dtype and a.shape == b.shape, (what, path)
        assert torch.equal(_bits(a), _bits(b)), (what, path)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("label", ["4", "2x2", "pod"])
def test_compressed_allreduce_bitwise_with_reference_streams(
        world, label, dtype):
    """Every rank's result is the rank-ordered f32 sum of its axis' inputs
    cast back (negative zeros included); its own streams are the reference
    encoder's bytes;
    ``d2d_psum`` holds ``(n - 1) x`` its stream bytes and one op an
    array.  "pod": the axis of (2, 2, 1) whose ranks differ by 2."""
    import jax.numpy as jnp
    from repro.core import codec as jax_codec
    from repro.core.dtypes import format_for as jax_format_for
    from repro.core.params import EnecParams as JaxParams
    from repro_torch.optim.grad_compress import rank_ordered_sum
    ranks, _, _ = world
    p = _search(dtype)
    jp = JaxParams(p.b, p.n, p.m, p.L, p.l, p.expected_bits)
    for r in ranks:
        res = r["allreduce"][label, dtype]
        axis_ranks = res["ranks"]
        n = len(axis_ranks)
        assert n == (4 if label == "4" else 2)
        if label == "pod":
            assert axis_ranks == (r["rank"] % 2, r["rank"] % 2 + 2)
        want = rank_ordered_sum([_ar_input(dtype, q) for q in axis_ranks])
        assert res["out"].dtype == getattr(torch, dtype)
        assert torch.equal(_bits(res["out"]),
                           _bits(want.to(getattr(torch, dtype))))
        x = _ar_input(dtype, r["rank"])
        jx = jnp.asarray(x.float().numpy()).astype(dtype)
        fmt = jax_format_for(jx.dtype)
        ref = jax_codec.encode_blocks(jax_codec.to_blocks(jx, fmt, AR_BLOCK),
                                      fmt, jp)
        sizes = 0
        for a, b in zip(res["streams"], ref):
            b = np.asarray(b)
            assert a.numpy().tobytes() == b.tobytes()
            sizes += b.nbytes
        assert res["link"] == {"compressed_bytes": (n - 1) * sizes,
                               "dense_bytes": 0, "ops": len(ref)}


def test_mesh_1x4_bitwise_equal_to_one_device(world):
    """D = 1: every rank computes what one device computes, bit for bit:
    params, m, v, step, losses and gradient norms."""
    ranks, single, _ = world
    want = single["steps"]
    for r in ranks:
        got = r["train"][1, 4]
        _assert_state_equal(got["state"], _state(want), "mesh (1, 4)")
        assert [(h["step"], h["loss"], h["grad_norm"]) for h in
                got["history"]] == [(h["step"], h["loss"], h["grad_norm"])
                                    for h in want["history"]]


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_data_parallel_meshes_agree(world, shape):
    """D > 1: the ranks' gathered states bitwise equal each other; the
    losses and gradient norms within LOSS_RTOL of one device's."""
    ranks, single, _ = world
    first = ranks[0]["train"][shape]
    for r in ranks[1:]:
        got = r["train"][shape]
        _assert_state_equal(got["state"], first["state"], f"mesh {shape}")
        assert [(h["loss"], h["grad_norm"]) for h in got["history"]] == [
            (h["loss"], h["grad_norm"]) for h in first["history"]]
    want = single["steps"]["history"]
    assert [h["step"] for h in first["history"]] == list(range(STEPS))
    for h, w in zip(first["history"], want):
        assert abs(h["loss"] - w["loss"]) <= LOSS_RTOL * abs(w["loss"])
        assert abs(h["grad_norm"] - w["grad_norm"]) \
            <= LOSS_RTOL * abs(w["grad_norm"])


@pytest.mark.parametrize("shape", MESHES + tuple(POD_MESHES))
def test_each_rank_holds_its_own_shards(world, shape):
    """Every resident leaf has the shape of ``local_shard`` of the whole
    under the train specs, contiguous, in a storage of its own."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime import elastic, sharding
    ranks, single, _ = world
    whole = _flat(_state(single["steps"]))
    for r in ranks:
        mesh = Mesh(shape, _axes(shape), rank=r["rank"])
        specs = dict(sharding.spec_leaves(elastic.train_pspecs(
            _abstract(), mesh)))
        resident = r["train"][shape]["resident"]
        assert list(resident) == list(whole)
        for path, (got, own) in resident.items():
            want = sharding.local_shard(whole[path], specs[path], mesh)
            assert got == tuple(want.shape) and own, (shape, path)
        sharded = sum(np.prod(s) for s, _ in resident.values())
        assert sharded < sum(t.numel() for t in whole.values())


@pytest.mark.parametrize("shape, root", [((2, 2), "mesh22"),
                                         ((2, 2, 1), "pod221")])
def test_mesh_save_byte_identical_to_one_device(world, tmp_path, shape,
                                                root):
    """The (2, 2) and (2, 2, 1) runs' collective saves (rank 0 writes; on
    the pod mesh only pod 0 gathers) are, file by file, a single-device
    save of the same gathered state."""
    ranks, _, out_dir = world
    state = ranks[0]["train"][shape]["state"]
    _manager(tmp_path / "single").save(STEPS, state, blocking=True)
    step = f"step_{STEPS:012d}"
    mine, theirs = out_dir / root / step, tmp_path / "single" / step
    names = sorted(p.name for p in mine.iterdir())
    assert names == sorted(p.name for p in theirs.iterdir())
    assert (out_dir / root / "LATEST").read_text() == step
    for name in names:
        if name == "manifest.json":
            a, b = (json.loads((d / name).read_text()) for d in (mine,
                                                                  theirs))
            a.pop("save_s"), b.pop("save_s")
            assert a == b
        else:
            assert (mine / name).read_bytes() == (theirs / name).read_bytes()


def test_elastic_resume_one_device_to_1x4_bitwise(world):
    """A single-device checkpoint of step 2 resumed on (1, 4) to step 4:
    bitwise the uninterrupted single-device run."""
    ranks, single, _ = world
    want = single["resume_target"]
    for r in ranks:
        got = r["resume"]
        assert [h["step"] for h in got["history"]] == \
            list(range(RESUME_FROM, RESUME_TO))
        _assert_state_equal(got["state"], _state(want), "resumed (1, 4)")
        assert [(h["loss"], h["grad_norm"]) for h in got["history"]] == [
            (h["loss"], h["grad_norm"])
            for h in want["history"][RESUME_FROM:]]


def test_reference_checkpoint_restores_onto_2x2(world):
    """The reference's single-device checkpoint (its ``train_loop``, one
    step) restored onto (2, 2) and gathered: bitwise the state it saved."""
    ranks, single, _ = world
    want = single["reference"]
    for r in ranks:
        got = r["reference"]
        assert got["step"] == 1
        flat = _flat(got["state"])
        assert sorted(flat) == sorted(want)
        for path, t in flat.items():
            w = want[path]
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
                w = w.view(np.int16)
            assert t.numpy().tobytes() == np.ascontiguousarray(w).tobytes(), \
                path


def test_launcher_mesh_flag(world, monkeypatch):
    """``--mesh 2x2`` prints its mesh; with no ``--mesh`` the mesh is the
    reference's ``best_mesh_for`` on 4 devices; ``--mesh 3x1`` raises."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.runtime import elastic as jax_elastic
    ranks, _, _ = world
    monkeypatch.setattr(jax_elastic, "make_mesh",
                        lambda shape, axes: dict(zip(axes, shape)))
    auto = jax_elastic.best_mesh_for(jax_smoke_config("llama3_2_1b"),
                                     n_devices=WORLD)
    for r in ranks:
        res = r["launcher"]
        assert ("[launch.train] llama3.2-1b on mesh {'data': 2, 'model': 2}"
                in res["printed"])
        assert res["auto_mesh"] == auto == {"data": 1, "model": 4}
        assert "--mesh 3x1 needs 3 ranks; the world has 4" in (
            res["bad_mesh"] or "")


def test_watchdog_straggler_on_one_rank_saves_everywhere(world):
    """Rank 1 alone is slow at step SLOW_STEP: every rank strikes there
    (the world's largest step time decides), runs ``on_straggler`` and
    takes part in the collective save; the world ends."""
    ranks, _, out_dir = world
    saves = [r["watchdog"] for r in ranks]
    assert SLOW_STEP in saves[0]
    assert all(s == saves[0] for s in saves)
    steps = sorted(p.name for p in (out_dir / "watchdog").glob("step_*"))
    assert f"step_{SLOW_STEP:012d}" in steps
    assert steps[-1] == f"step_{SLOW_STEP + 2:012d}"


def _grad_bytes() -> int:
    return sum(t.numel() * t.element_size()
               for _, t in _flat(_abstract()).items())


@pytest.mark.parametrize("pod", list(POD_MESHES))
def test_pod_mesh_trains_bitwise_as_the_flat_mesh(world, pod):
    """A (P, D, M) mesh trains bitwise as the (P·D, M) mesh: every rank's
    losses, gradient norms and gathered state equal the flat mesh's; the
    step reduces (P·D - 1) x the gradient's bytes, as the flat mesh's."""
    ranks, _, _ = world
    flat = POD_MESHES[pod]
    want = ranks[0]["train"][flat]
    n = pod[0] * pod[1]
    for r in ranks:
        got = r["train"][pod]
        _assert_state_equal(got["state"], want["state"], f"mesh {pod}")
        assert [(h["step"], h["loss"], h["grad_norm"])
                for h in got["history"]] == [
            (h["step"], h["loss"], h["grad_norm"]) for h in want["history"]]
        assert [h["reduce_bytes"] for h in got["history"]] == [
            h["reduce_bytes"] for h in want["history"]] == [
            (n - 1) * _grad_bytes()] * STEPS


@pytest.mark.parametrize("pod", list(POD_MESHES))
def test_pod_replicas_hold_identical_shards(world, pod):
    """Ranks that differ only on "pod" hold the same shards, bit for bit,
    and each rank's resident bytes are its (data, model) shard's: those
    of the rank of a (D, M) mesh at the same coordinates."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime import elastic, sharding
    ranks, single, _ = world
    whole = _flat(_state(single["steps"]))
    per_pod = WORLD // pod[0]
    for r in ranks:
        partner = ranks[(r["rank"] + per_pod) % WORLD]
        _assert_state_equal(r["train"][pod]["local"],
                            partner["train"][pod]["local"],
                            f"mesh {pod} pod replicas")
        flat = Mesh(pod[1:], ("data", "model"), rank=r["rank"] % per_pod)
        specs = dict(sharding.spec_leaves(elastic.train_pspecs(
            _abstract(), flat)))
        held = sum(t.numel() * t.element_size() for t in
                   _flat(r["train"][pod]["local"]).values())
        assert held == sum(
            sharding.local_shard(t, specs[p], flat).numel()
            * t.element_size() for p, t in whole.items())


def test_row_block_mean_is_one_pod_major_sum(world):
    """The train step's mean over the row blocks of (2, 2, 1) is one
    rank-ordered f32 sum of the four blocks, pod-major, divided by 4, on
    every rank bit for bit; the blocks' values make another order (the
    reverse, or data-major) or a sum split over "data" then "pod" give
    other bits."""
    from repro_torch.optim.grad_compress import rank_ordered_sum
    ranks, _, _ = world
    blocks = [_row_block(b) for b in range(4)]
    want = rank_ordered_sum(blocks) / 4
    for other in (rank_ordered_sum(blocks[::-1]) / 4,
                  rank_ordered_sum([blocks[b] for b in (0, 2, 1, 3)]) / 4,
                  rank_ordered_sum([rank_ordered_sum(blocks[:2]),
                                    rank_ordered_sum(blocks[2:])]) / 4):
        assert not torch.equal(_bits(other), _bits(want))
    for r in ranks:
        got = r["row_sum"]
        assert got.dtype == torch.float32 and got.shape == (ROW_NUMEL,)
        assert torch.equal(_bits(got), _bits(want)), r["rank"]


def test_one_device_checkpoint_resumes_onto_pod_mesh_bitwise(world):
    """The single-device checkpoint of step 2 resumed on (2, 1, 2) to step
    4: losses, gradient norms and gathered state bitwise those of the
    same checkpoint resumed on (2, 2)."""
    ranks, _, _ = world
    want = ranks[0]["resume", (2, 2)]
    assert [h["step"] for h in want["history"]] == \
        list(range(RESUME_FROM, RESUME_TO))
    for r in ranks:
        got = r["resume", (2, 1, 2)]
        _assert_state_equal(got["state"], want["state"], "resumed (2, 1, 2)")
        assert [(h["step"], h["loss"], h["grad_norm"])
                for h in got["history"]] == [
            (h["step"], h["loss"], h["grad_norm"]) for h in want["history"]]


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, str(ROOT / "src"))
    _worker(Path(sys.argv[2]))
    torch.distributed.destroy_process_group()
