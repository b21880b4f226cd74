"""Single-device training in the port against the JAX package:

* ``data/pipeline.batch_at`` byte-identical to the reference's;
* on llama's smoke config (JAX weights carried over by
  ``convert.params_from_jax``): the loss and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``loss_fn``, and one
  ``adamw.apply`` on the same gradients, within stated tolerances;
* ``lm.loss_fn`` with ``loss_mask`` and the MoE aux term, and whisper's
  ``loss_fn``, against the reference's;
* the autograd Function around the tiled matmul (``kernels/ops.py``)
  against autograd through ``tiled_matmul_ref``;
* ``train_loop.run`` resumed from a checkpoint bitwise equal to an
  uninterrupted run, and a training checkpoint's records named and
  ordered as the reference's, each package restoring the other's.
"""
import dataclasses
import functools
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as jax_pipeline
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.api import tree_leaves, tree_map_with_path
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.kernels.ref import tiled_matmul_ref
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's torch work on one thread, as the suite runs it
    beside other workers on every core: the smoke models' small ops spend
    more time synchronising a pool of threads than computing.  The bits
    compared here come from runs under the same setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# The loss and the gradients differ from the reference's by the f32 sum
# order of each tile product, norm and softmax (XLA and torch order them
# differently, and the reference's jit fuses); where that moves a bf16
# cast, one element rounds the other way and the backward carries it on.
# Bounds, from the largest gaps measured over data seeds 1-4 (llama smoke,
# batch 4 x 16), rounded up: the loss within 1e-4 relative (measured
# 2.6e-5); each gradient leaf within 8 bf16 ulps (2**-8 relative) of its
# largest magnitude (measured 7.0, ``post_norm``; 4-5 elsewhere).  One
# AdamW step on the same gradients: parameters bitwise equal (measured: no
# element differs), moments within 2e-6 of each leaf's largest magnitude
# (measured 5.8e-7 for m, 1.1e-6 for v), the gradient norm within 1e-6.
# The MoE and whisper losses, over prompt seeds 5-8, within 2e-4 relative:
# the MoE's measured at most 1.35e-4 (seed 6) against the reference run
# eagerly (its jit moves the router's near-ties, and with them the loss by
# up to 1.6e-3); whisper's at most 1.06e-4 (seed 6) against the jitted
# reference (the reference's eager and jitted losses differ by 2.5e-4).
LOSS_RTOL = 1e-4
FAMILY_RTOL = 2e-4
GRAD_ULPS = 8
MOMENT_RTOL = 2e-6
SEQ, BATCH = 16, 4


def _names(tree) -> dict:
    """The reference tree's leaves as f32 numpy, by the port's path."""
    return {"/".join(str(getattr(k, "key", getattr(k, "name",
                                                   getattr(k, "idx", k))))
                     for k in path): np.asarray(v.astype(jnp.float32))
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ulps_apart(got: np.ndarray, want: np.ndarray) -> float:
    ulp = 2.0 ** -8 * 2.0 ** np.floor(np.log2(max(np.abs(want).max(),
                                                  1e-30)))
    return float(np.abs(got - want).max() / ulp)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.fixture(scope="module")
def llama():
    jcfg = jax_smoke_config("llama3_2_1b")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_smoke_config("llama3_2_1b")
    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    data = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=BATCH, seed=1)
    batch = pipeline.batch_at(data, 0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss_fn, has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"jmodel": jmodel, "jparams": jparams, "cfg": cfg,
            "model": build_model(cfg), "params": params, "data": data,
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "jloss": float(jloss), "jgrads": jgrads}


@pytest.mark.parametrize("data", [
    dict(vocab_size=512, seq_len=16, global_batch=4, seed=11),
    dict(vocab_size=128256, seq_len=128, global_batch=8),
    dict(vocab_size=257216, seq_len=8, global_batch=4, seed=3,
         shard_index=1, shard_count=2, prefix_embed=4, d_model=32)])
def test_batch_at_byte_identical(data):
    for step in (0, 1, 7):
        got = pipeline.batch_at(pipeline.DataConfig(**data), step)
        want = jax_pipeline.batch_at(jax_pipeline.DataConfig(**data), step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), (step, k)


def test_prefetcher_yields_the_stream_from_its_start():
    data = pipeline.DataConfig(vocab_size=512, seq_len=8, global_batch=2)
    it = pipeline.Prefetcher(data, start_step=3)
    try:
        for step in (3, 4):
            assert next(it)["tokens"].tobytes() == \
                pipeline.batch_at(data, step)["tokens"].tobytes()
    finally:
        it.close()


def test_loss_and_grads_match_reference(llama):
    leaves = tree_map_with_path(
        lambda _, p: p.detach().requires_grad_(True), llama["params"])
    loss, metrics = llama["model"].loss_fn(leaves, llama["batch"])
    assert abs(loss.item() - llama["jloss"]) <= LOSS_RTOL * llama["jloss"]
    assert float(metrics["aux"]) == 0.0
    flat = list(tree_leaves(leaves))
    grads = torch.autograd.grad(loss, [p for _, p in flat])
    want = _names(llama["jgrads"])
    assert set(want) == {path for path, _ in flat}
    for (path, p), g in zip(flat, grads):
        assert g.dtype == p.dtype and g.shape == p.shape, path
        assert _ulps_apart(g.float().numpy(), want[path]) <= GRAD_ULPS, path


def test_adamw_apply_matches_reference(llama):
    jopt = jax_adamw.AdamWConfig(lr=3e-3,
                                 schedule=jax_adamw.warmup_cosine(2, 10))
    jnew, jstate, jmet = jax.jit(functools.partial(jax_adamw.apply, jopt))(
        llama["jparams"], jax_adamw.init(llama["jparams"]), llama["jgrads"])
    grads = params_from_jax(jax.device_get(llama["jgrads"]), "cpu",
                            cfg=llama["cfg"])
    opt = adamw.AdamWConfig(lr=3e-3, schedule=adamw.warmup_cosine(2, 10))
    new, state, met = adamw.apply(opt, llama["params"],
                                  adamw.init(llama["params"]), grads)
    assert float(met["lr"]) == float(jmet["lr"])
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= \
        1e-6 * float(jmet["grad_norm"])
    assert int(state.step) == int(jstate.step) == 1
    want = _names(jnew)
    for path, p in tree_leaves(new):
        np.testing.assert_array_equal(p.float().numpy(), want[path])
    for mine, theirs in ((state.m, jstate.m), (state.v, jstate.v)):
        ref = _names(theirs)
        for path, t in tree_leaves(mine):
            assert t.dtype == torch.float32
            np.testing.assert_allclose(
                t.numpy(), ref[path], rtol=0,
                atol=MOMENT_RTOL * np.abs(ref[path]).max())


def test_warmup_cosine_matches_reference():
    got = adamw.warmup_cosine(20, 100)
    want = jax_adamw.warmup_cosine(20, 100)
    for step in (0, 1, 19, 20, 21, 60, 100, 140):
        assert float(got(torch.tensor(step, dtype=torch.int32))) == \
            float(want(jnp.int32(step))), step


@pytest.mark.parametrize("arch", ["phi3_5_moe_42b_a6_6b", "whisper_tiny"])
def test_loss_fn_matches_reference(arch):
    """The MoE loss with its ``1e-2 * aux`` term under a ``loss_mask``, and
    whisper's encoder-decoder loss, against the reference's."""
    jcfg = jax_smoke_config(arch)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_smoke_config(arch)
    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32)
    else:
        batch["loss_mask"] = (rng.random((2, 12)) < 0.7).astype(np.int32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if cfg.is_encdec:
        jbatch["frames"] = jbatch["frames"].astype(jnp.bfloat16)
    loss_fn = jax.jit(jmodel.loss_fn) if cfg.is_encdec else jmodel.loss_fn
    jloss, jmet = loss_fn(jparams, jbatch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, met = build_model(cfg).loss_fn(params, tbatch)
    for k in ("nll", "aux"):
        assert abs(float(met[k]) - float(jmet[k])) <= \
            FAMILY_RTOL * max(abs(float(jmet[k])), 1e-3), k
    assert abs(float(loss) - float(jloss)) <= FAMILY_RTOL * float(jloss)
    if not cfg.is_encdec:
        assert float(met["aux"]) > 0


@pytest.mark.parametrize("m,k,n,wdtype", [(5, 200, 130, torch.bfloat16),
                                          (128, 128, 384, torch.bfloat16),
                                          (3, 64, 70, torch.float32)])
def test_tiled_matmul_backward_matches_autograd(m, k, n, wdtype):
    """``dX = dY @ W.T`` and ``dW = X.T @ dY`` through the tiled matmul
    itself, against autograd through the plain version's elementwise
    ops (the same products, summed in another order: within 1e-5 of the
    largest magnitude), the weight also as a transposed view."""
    gen = torch.Generator().manual_seed(m * k + n)
    x = torch.randn((m, k), generator=gen).bfloat16()
    w0 = torch.randn((n, k), generator=gen).to(wdtype)
    dy = torch.randn((m, n), generator=gen)
    for w in (w0.T.contiguous(), w0.T):
        xa, wa = x.clone().requires_grad_(), w.detach().requires_grad_()
        out = ops.tiled_matmul(xa, wa)
        assert torch.equal(out, tiled_matmul_ref(x, w))
        dx, dw = torch.autograd.grad(out, (xa, wa), dy)
        xb, wb = x.clone().requires_grad_(), w.detach().requires_grad_()
        rx, rw = torch.autograd.grad(tiled_matmul_ref(xb, wb), (xb, wb), dy)
        assert dx.dtype == x.dtype and dw.dtype == w.dtype
        assert torch.equal(dx, tiled_matmul_ref(dy, w.T).to(x.dtype))
        assert torch.equal(dw, tiled_matmul_ref(x.T.contiguous(), dy)
                           .to(w.dtype))
        for got, want in ((dx, rx), (dw, rw)):
            scale = want.float().abs().max()
            bf16_ulp = 2.0 ** -8 if got.dtype == torch.bfloat16 else 0.0
            assert (got.float() - want.float()).abs().max() <= \
                (1e-5 + bf16_ulp) * scale


def test_embedding_gradient_is_the_sorted_sum():
    """Repeated tokens: each row's gradient is the f32 sum of its uses
    (``index_put_`` under deterministic algorithms), cast to bf16."""
    from repro_torch.models.layers import embed_tokens
    gen = torch.Generator().manual_seed(0)
    embed = torch.randn((40, 16), generator=gen).bfloat16()
    tokens = torch.randint(0, 8, (3, 50), generator=gen)
    g = torch.randn((3, 50, 16), generator=gen).bfloat16()
    e = embed.clone().requires_grad_()
    (got,) = torch.autograd.grad(embed_tokens(e, tokens), e, g)
    want = torch.zeros((40, 16)).index_add_(
        0, tokens.reshape(-1), g.reshape(-1, 16).float()).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert not torch.are_deterministic_algorithms_enabled()


def _run(model, cfg, data, steps, ckpt=None, log=None):
    opt = adamw.AdamWConfig(lr=3e-3,
                            schedule=adamw.warmup_cosine(2, steps))
    return train_loop.run(
        model, opt, data,
        train_loop.TrainLoopConfig(total_steps=steps, ckpt_every=100,
                                   log_every=1),
        ckpt=ckpt, device="cpu", on_metrics=log)


def test_resume_is_bitwise_equal_to_an_uninterrupted_run(tmp_path):
    cfg = get_smoke_config("llama3_2_1b")
    model = build_model(cfg)
    data = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=BATCH, seed=11)
    whole = _run(model, cfg, data, 4)
    assert [h["step"] for h in whole["history"]] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in whole["history"])
    mgr = CheckpointManager(tmp_path / "ck", device="cpu")
    _run(model, cfg, data, 2, ckpt=mgr)
    assert mgr.latest_step() == 2
    resumed = _run(model, cfg, data, 4, ckpt=mgr)
    assert [h["step"] for h in resumed["history"]] == [2, 3]
    for (pa, a), (pb, b) in zip(
            tree_leaves({"params": whole["params"],
                         "opt": whole["opt_state"]}),
            tree_leaves({"params": resumed["params"],
                         "opt": resumed["opt_state"]})):
        assert pa == pb
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), pa
    assert int(resumed["opt_state"].step) == 4


def test_training_checkpoint_records_match_reference(llama, tmp_path):
    """``{"params", "opt"}`` saved by both packages: the same record names
    in the same order (``opt/step``, ``opt/m/...``, ``opt/v/...``), and
    each package restores the other's state exactly (the reference's
    saved uncompressed: its eager encoder costs seconds a leaf shape)."""
    jparams, params = llama["jparams"], llama["params"]
    jstate = jax_adamw.init(jparams)
    jstate = jstate._replace(step=jnp.int32(3), m=jax.tree.map(
        lambda p: p.astype(jnp.float32) * 0.5, jparams), v=jax.tree.map(
        lambda p: jnp.square(p.astype(jnp.float32)), jparams))
    state = adamw.AdamWState(
        step=torch.tensor(3, dtype=torch.int32),
        m=tree_map_with_path(lambda _, p: p.float() * 0.5, params),
        v=tree_map_with_path(lambda _, p: torch.square(p.float()), params))
    CheckpointManager(tmp_path / "port", device="cpu").save(
        5, {"params": params, "opt": state}, blocking=True)
    JaxCheckpointManager(tmp_path / "ref", compress=False).save(
        5, {"params": jparams, "opt": jstate}, blocking=True)
    step = "step_000000000005"
    names = [[e["name"] for e in json.loads(
        (tmp_path / side / step / "manifest.json").read_text())["leaves"]]
        for side in ("port", "ref")]
    assert names[0] == names[1]
    assert names[0][0] == "opt/step" and "opt/m/embed" in names[0]
    back, _ = CheckpointManager(tmp_path / "ref", device="cpu").load(
        {"params": params, "opt": adamw.init(params)})
    assert isinstance(back["opt"], adamw.AdamWState)
    for (pa, a), (_, b) in zip(tree_leaves(back),
                               tree_leaves({"params": params, "opt": state})):
        assert a.dtype == b.dtype and torch.equal(a, b), pa
    jback, _ = JaxCheckpointManager(tmp_path / "port").load(
        {"params": jparams, "opt": jax_adamw.init(jparams)})
    want = _names({"params": jparams, "opt": jstate})
    for path, leaf in _names(jback).items():
        np.testing.assert_array_equal(leaf, want[path])


def test_async_save_keeps_the_values_at_the_save(tmp_path):
    """AdamW updates the moments in place while an async save may still be
    writing: a raw escape (incompressible bits, a view of its leaf) and an
    uncompressed record are written as they were when ``save`` returned."""
    gen = torch.Generator().manual_seed(5)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (64, 64), generator=gen,
                         dtype=torch.int32)
    tree = {"m": bits.view(torch.float32), "step": torch.tensor(7, dtype=torch.int32)}
    want = {k: v.clone() for k, v in tree.items()}
    mgr = CheckpointManager(tmp_path / "ck", device="cpu")
    saved, start = mgr._save_host, threading.Event()
    mgr._save_host = lambda *a: (start.wait(), saved(*a))
    mgr.save(1, tree)
    bits.add_(1)
    tree["step"].add_(1)
    start.set()
    mgr.wait()
    back, _ = mgr.load(tree)
    assert [r["mode"] for r in json.loads(
        (tmp_path / "ck" / "step_000000000001" / "manifest.json")
        .read_text())["leaves"]] == ["raw", "npraw"]
    for k in want:
        assert torch.equal(_bits(back[k]), _bits(want[k])), k


def test_launcher_trains_resumes_and_defaults_to_cuda(tmp_path, monkeypatch):
    args = ["--smoke", "--device", "cpu", "--steps", "2", "--global-batch",
            "2", "--seq", "8", "--ckpt", str(tmp_path / "ck")]
    out = train_launch.main(args)
    assert [h["step"] for h in out["history"]] == [0, 1]
    out = train_launch.main(args[:4] + ["3"] + args[5:])
    assert [h["step"] for h in out["history"]] == [2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_launch.main(["--smoke", "--ckpt", str(tmp_path / "x")])


def test_launcher_help_names_what_is_not_ported(capsys):
    """Nothing of the reference's launcher is left out any more: the help
    names ``--mesh`` and its default, ``elastic.best_mesh_for``."""
    with pytest.raises(SystemExit):
        train_launch.parse_args(["--help"])
    text = capsys.readouterr().out
    assert "--mesh" in text and "best_mesh_for" in text
    assert "not ported" not in text
    assert dataclasses.is_dataclass(train_loop.TrainLoopConfig)
