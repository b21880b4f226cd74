"""Rematerialised training in the port (``models/remat.py``, the
reference's ``cfg.remat``) against its own run without remat and against
the JAX package:

* on every smoke config ``models/lm.py`` runs, the loss and every
  gradient bitwise equal under ``remat=False`` and the policies
  ``nothing`` and ``dots``;
* llama and phi3.5 smoke with remat on against ``jax.value_and_grad`` of
  the reference's ``loss_fn`` under the same config, within
  ``tests/test_torch_train.py``'s tolerances;
* what autograd keeps for one period (``saved_tensors_hooks``): the
  period's input alone under ``nothing``; under ``dots`` also the product
  outputs the reference's ``print_saved_residuals`` lists for its period
  (never an expert's); everything its ops save without remat;
* kernel 2' launches of a train step on ``meta``: every product forward,
  dX and dW, and under ``nothing`` the recompute of every product whose
  output the backward reads, as many weight products as the reference's
  differentiated program computes;
* serving with remat set: the engine's logits and launches bitwise equal
  to ``remat=False`` in all three weight modes.
"""
import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import print_saved_residuals
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import lm as jax_lm
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_jax
from repro_torch.core.api import tree_leaves
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import build_model, lm
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.steps import loss_and_grads
from repro_torch.runtime.streaming import assign_weight_modes
from test_torch_train import GRAD_ULPS, LOSS_RTOL, _names, _ulps_apart


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


LM_ARCHS = ("llama3_2_1b", "qwen3_32b", "minitron_4b", "stablelm_3b",
            "phi3_5_moe_42b_a6_6b", "qwen3_moe_235b_a22b", "xlstm_125m",
            "jamba_v0_1_52b", "paligemma_3b")
MODES = ((False, "nothing"), (True, "nothing"), (True, "dots"))
BATCH, SEQ = 2, 16


def _cfg(arch, remat, policy):
    return dataclasses.replace(get_smoke_config(arch), remat=remat,
                               remat_policy=policy)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int64))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    if cfg.prefix_embed:
        batch["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.prefix_embed, cfg.d_model)).astype(np.float32))
    return batch


def _counted_run(model, params, batch):
    """``loss_and_grads`` with kernel 2' launches counted (every call of
    ``ops._tiled``: forward, dX, dW and the recompute)."""
    calls = [0]
    orig = ops._tiled

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    ops._tiled = counted
    try:
        loss, _, grads = loss_and_grads(model, params, batch)
    finally:
        ops._tiled = orig
    return loss, grads, calls[0]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_remat_bitwise_equal_to_no_remat(arch):
    """Loss and every gradient leaf bitwise equal under remat off,
    ``nothing`` and ``dots``; the recompute of ``nothing`` launches
    products that ``dots`` keeps."""
    batch = _batch(get_smoke_config(arch))
    params = build_model(get_smoke_config(arch)).init(seed=0, device="cpu")
    runs = {}
    for remat, policy in MODES:
        model = build_model(_cfg(arch, remat, policy))
        runs[remat, policy] = _counted_run(model, params, batch)
    loss0, grads0, launches0 = runs[False, "nothing"]
    for key, (loss, grads, launches) in runs.items():
        assert torch.equal(_bits(loss), _bits(loss0)), key
        for (path, a), (_, b) in zip(tree_leaves(grads0), tree_leaves(grads)):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), \
                (key, path)
        assert launches >= launches0, key
    assert runs[True, "nothing"][2] > runs[True, "dots"][2]


@pytest.mark.parametrize("arch", ["llama3_2_1b", "phi3_5_moe_42b_a6_6b"])
@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_matches_reference(arch, policy):
    """The port under remat against ``jax.value_and_grad`` of the
    reference's ``loss_fn`` under the same remat config, on the reference's
    weights: the loss within LOSS_RTOL, each gradient leaf within
    GRAD_ULPS bf16 ulps of its largest magnitude.  The reference runs
    eagerly: its jit moves the MoE router's near-ties."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), remat=True,
                               remat_policy=policy)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = _cfg(arch, True, policy)
    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    batch = _batch(cfg, seed=1)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v.numpy()).astype(jnp.int32)
                  for k, v in batch.items()})
    loss, _, grads = loss_and_grads(build_model(cfg), params, batch)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * float(jloss)
    want = _names(jgrads)
    got = dict(tree_leaves(grads))
    assert set(want) == set(got)
    for path, g in got.items():
        assert _ulps_apart(g.float().numpy(), want[path]) <= GRAD_ULPS, path


# ---------------------------------------------------------------------------
# what a period keeps
# ---------------------------------------------------------------------------

_RESIDUAL = re.compile(r"^(\w+)\[([\d,]*)\]\s+(.*)$")
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int64: "i64",
          torch.int32: "i32", torch.bool: "bool"}


def _reference_residuals(arch, policy, x_np, params):
    """The residuals ``jax.ad_checkpoint.print_saved_residuals`` lists for
    the reference's rematerialised period (its ``_wrap_body`` around the
    period's positions at layer 0) that are computed in the period, not
    its arguments or constants: ``(dtype, (rows, width))``, rows the
    product of the leading dims."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), remat=True,
                               remat_policy=policy)
    program = jax_lm.block_program(jcfg)
    sliced = jax.tree.map(lambda a: a[0], params["period"])
    positions = jnp.arange(x_np.shape[1])[None, :]

    def body(x, sliced):
        aux = jnp.float32(0)
        for pos, desc in enumerate(program):
            x, _, a = jax_lm._apply_position(sliced[pos], desc, jcfg, x,
                                             positions)
            aux = aux + a["lb_loss"] + 1e-3 * a["z_loss"]
        return x, aux

    period = jax_lm._wrap_body(jcfg, body)

    def loss(x, sliced):
        y, aux = period(x, sliced)
        return jnp.sum(y.astype(jnp.float32)) + aux

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        print_saved_residuals(
            loss, jnp.asarray(x_np).astype(jnp.bfloat16), sliced)
    got = []
    for line in out.getvalue().splitlines():
        m = _RESIDUAL.match(line.strip())
        assert m, line
        if "from the argument" in m[3] or "from a constant" in m[3]:
            continue
        shape = tuple(int(v) for v in m[2].split(",")) if m[2] else ()
        got.append((m[1], (int(np.prod(shape[:-1])), shape[-1])))
    return sorted(got)


def _kept_by_autograd(cfg, params, x):
    """The tensors an outer ``saved_tensors_hooks`` sees saved over one
    forward of the period stack (``cfg`` of one period), parameters'
    storages left out: ``[(dtype as the reference prints it, shape,
    storage bytes, tensor)]``, one per storage."""
    program = lm.block_program(cfg)
    positions = torch.arange(x.shape[1])[None, :]
    weights = {t.untyped_storage().data_ptr()
               for _, t in tree_leaves(params)}
    seen, kept = set(), []

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in weights and ptr not in seen:
            seen.add(ptr)
            kept.append((_SHORT[t.dtype], tuple(t.shape),
                         t.untyped_storage().nbytes(), t))
        return t

    def apply(p, x, pos, _):
        x, entry, aux = lm._apply_position(p, program[pos], cfg, x,
                                           positions)
        return x, (entry, aux)

    with torch.enable_grad(), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, _ = lm._run_layers(params, cfg, x, apply)
    return out, kept


@pytest.mark.parametrize("arch", ["llama3_2_1b", "phi3_5_moe_42b_a6_6b"])
def test_period_keeps_what_the_reference_keeps(arch):
    """One period (layer 0's positions) of the reference's weights: under
    ``nothing`` autograd keeps the period's input alone; under ``dots``
    also the outputs of the products the reference keeps, equal in count,
    dtype and shape to the computed residuals its ``print_saved_residuals``
    lists (no expert product among them); without remat the most bytes."""
    jcfg = jax_smoke_config(arch)
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    n_pos = len(lm.block_program(get_smoke_config(arch)))
    x_np = np.random.default_rng(2).standard_normal(
        (BATCH, SEQ, jcfg.d_model)).astype(np.float32)
    full = params_from_jax(jax.device_get(jparams), "cpu",
                           cfg=get_smoke_config(arch))
    nbytes, outs = {}, {}
    for remat, policy in MODES:
        cfg = dataclasses.replace(_cfg(arch, remat, policy), n_layers=n_pos)
        params = _leaf_grad({"period": [_first(p) for p in full["period"]]})
        x = torch.from_numpy(x_np).to(torch.bfloat16).requires_grad_(True)
        out, kept = _kept_by_autograd(cfg, params, x)
        outs[remat, policy] = out
        nbytes[remat, policy] = sum(k[2] for k in kept)
        if (remat, policy) == (True, "nothing"):
            assert [k[3] for k in kept] == [x], \
                [(k[0], k[1]) for k in kept]
        if (remat, policy) == (True, "dots"):
            assert kept[0][3] is x
            mine = sorted((d, (int(np.prod(s[:-1])), s[-1]))
                          for d, s, _, _ in kept[1:])
            assert mine == _reference_residuals(arch, "dots", x_np,
                                                jparams)
            assert not _reference_residuals(arch, "nothing", x_np, jparams)
    for key, out in outs.items():
        assert torch.equal(_bits(out), _bits(outs[False, "nothing"])), key
    assert nbytes[True, "nothing"] < nbytes[True, "dots"] \
        < nbytes[False, "nothing"]


def _first(tree):
    """Layer 0 of a period subtree, kept stacked (a 1-layer stack)."""
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[:1].clone()


def _leaf_grad(tree):
    if isinstance(tree, dict):
        return {k: _leaf_grad(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_grad(v) for v in tree]
    return tree.detach().requires_grad_(True)


# ---------------------------------------------------------------------------
# launches: on meta, and against the reference's program
# ---------------------------------------------------------------------------

def _reference_products(policy) -> int:
    """Weight products (``dot_general`` without batch dimensions) in the
    reference's differentiated llama smoke loss under remat ``policy``
    (None: off): its forward, its recompute and its backward."""
    cfg = jax_smoke_config("llama3_2_1b")
    if policy is not None:
        cfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    model = jax_build_model(cfg)
    params = model.init(jax.random.key(0))
    tokens = jnp.zeros((BATCH, SEQ), jnp.int32)
    jaxpr = jax.make_jaxpr(jax.grad(lambda p: model.loss_fn(
        p, {"tokens": tokens, "targets": tokens})[0]))(params)

    def count(j) -> int:
        n = 0
        for e in j.eqns:
            if e.primitive.name == "dot_general":
                (_, _), (lb, rb) = e.params["dimension_numbers"]
                n += not lb and not rb
            for v in e.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        n += count(inner)
        return n

    return count(jaxpr.jaxpr)


@pytest.mark.parametrize("remat,policy", MODES)
def test_train_step_launches_on_meta(remat, policy):
    """A llama smoke train step on ``meta`` (1x1 mesh): kernel 2' launches
    3 P (P = 7 L + 1 products, each forward, dX and dW) without remat and
    under ``dots``; under ``nothing`` the recompute adds every layer's
    products but ``w_down``, whose output feeds only the period's output
    (6 L).  Each equals the weight products of the reference's
    differentiated program under the same remat."""
    cfg = _cfg("llama3_2_1b", remat, policy)
    n = cfg.n_layers
    rec = dryrun.lower_cell(cfg, ShapeSpec("train_4k", SEQ, BATCH, "train"),
                            AbstractMesh((1, 1), ("data", "model")))
    got = rec["kernels"]["dense_tile_matmul"]["launches"]
    p = 7 * n + 1
    assert got == 3 * p + (6 * n if remat and policy == "nothing" else 0)
    assert got == _reference_products(policy if remat else None)


# ---------------------------------------------------------------------------
# serving ignores remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "stream", "fused"])
def test_serving_unchanged_by_remat(mode):
    """llama smoke served through the engine with ``remat=True`` (either
    policy): every request's tokens and logits bitwise equal to
    ``remat=False``'s, and the same kernel wrapper calls (serving builds no
    autograd graph, so no period is rematerialised)."""
    prompts = np.random.default_rng(3).integers(0, 512, (2, 8)).astype(
        np.int32)
    params = build_model(get_smoke_config("llama3_2_1b")).init(
        seed=0, device="cpu")
    runs = {}
    for remat, policy in MODES:
        model = build_model(_cfg("llama3_2_1b", remat, policy))
        tree = assign_weight_modes(params, mode=mode, min_bytes=1024,
                                   shards=2)
        engine = Engine(model, tree, EngineConfig(
            max_slots=2, max_prompt_len=8, max_new_tokens=4,
            collect_logits=True), device="cpu")
        calls = dict.fromkeys(("_tiled", "decode_blocks",
                               "decompress_matmul"), 0)
        origs = {name: getattr(ops, name) for name in calls}

        def wrap(name):
            def counted(*a, **k):
                calls[name] += 1
                return origs[name](*a, **k)
            return counted

        for name in calls:
            setattr(ops, name, wrap(name))
        try:
            reqs = [engine.submit(p, 4) for p in prompts]
            engine.run_until_idle()
        finally:
            for name, fn in origs.items():
                setattr(ops, name, fn)
        assert all(r.state == "done" for r in reqs)
        runs[remat, policy] = ([r.tokens for r in reqs],
                               [torch.stack(r.logits) for r in reqs], calls)
    base = runs[False, "nothing"]
    for key, (tokens, logits, calls) in runs.items():
        assert tokens == base[0], key
        for a, b in zip(logits, base[1]):
            assert torch.equal(_bits(a), _bits(b)), key
        assert calls == base[2], key
    assert base[2]["_tiled"] > 0
