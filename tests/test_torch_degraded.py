"""The port's degraded restore (``policy="degraded"`` of
``repro_torch.checkpoint.ckpt``) against the scenarios of
tests/test_faults.py: a flipped pack byte, a record with no intact source,
an injected decode fault, an undamaged restore, an unknown policy, a
degraded serving restore in mixed mode and one quarantine counted.

Each scenario's quarantine list (record names, fallback steps) is held
equal to the reference's on the same checkpoint directory, which each
package writes in turn; restored values and served logits are held bit for
bit.  ``serve.main`` is held to the reference launcher's contract: the
default serves through the damage with health ``degraded``, ``--strict``
exits 1 with health ``failed``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointError as JaxCheckpointError
from repro.checkpoint.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.runtime import faults as jax_faults
from repro_torch.checkpoint.ckpt import CheckpointError, CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.codec_api import Codec
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.lm import abstract_params
from repro_torch.runtime import faults as rt_faults
from repro_torch.runtime.streaming import assign_weight_modes, tree_leaves
from repro_torch.runtime.weights import StreamedWeight

MIN_BYTES = 1024
WRITERS = ("repro", "repro_torch")


def _weights(seed: int) -> np.ndarray:
    """Trained-LLM-like bf16 weights (tests/conftest.py's generator), as
    their f32 values."""
    r = np.random.default_rng(seed)
    w = r.standard_normal(120_000) * 0.015
    w[r.random(120_000) < 2e-3] *= 64.0
    return np.asarray(jnp.asarray(w.astype("float32")).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _trees(seed: int):
    """The reference test's tree in both packages: bf16 weights, a zero
    bf16 bias and an int32 optimizer step."""
    w = _weights(seed)
    jtree = {"params": {"w": jnp.asarray(w).astype(jnp.bfloat16),
                        "b": jnp.zeros((64,), jnp.bfloat16)},
             "opt": {"step": jnp.asarray(7, jnp.int32)}}
    tree = {"params": {"w": torch.from_numpy(w).bfloat16(),
                       "b": torch.zeros((64,), dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    return jtree, tree


def _save(writer, root, steps, seed):
    jtree, tree = _trees(seed)
    for step in steps:
        if writer == "repro":
            JaxCheckpointManager(root).save(step, jtree, blocking=True)
        else:
            CheckpointManager(root, device="cpu").save(step, tree,
                                                       blocking=True)
    return jtree, tree


def _assert_equal(a, b):
    for (name, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8)), name


def _quarantine(report) -> list:
    return [(q.name, q.fallback) for q in report.quarantined]


@pytest.mark.parametrize("writer", WRITERS)
def test_corrupt_record_quarantined_with_prior_step_fallback(tmp_path,
                                                             writer):
    jtree, tree = _save(writer, tmp_path, (1, 2), seed=4)
    name, _, pos = rt_faults.flip_pack_byte(tmp_path, "params/w", step=2)
    assert name == "params/w" and pos > 0
    mgr = CheckpointManager(tmp_path, device="cpu")
    with pytest.raises(CheckpointError, match="CRC"):
        mgr.load(tree)
    out, man = mgr.load(tree, policy="degraded")
    assert man["step"] == 2
    _assert_equal(out, tree)
    report = mgr.last_restore_report
    assert report.degraded and [q.name for q in report.quarantined] \
        == ["params/w"]
    q = report.quarantined[0]
    assert "CRC" in q.cause and q.offset >= 0 and "pack-" in q.pack
    assert q.fallback.startswith("step 1")
    assert "params/w" in report.summary()
    jmgr = JaxCheckpointManager(tmp_path)
    jmgr.load(jtree, policy="degraded")
    assert _quarantine(report) == _quarantine(jmgr.last_restore_report)


@pytest.mark.parametrize("writer", WRITERS)
def test_quarantined_record_without_source_raises(tmp_path, writer):
    jtree, tree = _save(writer, tmp_path, (1,), seed=5)
    rt_faults.flip_pack_byte(tmp_path, "params/w", step=1)
    with pytest.raises(CheckpointError, match="no intact source"):
        CheckpointManager(tmp_path, device="cpu").load(tree,
                                                       policy="degraded")
    with pytest.raises(JaxCheckpointError, match="no intact source"):
        JaxCheckpointManager(tmp_path).load(jtree, policy="degraded")


@pytest.mark.parametrize("writer", WRITERS)
def test_decode_fault_degrades_to_prior_step(tmp_path, writer):
    jtree, tree = _save(writer, tmp_path, (1, 2), seed=6)
    mgr = CheckpointManager(tmp_path, device="cpu")
    spec = dict(kind="decode", match="params/w", times=1)
    with rt_faults.inject(rt_faults.FaultSpec(**spec)):
        with pytest.raises(CheckpointError, match="decode failed"):
            mgr.load(tree)
    with rt_faults.inject(rt_faults.FaultSpec(**spec)) as inj:
        out, _ = mgr.load(tree, policy="degraded")
    _assert_equal(out, tree)
    report = mgr.last_restore_report
    assert [q.name for q in report.quarantined] == ["params/w"]
    assert "decode failed" in report.quarantined[0].cause
    assert report.quarantined[0].fallback.startswith("step 1")
    assert inj.stats()[0]["fired"] == 1
    jmgr = JaxCheckpointManager(tmp_path)
    with jax_faults.inject(jax_faults.FaultSpec(**spec)):
        jmgr.load(jtree, policy="degraded")
    assert _quarantine(report) == _quarantine(jmgr.last_restore_report)


def test_uncorrupted_degraded_restore_identical_to_strict(tmp_path):
    _, tree = _save("repro_torch", tmp_path, (1,), seed=7)
    codec = Codec()
    mgr = CheckpointManager(tmp_path, codec=codec, device="cpu")
    codec.reset_decode_cache_stats()
    strict_out, _ = mgr.load(tree)
    strict_dispatches = codec.decode_cache_stats()["dispatches"]
    strict_buckets = len(mgr.last_decode_plan.buckets)
    assert mgr.last_restore_report.policy == "strict"
    codec.reset_decode_cache_stats()
    degraded_out, _ = mgr.load(tree, policy="degraded")
    assert codec.decode_cache_stats()["dispatches"] == strict_dispatches \
        == strict_buckets == len(mgr.last_decode_plan.buckets)
    assert not mgr.last_restore_report.degraded
    _assert_equal(strict_out, degraded_out)


def test_unknown_restore_policy_rejected(tmp_path):
    _, tree = _save("repro_torch", tmp_path, (1,), seed=8)
    mgr = CheckpointManager(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="restore policy"):
        mgr.load(tree, policy="yolo")
    with pytest.raises(ValueError, match="restore policy"):
        mgr.load_for_serving({"w": tree["params"]["w"]}, prefix="params",
                             policy="yolo")


# ---------------------------------------------------------------------------
# degraded serving restore on the smoke llama3_2_1b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config("llama3_2_1b")
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    cfg = get_smoke_config("llama3_2_1b")
    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    prompts = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)))
    return jparams, cfg, build_model(cfg), params, prompts


def _serve(model, tree, prompts):
    logits, cache = model.prefill_fn(tree, {"tokens": prompts}, 16)
    dec, _ = model.decode_fn(tree, cache, torch.argmax(logits, -1))
    return torch.stack([logits, dec])


def _jax_layout_manager(root, layout):
    return JaxCheckpointManager(root, serving_layout=layout,
                                serving_min_bytes=MIN_BYTES,
                                serving_shards=1)


def test_degraded_serving_restore_mixed_mode_bitwise(smoke, tmp_path):
    """Step 1 in the stream layout, step 2 fused, one fused record of step
    2 damaged: the degraded serving restore quarantines exactly it, adopts
    step 1's stream record for it, and serves the undamaged fused tree's
    bits; the reference names the same record and fallback."""
    jparams, cfg, model, params, prompts = smoke
    _jax_layout_manager(tmp_path, "stream").save(1, {"params": jparams},
                                                 blocking=True)
    _jax_layout_manager(tmp_path, "fused").save(2, {"params": jparams},
                                                blocking=True)
    mgr = CheckpointManager(tmp_path, device="cpu")
    victim = next(e["name"] for e in mgr.manifest()["leaves"]
                  if (e.get("handle") or {}).get("kind") == "fused")
    rt_faults.flip_pack_byte(tmp_path, victim, step=2)
    like = abstract_params(cfg)
    kw = dict(mode="fused", prefix="params", min_bytes=MIN_BYTES)
    with pytest.raises(CheckpointError, match="CRC"):
        mgr.load_for_serving(like, **kw)
    tree, _ = mgr.load_for_serving(like, policy="degraded", **kw)
    report = mgr.last_restore_report
    assert [q.name for q in report.quarantined] == [victim]
    assert report.quarantined[0].fallback.startswith("step 1")
    # the damaged fused record now runs as step 1's stream record
    assert any(isinstance(leaf, StreamedWeight) and not leaf.flat
               for _, leaf in tree_leaves(tree))
    want = _serve(model, assign_weight_modes(params, mode="fused",
                                             min_bytes=MIN_BYTES), prompts)
    assert torch.equal(_serve(model, tree, prompts).view(torch.int32),
                       want.view(torch.int32))
    jmgr = JaxCheckpointManager(tmp_path)
    jmgr.load_for_serving(jparams, policy="degraded", **kw)
    assert _quarantine(report) == _quarantine(jmgr.last_restore_report)


def test_degraded_serving_report_counts_single_quarantine(smoke, tmp_path):
    jparams, cfg, model, params, prompts = smoke
    mgr = CheckpointManager(tmp_path, serving_layout="fused",
                            serving_min_bytes=MIN_BYTES, device="cpu")
    for step in (1, 2):
        mgr.save(step, {"params": params}, blocking=True)
    victim = next(e["name"] for e in mgr.manifest()["leaves"]
                  if e.get("stack"))
    rt_faults.flip_pack_byte(tmp_path, victim, step=2)
    tree, _ = mgr.load_for_serving(abstract_params(cfg), mode="fused",
                                   prefix="params", min_bytes=MIN_BYTES,
                                   policy="degraded")
    report = mgr.last_restore_report
    assert len(report.quarantined) == 1
    assert report.quarantined[0].name == victim
    assert report.quarantined[0].fallback.startswith("step 1")
    _serve(model, tree, prompts)     # the degraded tree serves
    jmgr = JaxCheckpointManager(tmp_path)
    jmgr.load_for_serving(jparams, mode="fused", prefix="params",
                          min_bytes=MIN_BYTES, policy="degraded")
    assert _quarantine(report) == _quarantine(jmgr.last_restore_report)


def test_serve_degraded_by_default_strict_exits_1(tmp_path):
    """``serve.main --ckpt`` on a checkpoint whose newest step has one
    flipped byte: by default it serves, health ``degraded``, the logits of
    the undamaged run; ``--strict`` prints the report and exits 1 with
    health ``failed``."""
    base = ["--smoke", "--device", "cpu", "--mode", "fused", "--min-bytes",
            str(MIN_BYTES), "--batch", "2", "--prompt-len", "6", "--tokens",
            "3"]
    fresh = serve.main(base + ["--save-ckpt", str(tmp_path)])
    assert fresh["health"] == "ready"
    mgr = CheckpointManager(tmp_path, serving_layout="fused",
                            serving_min_bytes=MIN_BYTES, serving_shards=2,
                            device="cpu")
    cfg = get_smoke_config("llama3_2_1b")
    dense, _ = mgr.load({"params": abstract_params(cfg)})
    mgr.save(1, dense, blocking=True)
    victim = next(e["name"] for e in mgr.manifest(1)["leaves"]
                  if (e.get("handle") or {}).get("kind") == "fused")
    rt_faults.flip_pack_byte(tmp_path, victim, step=1)
    out = serve.main(base + ["--ckpt", str(tmp_path)])
    assert out["health"] == "degraded"
    assert [(q["name"], q["fallback"]) for q in
            out["restore"]["quarantined"]] == [(victim,
                                                "step 0 (fused record)")]
    assert torch.equal(out["logits"].view(torch.int32),
                       fresh["logits"].view(torch.int32))
    with pytest.raises(SystemExit) as exit_info:
        serve.main(base + ["--ckpt", str(tmp_path), "--strict"])
    assert exit_info.value.code == 1
    assert serve.HEALTH.state == "failed"
