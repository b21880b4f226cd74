"""The port's enec-v2 checkpoints against ``repro.checkpoint`` on the smoke
llama3_2_1b: each package restores and serves what the other saved, both
write byte-identical packs, and the strict restore names the damaged
record.  Serving-layout records are stored at 2 TP shards.

Tolerances: restored trees and packs are compared exactly (the format is
lossless); the port's logits against the reference's within ``2**-8``, the
f32 sum order inside a 128-term tile product (as in test_torch_serve.py);
the port's logits against the port's own fresh run bitwise.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint.ckpt import CheckpointError, CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import wire
from repro_torch.core.codec_api import Codec
from repro_torch.models import build_model
from repro_torch.models.lm import abstract_params
from repro_torch.runtime.streaming import (MATMUL_LEAF_NAMES,
                                           assign_weight_modes)


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


MIN_BYTES, SHARDS, STEPS = 1024, 2, 4
LOGIT_ATOL = 2.0 ** -8
LAYOUTS = ["fused", "stream"]


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config("llama3_2_1b")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_smoke_config("llama3_2_1b")
    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    return jmodel, jparams, cfg, build_model(cfg), params, prompts


def _serve_jax(model, tree, prompts):
    logits, cache = model.prefill_fn(
        tree, {"tokens": jnp.asarray(prompts, jnp.int32)}, 8 + STEPS)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out, toks = [np.asarray(logits)], [np.asarray(tok)]
    for _ in range(STEPS):
        logits, cache = model.decode_fn(tree, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(np.asarray(logits))
        toks.append(np.asarray(tok))
    return np.stack(out), np.stack(toks)


def _serve_torch(model, tree, prompts):
    logits, cache = model.prefill_fn(
        tree, {"tokens": torch.from_numpy(prompts)}, 8 + STEPS)
    tok = torch.argmax(logits, -1)
    out, toks = [logits], [tok]
    for _ in range(STEPS):
        logits, cache = model.decode_fn(tree, cache, tok)
        tok = torch.argmax(logits, -1)
        out.append(logits)
        toks.append(tok)
    return torch.stack(out), torch.stack(toks)


def _port_manager(root, layout, codec=None):
    return CheckpointManager(root, serving_layout=layout,
                             serving_min_bytes=MIN_BYTES,
                             serving_shards=SHARDS, codec=codec,
                             device="cpu")


def _jax_manager(root, layout):
    return JaxCheckpointManager(root, serving_layout=layout,
                                serving_min_bytes=MIN_BYTES,
                                serving_shards=SHARDS)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_reference_checkpoint_serves_in_the_port(smoke, tmp_path, layout):
    jmodel, jparams, cfg, model, params, prompts = smoke
    jmgr = _jax_manager(tmp_path, layout)
    jmgr.save(1, {"params": jparams}, blocking=True)
    jtree, _ = jmgr.load_for_serving(jparams, mode=layout, prefix="params",
                                     min_bytes=MIN_BYTES, shards=SHARDS)
    want_logits, want_toks = _serve_jax(jmodel, jtree, prompts)

    codec = Codec()
    mgr = CheckpointManager(tmp_path, codec=codec, device="cpu")
    tree, manifest = mgr.load_for_serving(
        abstract_params(cfg), mode=layout, prefix="params",
        min_bytes=MIN_BYTES, shards=SHARDS)
    assert manifest["step"] == 1
    logits, toks = _serve_torch(model, tree, prompts)
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                               atol=LOGIT_ATOL)
    fresh = assign_weight_modes(params, mode=layout, min_bytes=MIN_BYTES,
                                shards=SHARDS)
    fresh_logits, _ = _serve_torch(model, fresh, prompts)
    assert torch.equal(logits.view(torch.int32),
                       fresh_logits.view(torch.int32))

    # only compressed bytes crossed for the matmul leaves, and the restore
    # decoded once per bucket of its plan
    h2d = codec.link_stats()["h2d"]
    assert h2d["compressed_bytes"] > 0
    assert not [n for n in mgr.last_dense_records
                if n.rsplit("/", 1)[-1] in MATMUL_LEAF_NAMES]
    assert codec.decode_cache_stats()["dispatches"] == \
        len(mgr.last_decode_plan.buckets)


@pytest.mark.parametrize("layout", [None] + LAYOUTS)
def test_packs_byte_identical_to_the_reference(smoke, tmp_path, layout):
    _, jparams, _, _, params, _ = smoke
    _port_manager(tmp_path / "port", layout).save(
        3, {"params": params}, blocking=True)
    _jax_manager(tmp_path / "ref", layout).save(
        3, {"params": jparams}, blocking=True)
    step = "step_000000000003"
    port_dir, ref_dir = tmp_path / "port" / step, tmp_path / "ref" / step
    names = sorted(p.name for p in ref_dir.iterdir())
    assert sorted(p.name for p in port_dir.iterdir()) == names
    packs = [n for n in names if n.startswith("pack-")]
    assert packs
    for name in packs:
        assert (port_dir / name).read_bytes() == \
            (ref_dir / name).read_bytes(), name
    man, ref_man = (json.loads((d / "manifest.json").read_text())
                    for d in (port_dir, ref_dir))
    man.pop("save_s")
    ref_man.pop("save_s")
    assert man == ref_man


@pytest.fixture
def saved(smoke, tmp_path):
    """A port checkpoint in the fused layout, and a record of it that is
    stored as a fused handle."""
    _, _, cfg, _, params, _ = smoke
    _port_manager(tmp_path, "fused").save(1, {"params": params},
                                          blocking=True)
    mgr = CheckpointManager(tmp_path, device="cpu")
    man = mgr.manifest()
    e = next(x for x in man["leaves"]
             if x.get("handle", {}).get("kind") == "fused")
    return mgr, man, e, abstract_params(cfg)


def _load(mgr, like):
    return mgr.load_for_serving(like, mode="fused", prefix="params",
                                min_bytes=MIN_BYTES, shards=SHARDS)


def _names_coordinates(err, e, man):
    msg = str(err.value)
    assert f"record={e['name']}" in msg, msg
    assert f"pack={man['packs'][e['pack']]}" in msg, msg
    assert f"offset={e['offset']}" in msg, msg


def test_flipped_pack_byte_names_the_record(saved, tmp_path):
    mgr, man, e, like = saved
    pack = tmp_path / "step_000000000001" / man["packs"][e["pack"]]
    buf = bytearray(pack.read_bytes())
    buf[e["offset"] + wire.FRAME_HEADER_BYTES + e["bytes"] // 2] ^= 0x08
    pack.write_bytes(bytes(buf))
    with pytest.raises(CheckpointError, match="CRC") as err:
        _load(mgr, like)
    _names_coordinates(err, e, man)


def test_missing_record_names_the_record(saved, tmp_path):
    mgr, man, e, like = saved
    # the record's bytes are gone from its pack ...
    pack = tmp_path / "step_000000000001" / man["packs"][e["pack"]]
    pack.write_bytes(pack.read_bytes()[:e["offset"] + e["length"] // 2])
    with pytest.raises(CheckpointError, match="truncated") as err:
        _load(mgr, like)
    _names_coordinates(err, e, man)
    # ... or from the manifest
    mpath = tmp_path / "step_000000000001" / "manifest.json"
    man2 = dict(man, leaves=[x for x in man["leaves"]
                             if x["name"] != e["name"]])
    mpath.write_text(json.dumps(man2))
    with pytest.raises(CheckpointError, match="lacks") as err:
        _load(mgr, like)
    assert f"record={e['name']}" in str(err.value)


def test_shape_mismatch_names_the_record(saved):
    mgr, man, e, like = saved
    path = e["name"].split("/")[1:]          # drop the "params" prefix
    node = like
    for k in path[:-1]:
        node = node[int(k)] if isinstance(node, list) else node[k]
    t = node[path[-1]]
    node[path[-1]] = torch.empty(t.shape[:-1] + (t.shape[-1] + 128,),
                                 dtype=t.dtype, device="meta")
    with pytest.raises(CheckpointError, match="vs model") as err:
        _load(mgr, like)
    _names_coordinates(err, e, man)


@pytest.mark.parametrize("mode", ["fused", "stream", "dense"])
def test_serve_save_ckpt_then_ckpt_bitwise_on_cpu(tmp_path, mode):
    from repro_torch.launch import serve
    base = ["--smoke", "--device", "cpu", "--mode", mode, "--tokens", "3",
            "--batch", "2", "--prompt-len", "8", "--min-bytes",
            str(MIN_BYTES)]
    saved_run = serve.main(base + ["--save-ckpt", str(tmp_path)])
    assert saved_run["save"]["bytes_on_disk"] > 0
    restored = serve.main(base + ["--ckpt", str(tmp_path)])
    assert torch.equal(restored["tokens"], saved_run["tokens"])
    assert torch.equal(restored["logits"].view(torch.int32),
                       saved_run["logits"].view(torch.int32))
    info = restored["restore"]
    assert info["decode_dispatches"] == info["plan_buckets"]
    assert info["ratio"] == pytest.approx(saved_run["save"]["ratio"])
    assert not [n for n in info["dense_records"]
                if n.rsplit("/", 1)[-1] in MATMUL_LEAF_NAMES]
    if mode != "dense":
        assert info["h2d_compressed_bytes"] > info["h2d_dense_bytes"]


@pytest.mark.parametrize("what", ["unknown_policy", "mesh",
                                  "expert_records"])
def test_unported_restore_options_raise_clearly(saved, tmp_path, what):
    """Mesh placement waits for a later slice: asking for it raises, it is
    never silently ignored; a manager that writes per-expert records
    (ported since) refuses it as well.  A restore policy that exists in
    neither package (the degraded one is ported) is rejected by name, as
    the reference rejects it."""
    mgr, _, _, like = saved
    if what == "unknown_policy":
        with pytest.raises(ValueError, match="unknown restore policy"):
            mgr.load({"params": like}, policy="yolo")
        return
    with pytest.raises(CheckpointError, match="not ported yet"):
        if what == "expert_records":
            CheckpointManager(mgr.root, expert_records=True,
                              serving_layout="stream",
                              device="cpu").load_for_serving(
                like, prefix="params", mesh=object())
        else:
            mgr.load_for_serving(like, prefix="params", mesh=object())
