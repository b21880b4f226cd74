"""The port's expert streaming (``repro_torch/runtime/experts.py``) through
the scenarios of tests/test_experts.py, on the smoke phi3_5_moe with its
seeded JAX weights carried over by ``convert.params_from_jax``, each held
against ``repro.runtime.experts`` on the same weights:

  * per-expert records byte-identical to the reference's, and restored
    bit-exactly;
  * the LRU's ``stats()`` equal to the reference's under the same fetch
    scripts (all keys but ``decode_s``, a wall time), routed experts
    bit-exact and unrouted slots absent (``None``: the port does not
    compute them, the reference multiplies zeros);
  * one fetch's misses decode in O(#buckets) launches;
  * serve logits bitwise equal to the dense stacks at any budget
    (unbounded, eviction-forcing, zero) in every weight mode, with the
    store's counters equal to the reference's over the same serve;
  * enec-v2 checkpoints with ``expert_records=True``: packs byte-identical
    to the reference's, a reference checkpoint restored in the port and a
    port checkpoint in the reference, restored into a store without an
    upload or a decode of a cold expert.
  * a restore of expert records onto a serving mesh refused, as the
    reference refuses it (``test_ckpt_expert_records_refuse_mesh``).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.runtime.experts import ExpertStore as JaxExpertStore
from repro.runtime.experts import install_expert_store as jax_install
from repro_torch.checkpoint.ckpt import CheckpointError, CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.codec_api import Codec
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.lm import abstract_params
from repro_torch.runtime.experts import (ExpertRef, ExpertStore,
                                         ExpertStoreError,
                                         install_expert_store)
from repro_torch.runtime.streaming import (assign_weight_modes, mode_mix,
                                           stream_stats, tree_leaves,
                                           tree_map_with_path)
from repro_torch.runtime.weights import handle_kind


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


ARCH = "phi3_5_moe_42b_a6_6b"
# two distinct record geometries: e_gate/e_up are (D, F), e_down is (F, D)
N_GEOMS = 2
MIN_BYTES = 1024
STAT_KEYS = ("hits", "misses", "evictions", "fetches", "fetch_records",
             "fetch_buckets", "records", "record_bytes", "resident_experts",
             "resident_bytes", "budget_bytes", "leaves")


@pytest.fixture(scope="module")
def smoke():
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), scan_layers=True)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = get_smoke_config(ARCH)
    params = params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    return jmodel, jparams, cfg, build_model(cfg), params, prompts


def _stats(store) -> dict:
    st = store.stats()
    return {k: st[k] for k in STAT_KEYS}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def _np_bits(a) -> np.ndarray:
    return np.asarray(jax.device_get(a)).view(np.uint16)


def _expert_leaves(params):
    moe = params["period"][0]["moe"]
    return {f"period/0/moe/{k}": moe[k] for k in ("e_gate", "e_up",
                                                  "e_down")}


@pytest.fixture(scope="module")
def installed(smoke):
    """Each package's ``install_expert_store`` on the same weights, once:
    the port's tree and both stores (encoding is the slow part)."""
    _, jparams, _, _, params, _ = smoke
    jtree, jstore = jax_install(jparams)
    tree, store = install_expert_store(params, codec=Codec(), device="cpu")
    return tree, store, jstore, jtree


def _refill(fresh, store):
    for name in store.names():
        fresh.add_meta(name, **store.meta(name))
        for l, j, body in store.records_for(name):
            fresh.add_record(name, l, j, body)
    return fresh


def _stores(installed, budget=None):
    """Fresh stores at ``budget`` holding the installed records, and the
    port's tree with its expert handles on the fresh port store."""
    tree, store, jstore, _ = installed
    fresh = _refill(ExpertStore(budget_bytes=budget, codec=Codec(),
                                device="cpu"), store)
    jfresh = _refill(JaxExpertStore(budget_bytes=budget), jstore)
    tree = tree_map_with_path(
        lambda path, leaf: fresh.ref(path) if isinstance(leaf, ExpertRef)
        else leaf, tree)
    return tree, fresh, jfresh


def _jax_tree(installed, jstore):
    """The reference's installed tree with its expert handles on
    ``jstore``."""
    from repro.runtime.experts import ExpertRef as JaxExpertRef
    return jax.tree.map(
        lambda leaf: jstore.ref(leaf.name)
        if isinstance(leaf, JaxExpertRef) else leaf, installed[3],
        is_leaf=lambda x: isinstance(x, JaxExpertRef))


def _serve(model, tree, prompts, max_len=16):
    """Prefill and one decode step, as tests/test_experts.py serves."""
    logits, cache = model.prefill_fn(
        tree, {"tokens": torch.from_numpy(prompts)}, max_len)
    dec, _ = model.decode_fn(tree, cache, torch.argmax(logits, -1))
    return logits, dec


def _assert_same_logits(got, want, msg=""):
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), msg


def test_records_byte_identical_and_roundtrip_bit_exact(smoke, installed):
    _, _, _, _, params, _ = smoke
    tree, store, jstore, _ = installed
    dense = _expert_leaves(params)
    assert store.names() == jstore.names() == sorted(dense)
    for name, orig in dense.items():
        assert store.meta(name) == {**jstore.meta(name),
                                    "expert_shape": tuple(
                                        jstore.meta(name)["expert_shape"])}
        assert store.records_for(name) == jstore.records_for(name), name
        assert store.complete(name)
        got = store.materialize_leaf(name)
        assert got.shape == orig.shape
        assert torch.equal(_bits(got), _bits(orig)), name
    moe = tree["period"][0]["moe"]
    for k in ("e_gate", "e_up", "e_down"):
        assert isinstance(moe[k], ExpertRef)
        assert moe[k].raw_nbytes() == dense[f"period/0/moe/{k}"].numel() * 2
    assert _stats(store) == {k: jstore.stats()[k] for k in STAT_KEYS}


def test_lru_counters_and_eviction_match_reference(smoke, installed):
    _, store, jstore = _stores(installed)
    names = store.names()
    per_expert = sum(store.expert_nbytes(n) for n in names)
    assert per_expert == sum(jstore.expert_nbytes(n) for n in names)

    outs = store.fetch_step(names, 0, np.array([0, 1]))
    jstore.fetch_step(names, 0, np.array([0, 1]))
    st = store.stats()
    assert st["misses"] == 2 * len(names) and st["hits"] == 0
    assert st["resident_bytes"] == 2 * per_expert
    assert _stats(store) == {k: jstore.stats()[k] for k in STAT_KEYS}
    for n, full in zip(names, outs):
        ref = store.materialize_leaf(n)[0]
        for j in (0, 1):
            assert torch.equal(_bits(full[j]), _bits(ref[j]))
        assert all(full[j] is None for j in range(2, len(full)))
    # a repeat of the same step is all hits, no new fetch
    store.fetch_step(names, 0, np.array([1, 0]))
    jstore.fetch_step(names, 0, np.array([1, 0]))
    assert store.stats()["hits"] == 2 * len(names)
    assert store.stats()["fetches"] == 1
    assert _stats(store) == {k: jstore.stats()[k] for k in STAT_KEYS}
    # LRU order: a layer-1 fetch under a 2-expert budget evicts layer 0
    store.budget_bytes = jstore.budget_bytes = 2 * per_expert
    store.fetch_step(names, 1, np.array([2, 3]))
    jstore.fetch_step(names, 1, np.array([2, 3]))
    st = store.stats()
    assert st["evictions"] == 2 * len(names)
    assert st["resident_bytes"] == 2 * per_expert
    assert _stats(store) == {k: jstore.stats()[k] for k in STAT_KEYS}


def _storages(store) -> dict:
    """The distinct storages the store's cache holds: pointer -> bytes."""
    return {a.untyped_storage().data_ptr(): a.untyped_storage().nbytes()
            for a in store._lru.values()}


def test_cache_holds_each_decoded_expert_once(smoke, installed):
    """A fetch's experts are cached as views of their launch's output (no
    copy); once the trim evicts one of them, the others are copied out, so
    the cache holds exactly ``resident_bytes`` and nothing of the evicted
    expert."""
    _, store, _ = _stores(installed)
    names = store.names()
    routed = np.array([0, 1, 2, 3])
    outs = store.fetch_step(names, 0, routed)
    held = _storages(store)
    assert len(held) == store.last_fetch["buckets"] < len(store._lru)
    assert sum(held.values()) == store.stats()["resident_bytes"]
    # a budget one expert short: the repeat step's trim evicts the oldest
    store.budget_bytes = store.stats()["resident_bytes"] - 1
    store.fetch_step(names, 0, routed)
    st = store.stats()
    assert st["evictions"] == 1 and st["resident_experts"] == 4 * len(names) - 1
    assert (names[0], 0, 0) not in store._lru
    held = _storages(store)
    assert len(held) == len(store._lru)
    assert sum(held.values()) == st["resident_bytes"]
    for n, full in zip(names, outs):
        for j in routed:
            if (n, 0, j) in store._lru:
                assert torch.equal(_bits(store._lru[(n, 0, j)]),
                                   _bits(full[j]))


def test_zero_budget_caches_nothing_but_serves_exact(smoke, installed):
    _, store, jstore = _stores(installed, budget=0)
    names = store.names()
    outs = store.fetch_step(names, 1, np.array([3]))
    jouts = jstore.fetch_step(names, 1, np.array([3]))
    ref = store.materialize_leaf(names[0])[1]
    assert torch.equal(_bits(outs[0][3]), _bits(ref[3]))
    np.testing.assert_array_equal(_bits(outs[0][3]).numpy(),
                                  _np_bits(jouts[0][3]).view(np.int16))
    st = store.stats()
    assert st["resident_bytes"] == 0 and st["resident_experts"] == 0
    assert st["evictions"] == st["misses"] == len(names)
    assert _stats(store) == {k: jstore.stats()[k] for k in STAT_KEYS}


def test_batched_fetch_is_bucketed_not_per_expert(smoke, installed):
    _, store, jstore = _stores(installed)
    names = store.names()
    n_experts = store.meta(names[0])["n_experts"]
    codec = store.codec
    before = codec.decode_cache_stats()["dispatches"]
    store.fetch_step(names, 0, np.arange(n_experts))
    jstore.fetch_step(names, 0, np.arange(n_experts))
    lf = store.last_fetch
    assert lf == jstore.last_fetch
    assert lf["records"] == len(names) * n_experts
    assert lf["buckets"] <= N_GEOMS < lf["records"]
    # one decode launch per bucket of the fetch's plan
    assert codec.decode_cache_stats()["dispatches"] - before \
        == lf["buckets"]


def test_miss_moves_the_record_stream_bytes_host_to_device(smoke, installed):
    """A miss copies its record's stream section, nothing else, counted on
    the store's codec; a hit copies nothing."""
    _, store, _ = _stores(installed)
    name = store.names()[0]
    body = dict(((l, j), b) for l, j, b in store.records_for(name))[(0, 2)]
    codec = store.codec
    codec.reset_transfer_stats()
    store.fetch_step([name], 0, [2])
    hdr = store._headers[(name, 0, 2)]
    assert codec.transfer_stats()["h2d_bytes"] == hdr.stream_nbytes
    assert hdr.stream_nbytes == len(body) - hdr.stream_offset
    store.fetch_step([name], 0, [2])
    assert codec.transfer_stats()["h2d_bytes"] == hdr.stream_nbytes


def test_missing_record_raises(smoke, installed):
    _, store, _ = _stores(installed)
    name = store.names()[0]
    del store._records[(name, 0, 1)]
    assert store.missing(name) == [(0, 1)]
    with pytest.raises(ExpertStoreError, match="no record"):
        store.fetch_step([name], 0, np.array([1]))


def test_mode_mix_and_stream_stats_report_expert_handles(installed):
    from repro.runtime.streaming import assign_weight_modes as jax_assign
    from repro.runtime.streaming import stream_stats as jax_stream_stats
    tree, store, _ = _stores(installed)
    tree = assign_weight_modes(tree, mode="stream", min_bytes=MIN_BYTES)
    assert mode_mix(tree).get("expert") == 3, mode_mix(tree)
    assert handle_kind(tree["period"][0]["moe"]["e_gate"]) == "expert"
    assert tree["period"][0]["moe"]["e_gate"].store is store
    jtree = jax_assign(installed[3], mode="stream", min_bytes=MIN_BYTES)
    st, want = stream_stats(tree), jax_stream_stats(jtree)
    assert st["expert_tensors"] == want["expert_tensors"] == 3
    assert st["raw_bytes"] == want["raw_bytes"]
    # the reference counts its refs' (L,) int32 layer ids as device bytes;
    # the port's refs hold nothing on the device
    n_layers = store.meta(store.names()[0])["n_layers"]
    assert st["device_bytes"] == want["device_bytes"] - 3 * 4 * n_layers


@pytest.mark.parametrize("mode", ["dense", "stream", "fused"])
def test_serve_logits_bit_identical_with_expert_cache(smoke, mode, installed):
    jmodel, _, _, model, params, prompts = smoke
    ref = _serve(model, params, prompts)
    tree, store, jstore = _stores(installed)
    tree = assign_weight_modes(tree, mode=mode, min_bytes=MIN_BYTES)
    _assert_same_logits(_serve(model, tree, prompts), ref, mode)
    st = store.stats()
    assert st["fetches"] > 0 and st["evictions"] == 0
    assert st["fetch_buckets"] <= st["fetches"] * N_GEOMS
    assert st["fetch_buckets"] < st["fetch_records"]
    # the same serve in the reference fetches the same experts
    jtree = _jax_tree(installed, jstore)
    logits, cache = jmodel.prefill_fn(
        jtree, {"tokens": jnp.asarray(prompts, jnp.int32)}, 16)
    jmodel.decode_fn(jtree, cache, jnp.argmax(logits, -1).astype(jnp.int32))
    assert _stats(store) == {k: jstore.stats()[k] for k in STAT_KEYS}


@pytest.mark.parametrize("budget", [0, 40_000, None])
def test_serve_bit_identical_at_every_budget(smoke, budget, installed):
    _, _, _, model, params, prompts = smoke
    ref = _serve(model, params, prompts)
    tree, store, _ = _stores(installed, budget=budget)
    tree = assign_weight_modes(tree, mode="stream", min_bytes=MIN_BYTES)
    _assert_same_logits(_serve(model, tree, prompts), ref, str(budget))
    st = store.stats()
    assert (st["evictions"] > 0) == (budget is not None)
    assert budget is None or st["resident_bytes"] <= budget
    assert st["fetch_buckets"] <= st["fetches"] * N_GEOMS


def _port_mgr(root, **kw):
    return CheckpointManager(root, serving_layout="stream",
                             serving_min_bytes=MIN_BYTES, device="cpu",
                             **kw)


def test_ckpt_expert_records_roundtrip(smoke, tmp_path):
    _, _, cfg, model, params, prompts = smoke
    ref = _serve(model, params, prompts)
    mgr = _port_mgr(tmp_path / "ck", expert_records=True)
    mgr.save(0, {"params": params}, blocking=True)
    xent = [e for e in mgr.manifest()["leaves"]
            if (e.get("handle") or {}).get("kind") == "expert"]
    assert len(xent) == 2 * 4 * 3       # layers x experts x moe leaves

    # the training load reassembles the dense stacks bit-exactly
    out, _ = mgr.load({"params": params})
    for name, orig in _expert_leaves(params).items():
        got = out["params"]["period"][0]["moe"][name.rsplit("/", 1)[-1]]
        assert torch.equal(_bits(got), _bits(orig)), name

    # the serving load fills the store without inflating a cold expert,
    # and serves bitwise as dense
    like = abstract_params(cfg)
    tree, _ = mgr.load_for_serving(like, mode="stream", prefix="params",
                                   min_bytes=MIN_BYTES)
    store = mgr.last_expert_store
    assert store is not None
    st = store.stats()
    assert st["records"] == len(xent) and st["resident_bytes"] == 0
    # no expert record was staged to the device or joined the decode plan
    assert not store._headers
    n_leaves = len(mgr.manifest()["leaves"])
    assert mgr.last_decode_plan.n_inputs <= n_leaves - len(xent)
    _assert_same_logits(_serve(model, tree, prompts), ref)

    # a tree of ExpertRefs re-saves its records verbatim (no re-encode)
    mgr2 = _port_mgr(tmp_path / "ck2")
    mgr2.save(1, {"params": tree}, blocking=True)
    tree2, _ = mgr2.load_for_serving(like, mode="stream", prefix="params",
                                     min_bytes=MIN_BYTES)
    store2 = mgr2.last_expert_store
    for name, orig in _expert_leaves(params).items():
        assert store2.records_for(f"params/{name}") == \
            store.records_for(f"params/{name}")
        got = store2.materialize_leaf(f"params/{name}")
        assert torch.equal(_bits(got), _bits(orig)), name


def test_ckpt_expert_records_refuse_mesh(smoke, tmp_path):
    """Expert records go to a store that fetches on one device each step:
    their checkpoint refuses a serving mesh (also read by a manager that
    does not write them)."""
    _, _, cfg, _, params, _ = smoke
    mgr = _port_mgr(tmp_path, expert_records=True)
    mgr.save(0, {"params": params}, blocking=True)
    mesh = make_host_mesh(model=1, device="cpu")
    for reader in (mgr, _port_mgr(tmp_path)):
        with pytest.raises(CheckpointError, match="mesh"):
            reader.load_for_serving(abstract_params(cfg), mode="stream",
                                    prefix="params", min_bytes=MIN_BYTES,
                                    mesh=mesh)


def test_ckpt_serving_restore_into_bounded_store(smoke, tmp_path):
    _, _, cfg, model, params, prompts = smoke
    ref = _serve(model, params, prompts)
    mgr = _port_mgr(tmp_path, expert_records=True)
    mgr.save(0, {"params": params}, blocking=True)
    store = ExpertStore(budget_bytes=64 * 1024, device="cpu")
    tree, _ = mgr.load_for_serving(abstract_params(cfg), mode="stream",
                                   prefix="params", min_bytes=MIN_BYTES,
                                   expert_store=store)
    assert tree["period"][0]["moe"]["e_up"].store is store
    _assert_same_logits(_serve(model, tree, prompts), ref)
    assert store.stats()["evictions"] > 0


def test_expert_packs_byte_identical_to_the_reference(smoke, tmp_path):
    _, jparams, _, _, params, _ = smoke
    _port_mgr(tmp_path / "port", expert_records=True).save(
        3, {"params": params}, blocking=True)
    JaxCheckpointManager(tmp_path / "ref", serving_layout="stream",
                         serving_min_bytes=MIN_BYTES,
                         expert_records=True).save(
        3, {"params": jparams}, blocking=True)
    step = "step_000000000003"
    port_dir, ref_dir = tmp_path / "port" / step, tmp_path / "ref" / step
    names = sorted(p.name for p in ref_dir.iterdir())
    assert sorted(p.name for p in port_dir.iterdir()) == names
    for name in (n for n in names if n.startswith("pack-")):
        assert (port_dir / name).read_bytes() == \
            (ref_dir / name).read_bytes(), name
    man, ref_man = (json.loads((d / "manifest.json").read_text())
                    for d in (port_dir, ref_dir))
    man.pop("save_s")
    ref_man.pop("save_s")
    assert man == ref_man


def test_reference_expert_checkpoint_restores_in_the_port(smoke, tmp_path):
    _, jparams, cfg, model, params, prompts = smoke
    JaxCheckpointManager(tmp_path, serving_layout="stream",
                         serving_min_bytes=MIN_BYTES,
                         expert_records=True).save(
        0, {"params": jparams}, blocking=True)
    mgr = CheckpointManager(tmp_path, device="cpu")
    dense, _ = mgr.load({"params": params})
    for (name, a), (_, b) in zip(tree_leaves(dense["params"]),
                                 tree_leaves(params)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
    store = ExpertStore(budget_bytes=0, device="cpu")
    tree, _ = mgr.load_for_serving(abstract_params(cfg), mode="fused",
                                   prefix="params", min_bytes=MIN_BYTES,
                                   expert_store=store)
    assert mode_mix(tree)["expert"] == 3
    _assert_same_logits(_serve(model, tree, prompts),
                        _serve(model, params, prompts))


def test_port_expert_checkpoint_restores_in_the_reference(smoke, tmp_path):
    jmodel, jparams, _, _, params, prompts = smoke
    _port_mgr(tmp_path, expert_records=True).save(0, {"params": params},
                                                  blocking=True)
    jmgr = JaxCheckpointManager(tmp_path)
    back, _ = jmgr.load({"params": jparams})
    for (pa, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back["params"])[0],
            jax.tree_util.tree_flatten_with_path(jparams)[0]):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8),
                                      err_msg=str(pa))
    like = jax.eval_shape(jmodel.init, jax.random.key(0))
    jtree, _ = jmgr.load_for_serving(like, mode="stream", prefix="params",
                                     min_bytes=MIN_BYTES)
    jstore = jmgr.last_expert_store
    assert jstore is not None and jstore.stats()["resident_bytes"] == 0

    def serve(tree):
        logits, cache = jmodel.prefill_fn(
            tree, {"tokens": jnp.asarray(prompts, jnp.int32)}, 16)
        dec, _ = jmodel.decode_fn(tree, cache,
                                  jnp.argmax(logits, -1).astype(jnp.int32))
        return np.asarray(logits), np.asarray(dec)

    for got, want in zip(serve(jtree), serve(jparams)):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
