"""The pod axis of the port's training mesh without a world: the training
state's and the batch's specs on a (pod, data, model) mesh against the
reference's rules, and the dry-run's train cells on abstract pod meshes.

  * ``elastic.train_pspecs`` and ``sharding.batch_pspecs`` on a (2, 2, 2)
    pod mesh equal the reference's ``param_pspecs(mode="train")`` and
    ``batch_pspecs`` on every smoke config (the parameters and moments
    placed by "data" and "model" only, replicated across "pod"; the batch
    on ("pod", "data"), "data" or nothing, as it divides);
  * the dry-run's train cell of the smoke llama on an abstract (2, 2, 2)
    mesh: ``status`` ok, rank 0 computes B / (P·D) rows, and the gradient
    sum's wire bytes (the collectives recorded after the backward) are
    (P·D - 1) x (the gradient's bytes + the loss metrics' f32 bytes);
  * the full-size llama3_2_1b x train_4k cell on the 2x16x16 production
    mesh (``multi``): ``status`` ok, 8 of 256 rows, its gradient wire by
    the same formula (31 whole gradients), its peak under the single-pod
    cell's.
"""
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.models import registry as ref_registry
from repro.runtime import sharding as ref_sharding
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.api import tree_leaves
from repro_torch.launch import collective_stats, dryrun
from repro_torch.models import registry
from repro_torch.runtime import elastic, sharding, steps

POD_GRID = {"pod": 2, "data": 2, "model": 2}
# 8 rows split on ("pod", "data"), 2 on "data" alone, 1 on nothing
BATCHES = (8, 2, 1)
SMOKE_TRAIN = ShapeSpec("train_4k", 16, 8, "train")
# the single-pod cell's peak (rank 0 of 16x16 on meta, launch/dryrun.py)
SINGLE_POD_PEAK = 193.77 * 2 ** 30


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's torch work on one thread, as the suite runs it
    beside other workers on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref_specs(tree) -> list:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return [(ref_sharding._path_str(p), tuple(s)) for p, s in flat]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pod_mesh_specs_equal_the_references(arch):
    """The state's specs name "data" and "model" only, as the reference's
    train rules give them on the pod mesh; the moments take their
    parameters' specs, the step none; the batch goes where the
    reference's rule puts it at every batch size."""
    mesh = SimpleNamespace(shape=dict(POD_GRID))
    ref_cfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    want = _ref_specs(ref_sharding.param_pspecs(
        ref_registry.abstract_params(ref_cfg), mesh, mode="train"))
    got = elastic.train_pspecs(registry.abstract_params(cfg), mesh)
    for tree in (got["params"], got["opt"].m, got["opt"].v):
        assert list(sharding.spec_leaves(tree)) == want
    assert got["opt"].step == ()
    assert not any("pod" in str(spec) for _, spec in want)
    for b in BATCHES:
        ref_in = ref_registry.input_specs(
            ref_cfg, RefShapeSpec("train_4k", 16, b, "train"))
        port_in = registry.input_specs(cfg, ShapeSpec("train_4k", 16, b,
                                                      "train"))
        want_b = {k: tuple(v) for k, v in ref_sharding.batch_pspecs(
            ref_in, mesh, b).items()}
        assert sharding.batch_pspecs(port_in, mesh, b) == want_b, (arch, b)
        assert want_b["tokens"][0] == {8: ("pod", "data"), 2: "data",
                                       1: None}[b]


def _train_cell(monkeypatch, tmp_path, arch, shape_name, modes, **kw):
    """``dryrun.run_cell`` of a train cell, with the number of collective
    records made before the step's backward returned and the number of
    loss metrics noted."""
    seen = {}
    meshes = []
    make_mesh, grads = dryrun.production_mesh, steps.loss_and_grads

    def noting_mesh(*a, **k):
        meshes.append(make_mesh(*a, **k))
        return meshes[-1]

    def noting_grads(*a, **k):
        out = grads(*a, **k)
        seen["records"] = len(meshes[-1].records)
        seen["metrics"] = len(out[1])
        return out

    monkeypatch.setattr(dryrun, "production_mesh", noting_mesh)
    monkeypatch.setattr(steps, "loss_and_grads", noting_grads)
    rec = dryrun.run_cell(arch, shape_name, tmp_path, modes, **kw)
    reduce = collective_stats.collective_stats(
        meshes[-1].records[seen["records"]:])
    return rec, meshes[-1], reduce, seen["metrics"]


def _grad_bytes(cfg) -> int:
    return sum(t.numel() * t.element_size()
               for _, t in tree_leaves(registry.abstract_params(cfg)))


def test_smoke_train_cell_on_a_pod_mesh(monkeypatch, tmp_path):
    """llama smoke on an abstract (2, 2, 2) mesh: ok, 8 / 4 = 2 rows, and
    the gradient sum's wire (P·D - 1) x the gradient's and the metrics'
    bytes, every record after the backward a broadcast."""
    cfg = get_smoke_config("llama3_2_1b")
    rec, mesh, reduce, metrics = _train_cell(
        monkeypatch, tmp_path, "llama3_2_1b", "train_4k", ["single"],
        mesh_shape=(2, 2, 2), cfg=cfg, shape=SMOKE_TRAIN)
    assert rec["status"] == rec["single"]["status"] == "ok", rec
    assert tuple(mesh.shape) == ("pod", "data", "model")
    program = rec["single"]["full"]["program"]
    assert "on 2 of 8 rows" in program
    assert "(batch on ('pod', 'data'))" in program
    assert set(reduce) - {"total_wire_bytes", "total_count"} == {"broadcast"}
    n = 4
    assert reduce["total_wire_bytes"] == (n - 1) * (
        _grad_bytes(cfg) + 4 * (1 + metrics))
    assert (tmp_path / "llama3_2_1b__train_4k__mesh2x2x2.json").exists()


def test_full_size_train_cell_on_the_multi_pod_mesh(monkeypatch, tmp_path):
    """llama3_2_1b x train_4k on rank 0 of 2x16x16: ok, 8 of 256 rows, the
    gradient sum's wire 31 whole gradients (and the metrics), the peak
    under the single-pod cell's."""
    cfg = get_config("llama3_2_1b")
    rec, mesh, reduce, metrics = _train_cell(
        monkeypatch, tmp_path, "llama3_2_1b", "train_4k", ["multi"])
    assert rec["status"] == rec["multi"]["status"] == "ok", rec
    assert dict(mesh.shape) == {"pod": 2, "data": 16, "model": 16}
    full = rec["multi"]["full"]
    assert "on 8 of 256 rows" in full["program"]
    assert reduce["total_wire_bytes"] == 31 * (
        _grad_bytes(cfg) + 4 * (1 + metrics))
    assert full["memory"]["peak_memory_in_bytes"] < SINGLE_POD_PEAK
