"""Elastic mesh sizing and resharding of the port (``runtime/elastic.py``,
``launch/train.py``'s ``--mesh``) against the reference, in one process:

  * ``candidate_grids`` equal to the reference's for n = 1..64 under
    several ``max_model`` caps;
  * ``best_mesh_for`` equal to the reference's for every arch's smoke and
    full config at n = 1..16, ``make_mesh`` patched in both packages (as
    ``tests/test_elastic.py`` patches the reference's);
  * ``reshard`` giving each rank of (1, 4), (2, 2) and (4, 1) contiguous
    tensors of its own whose union is the whole state, and
    ``whole_shape`` undoing the cut;
  * the training state's specs named as its leaves;
  * ``--mesh`` parsed and checked against the world size.
"""
import pytest
import torch

import repro.runtime.elastic as jax_elastic
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.api import tree_leaves, tree_map_with_path
from repro_torch.launch import train
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.models.registry import abstract_params
from repro_torch.optim import adamw
from repro_torch.runtime import elastic, sharding


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread, as the suite runs it beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("max_model", [1, 2, 4, 8, 16, 32])
def test_candidate_grids_equal_reference(max_model):
    for n in range(1, 65):
        assert elastic.candidate_grids(n, max_model) == \
            jax_elastic.candidate_grids(n, max_model), (n, max_model)


@pytest.fixture
def captured_meshes(monkeypatch):
    """Both packages' ``best_mesh_for`` return the (shape, axes) they ask
    ``make_mesh`` for."""
    monkeypatch.setattr(jax_elastic, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    monkeypatch.setattr(elastic, "make_mesh",
                        lambda shape, axes, device="cuda":
                        (tuple(shape), tuple(axes)))


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_best_mesh_for_equals_reference(captured_meshes, arch, size):
    cfg = (get_smoke_config if size == "smoke" else get_config)(arch)
    jcfg = (jax_get_smoke_config if size == "smoke"
            else jax_get_config)(arch)
    for n in range(1, 17):
        for cap in (16, 4):
            assert elastic.best_mesh_for(cfg, n_devices=n, max_model=cap) \
                == jax_elastic.best_mesh_for(jcfg, n_devices=n,
                                             max_model=cap), (arch, n, cap)


def _state():
    """The smoke llama's training state, every float leaf random."""
    gen = torch.Generator().manual_seed(0)
    params = build_model(get_smoke_config("llama3_2_1b")).init(
        seed=0, device="cpu")
    opt = adamw.init(params)
    opt = opt._replace(**{k: tree_map_with_path(
        lambda _, t: torch.randn(t.shape, generator=gen), getattr(opt, k))
        for k in ("m", "v")})
    return {"params": params, "opt": opt}


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)])
def test_reshard_gives_each_rank_its_own_shards(shape):
    state = _state()
    whole = dict(tree_leaves(state))
    held = {path: 0 for path in whole}
    for rank in range(4):
        mesh = Mesh(shape, ("data", "model"), rank=rank)
        specs = elastic.train_pspecs(abstract_params(
            get_smoke_config("llama3_2_1b")), mesh)
        by_path = dict(sharding.spec_leaves(specs))
        local = elastic.reshard(state, mesh, specs)
        assert isinstance(local["opt"], adamw.AdamWState)
        for path, t in tree_leaves(local):
            want = sharding.local_shard(whole[path], by_path[path], mesh)
            assert torch.equal(t, want), path
            assert t.is_contiguous() and t.untyped_storage().nbytes() == \
                t.numel() * t.element_size(), path
            assert t.untyped_storage().data_ptr() != \
                whole[path].untyped_storage().data_ptr(), path
            assert elastic.whole_shape(t, by_path[path], mesh) == \
                tuple(whole[path].shape), path
            held[path] += t.numel()
    sharded = [p for p in whole if held[p] == whole[p].numel()]
    # every matrix and the embedding is cut into 4 pieces, the norms and
    # the step are whole on every rank
    assert {p.split("/")[-1] for p in sharded} >= {"embed", "wq", "w_down"}
    for path, t in whole.items():
        assert held[path] in (t.numel(), 4 * t.numel()), path


def test_train_spec_leaves_named_as_the_state():
    mesh = Mesh((2, 2), ("data", "model"), rank=0)
    specs = elastic.train_pspecs(abstract_params(
        get_smoke_config("llama3_2_1b")), mesh)
    assert [p for p, _ in sharding.spec_leaves(specs)] == \
        [p for p, _ in tree_leaves(_state())]
    assert dict(sharding.spec_leaves(specs))["opt/step"] == ()


@pytest.mark.parametrize("arg,world,want", [
    (None, 4, None), ("2x2", 4, (2, 2)), ("4", 4, (4,)), ("1x4", 4, (1, 4)),
    ("1x1", 1, (1, 1))])
def test_mesh_flag_parsed(arg, world, want):
    assert train.mesh_shape(arg, world) == want


@pytest.mark.parametrize("arg,world,match", [
    ("3x1", 4, "needs 3 ranks; the world has 4"),
    ("2x2x1", 4, "takes DxM"), ("0x4", 4, "takes DxM"),
    ("2x2", 1, "needs 4 ranks; the world has 1")])
def test_mesh_flag_refused(arg, world, match):
    with pytest.raises(ValueError, match=match):
        train.mesh_shape(arg, world)
