"""The port's placement rules (``repro_torch/runtime/sharding.py``,
``runtime/collectives.py:serving_pspecs``, ``launch/mesh.py``) held
against the reference's on the same trees.

The reference's rules read only ``mesh.shape``, so both run in-process on
duck-typed meshes: grids of 1, 2, 4, 8, 16 and 256 ranks, with and
without a ``"pod"`` axis.  A reference spec is a ``PartitionSpec``; the
port's is the plain tuple ``tuple(PartitionSpec(...))``.  Compared:

  * every smoke config's parameter tree (shapes as the reference's
    ``abstract_params``) in modes ``train``, ``serve`` and ``serve_ep``;
  * the smoke llama's stream and fused handle trees, built by each
    package from the same seeded weights (``param_pspecs`` and
    ``serving_pspecs``), and bare CompressedTensors (``ct_pspecs``), also
    a rank's placed slice of one;
  * ``cache_pspecs`` / ``batch_pspecs`` on every config's cache, and
    ``logits_pspec``;
  * ``largest_model_axis`` and the host mesh's factorisations;
  * ``stream_nbytes`` on records deserialized by each package.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import wire as jax_wire
from repro.core.codec_api import Codec as JaxCodec
from repro.core.codec_api import use_codec as jax_use_codec
from repro.launch.mesh import largest_model_axis as jax_largest_model_axis
from repro.launch.mesh import make_host_mesh as jax_make_host_mesh
from repro.models.registry import abstract_params as jax_abstract_params
from repro.models.registry import cache_specs as jax_cache_specs
from repro.runtime import collectives as jax_collectives
from repro.runtime import sharding as jax_sharding
from repro.runtime.streaming import assign_weight_modes as jax_assign
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import wire
from repro_torch.core.codec_api import Codec, use_codec
from repro_torch.launch import mesh as tmesh
from repro_torch.models.registry import abstract_params, cache_specs
from repro_torch.runtime import collectives, sharding
from repro_torch.runtime.streaming import (assign_weight_modes,
                                           tree_map_with_path)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Run this module's torch work on one thread, as the suite runs it
    beside other workers on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GRIDS = {
    "1": {"data": 1, "model": 1},
    "2": {"data": 1, "model": 2},
    "4": {"data": 2, "model": 2},
    "8": {"data": 2, "model": 4},
    "8pod": {"pod": 2, "data": 2, "model": 2},
    "16": {"data": 4, "model": 4},
    "16dp": {"data": 16},
    "256": {"data": 16, "model": 16},
    "256pod": {"pod": 2, "data": 8, "model": 16},
}
MODES = ("train", "serve", "serve_ep")


class _Mesh:
    """A duck-typed mesh: the rules read ``shape``; placement also reads
    this rank's coordinates."""

    def __init__(self, shape, coords=None):
        self.shape = dict(shape)
        self.coords = dict(coords or {})

    def axis_index(self, axis):
        return self.coords.get(axis, 0)


def _jax_specs(tree) -> list:
    """(path, tuple) of a reference spec tree, in its flatten order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return [(jax_sharding._path_str(p), tuple(s)) for p, s in flat]


def _port_specs(tree) -> list:
    return list(sharding.spec_leaves(tree))


def _specs_only(pairs) -> list:
    return [s for _, s in pairs]


@pytest.fixture(scope="module")
def shapes():
    """Every smoke config's abstract parameter tree in both packages."""
    return {arch: (jax_abstract_params(jax_smoke_config(arch)),
                   abstract_params(get_smoke_config(arch)))
            for arch in ARCH_IDS}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plain_tree_specs_equal_the_reference(shapes, arch, mode):
    jtree, ttree = shapes[arch]
    for label, grid in GRIDS.items():
        mesh = SimpleNamespace(shape=grid)
        want = _jax_specs(jax_sharding.param_pspecs(jtree, mesh, mode=mode))
        got = _port_specs(sharding.param_pspecs(ttree, mesh, mode=mode))
        assert got == want, (arch, mode, label)


def seeded_params(arch: str, seed: int = 0):
    """Seeded weights for the smoke ``arch`` as the reference's tree of
    JAX arrays and the port's of tensors, the same bits in both (bf16
    through its int16 view)."""
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(seed)

    def one(path, meta):
        x = (rng.standard_normal(tuple(meta.shape)) * 0.02).astype(
            np.float32)
        return jnp.asarray(x, jnp.dtype(str(meta.dtype).split(".")[-1]))

    jparams = tree_map_with_path(one, abstract_params(cfg))
    return jparams, params_from_jax(jax.device_get(jparams), "cpu", cfg=cfg)


@pytest.fixture(scope="module")
def handle_trees():
    """The smoke llama's stream and fused handle trees, each package's,
    from the same weights (1024-element blocks and 4 shards, so the layer
    leaves stream and shard)."""
    jparams, params = seeded_params("llama3_2_1b")
    jcodec, codec = JaxCodec(block_elems=1024), Codec(block_elems=1024)
    out = {}
    for mode in ("stream", "fused"):
        with jax_use_codec(jcodec):
            jtree = jax_assign(jparams, mode=mode, min_bytes=1024, shards=4,
                               codec=jcodec)
        with use_codec(codec):
            ttree = assign_weight_modes(params, mode=mode, min_bytes=1024,
                                        shards=4, codec=codec)
        out[mode] = (jtree, ttree)
    return out


@pytest.mark.parametrize("mode", ["stream", "fused"])
def test_handle_tree_specs_equal_the_reference(handle_trees, mode):
    jtree, ttree = handle_trees[mode]
    sharded = 0
    for label, grid in GRIDS.items():
        mesh = SimpleNamespace(shape=grid)
        want = _jax_specs(jax_sharding.param_pspecs(jtree, mesh,
                                                    mode="serve"))
        got = _port_specs(sharding.param_pspecs(ttree, mesh, mode="serve"))
        assert _specs_only(got) == _specs_only(want), (mode, label)
        want = _jax_specs(jax_collectives.serving_pspecs(jtree, mesh))
        got = _port_specs(collectives.serving_pspecs(ttree, mesh))
        assert _specs_only(got) == _specs_only(want), (mode, label)
        sharded += sum("model" in s for s in _specs_only(got))
    assert sharded, "no stream placed on the model axis in any grid"


def test_placed_tree_keeps_the_whole_trees_specs(handle_trees):
    """A rank's slice (its own shard rows) has the whole tree's specs, and
    its rows are the whole tree's ``local_shard`` under them."""
    _, ttree = handle_trees["stream"]
    for coord in range(4):
        mesh = _Mesh({"data": 1, "model": 4}, {"model": coord})
        placed = collectives.place_serving_tree(ttree, mesh)
        whole = collectives.serving_pspecs(ttree, mesh)
        assert _port_specs(collectives.serving_pspecs(placed, mesh)) == \
            _port_specs(whole)
        for (path, spec), (_, leaf), (_, mine) in zip(
                _port_specs(whole), _stream_arrays(ttree),
                _stream_arrays(placed)):
            assert torch.equal(sharding.local_shard(leaf, spec, mesh),
                               mine), (coord, path)


def _stream_arrays(tree) -> list:
    """(path, tensor) of every array a spec tree describes, in its order."""
    out = []
    for path, leaf in collectives.tree_leaves(tree):
        ct = getattr(leaf, "ct", None)
        if ct is not None:
            arrays = ct.streams if ct.mode == "enec" else (ct.raw_bytes,)
        elif hasattr(leaf, "w"):
            arrays = (leaf.w,)
        else:
            arrays = (leaf,)
        out += [(path, a) for a in arrays]
    return out


@pytest.fixture(scope="module")
def bare_cts():
    rng = np.random.default_rng(2)
    per_layer = rng.standard_normal((64, 4096)).astype(np.float32)
    stacked = rng.standard_normal((2, 512, 256)).astype(np.float32)
    flat2d = rng.standard_normal((512, 256)).astype(np.float32)
    jc, tc = JaxCodec(), Codec()
    jx = {k: jnp.asarray(v, jnp.bfloat16) for k, v in
          (("a", per_layer), ("b", stacked), ("c", flat2d))}
    tx = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in
          (("a", per_layer), ("b", stacked), ("c", flat2d))}
    j = {"a": jc.compress_array(jx["a"], shards=4),
         "b": jc.compress_stacked(jx["b"], shards=4),
         "c": jc.compress_stacked(jx["c"][None], shards=1),
         "r": jc.compress_array(jnp.arange(64, dtype=jnp.int32))}
    t = {"a": tc.compress_array(tx["a"], shards=4),
         "b": tc.compress_stacked(tx["b"], shards=4),
         "c": tc.compress_stacked(tx["c"][None], shards=1),
         "r": tc.compress_array(torch.arange(64, dtype=torch.int32))}
    return j, t


@pytest.mark.parametrize("key", ["a", "b", "c", "r"])
def test_bare_compressed_tensor_specs_equal_the_reference(bare_cts, key):
    """A per-layer and a stacked sharded tensor put their shard dim (0,
    and 1 under the stack) on "model"; a flat L=1 stack and a raw escape
    replicate; a rank's placed slice keeps the whole's specs."""
    j, t = bare_cts
    for label, grid in GRIDS.items():
        mesh = SimpleNamespace(shape=grid)
        want = _specs_only(_jax_specs(jax_sharding.ct_pspecs(j[key], mesh)))
        got = _specs_only(_port_specs(sharding.ct_pspecs(t[key], mesh)))
        assert got == want, (key, label)
        placed = collectives.place_ct(t[key], _Mesh(grid, {"model": 0}))
        assert _specs_only(_port_specs(
            sharding.ct_pspecs(placed, mesh))) == want, (key, label)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_the_reference(arch):
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    for b in (1, 2, 4, 16):
        jcache = jax_cache_specs(jcfg, b, 16)
        cache = cache_specs(cfg, b, 16)
        for label, grid in GRIDS.items():
            mesh = SimpleNamespace(shape=grid)
            want = _jax_specs(jax_sharding.cache_pspecs(jcache, mesh, b))
            got = _port_specs(sharding.cache_pspecs(cache, mesh, b))
            assert got == want, (arch, b, label)
            want = _jax_specs(jax_sharding.batch_pspecs(
                {"tokens": jax.ShapeDtypeStruct((b, 16), jnp.int32),
                 "cache": jcache}, mesh, b))
            got = _port_specs(sharding.batch_pspecs(
                {"tokens": torch.empty((b, 16), device="meta"),
                 "cache": cache}, mesh, b))
            assert got == want, (arch, b, label)


def test_logits_and_batch_axis_equal_the_reference():
    for grid in GRIDS.values():
        mesh = SimpleNamespace(shape=grid)
        for b in (1, 2, 3, 4, 8, 16, 32, 64):
            assert sharding.batch_axis(mesh, b) == \
                jax_sharding.batch_axis(mesh, b)
            for vocab in (1000, 1024, 32000, 128256, 256000):
                assert sharding.logits_pspec(mesh, b, vocab) == tuple(
                    jax_sharding.logits_pspec(mesh, b, vocab)), (grid, b)


def test_largest_model_axis_equals_the_reference():
    for n in range(1, 65):
        for cap in (None, *range(1, n + 2)):
            assert tmesh.largest_model_axis(n, cap) == \
                jax_largest_model_axis(n, cap), (n, cap)


def test_host_mesh_factorisations():
    """The reference's 8-device table (tests/test_mesh_exec.py) over a
    world of 8, and this process's one device against the reference's
    own ``make_host_mesh``."""
    shape = tmesh.host_mesh_shape
    assert shape(8) == {"data": 8}
    assert shape(8, model=2) == {"data": 4, "model": 2}
    assert shape(8, model="max") == {"data": 1, "model": 8}
    assert shape(8, model="max", max_model=5) == {"data": 2, "model": 4}
    assert shape(8, max_model=4) == {"data": 2, "model": 4}
    with pytest.raises(ValueError, match="does not divide"):
        shape(8, model=3)
    n = len(jax.devices())
    for kw in ({}, {"model": 1}, {"model": "max"}, {"max_model": 4}):
        assert shape(n, **kw) == dict(jax_make_host_mesh(**kw).shape), kw
    # a world of one process: the mesh needs no process group
    mesh = tmesh.make_host_mesh(model=1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.coords == {"data": 0, "model": 0}
    assert mesh.axis_ranks("model") == (0,)


def test_production_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")


def test_backend_rule():
    """NCCL only when every rank of a host has a card of its own."""
    assert tmesh.choose_backend("cpu", 4, 0) == "gloo"
    assert tmesh.choose_backend("cuda", 2, 1) == "gloo"
    assert tmesh.choose_backend("cuda", 4, 1) == "gloo"
    assert tmesh.choose_backend("cuda", 4, 4) == "nccl"
    assert tmesh.choose_backend("cuda", 1, 8) == "nccl"


@pytest.mark.parametrize("case", ["bf16_shards4", "stacked_shards2",
                                  "fp32_shards4"])
def test_stream_nbytes_equals_the_reference(case):
    """``stream_nbytes`` of records each package deserialized from the
    same wire bytes; a rank's placed slice counts the whole."""
    rng = np.random.default_rng(5)
    if case == "stacked_shards2":
        x = torch.from_numpy(rng.standard_normal(
            (3, 256, 512)).astype(np.float32)).to(torch.bfloat16)
        ct = Codec(block_elems=1024).compress_stacked(x, shards=2)
        blob, stacked = wire.to_wire(ct, stacked=True), True
    else:
        dt = torch.bfloat16 if case.startswith("bf16") else torch.float32
        x = torch.from_numpy(rng.standard_normal(
            (128, 1024)).astype(np.float32)).to(dt)
        ct = Codec(block_elems=1024).compress_array(x, shards=4)
        blob, stacked = wire.to_wire(ct), False
    assert ct.mode == "enec"
    mine = wire.from_wire(blob, Codec(), device="cpu")
    ref = jax_wire.from_wire(blob, JaxCodec())
    want = jax_collectives.stream_nbytes(ref)
    assert collectives.stream_nbytes(mine) == want
    assert collectives.stream_nbytes(ct) == want
    mesh = _Mesh({"model": 2}, {"model": 1})
    placed = collectives.place_ct(mine, mesh)
    assert collectives.is_placed(placed) and not collectives.is_placed(mine)
    assert collectives.stream_nbytes(placed) == want
    assert placed.nbytes_wire() == ct.nbytes_wire()
    # an upload of only this rank's shard rows is the placed slice
    own = wire.from_wire(blob, Codec(), device="cpu",
                         stream_place=collectives.stream_placer(mesh))
    assert own.shards == ct.shards
    for a, b in zip(own.streams, placed.streams):
        assert torch.equal(a, b)
    assert own.nbytes_wire() == ct.nbytes_wire()
    assert stacked == sharding.ct_stacked(own)
