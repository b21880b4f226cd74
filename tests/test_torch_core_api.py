"""The port's tree-level codec API and the Table III weight sets against
the JAX package: ``data.synthetic_weights.generate`` byte-identical for
all ten ``PAPER_MODELS``; ``Codec.compress_tree`` records byte-identical
to the reference's on those sets and on a nested tree with escapes,
``tree_ratio`` equal, ``decompress_tree`` exact in O(#buckets) launches;
``compress_stacked`` / ``tile_weights_for_fusion`` streams equal;
``abstract_compressed`` layouts equal to the reference's
``ShapeDtypeStruct`` s; ``exponent_histogram_device`` equal bin for bin;
``repro_torch.core.__all__`` the reference's minus its deprecated
wrappers.  Every comparison is exact: the codec is lossless.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import wire as jax_wire
from repro.data import synthetic_weights as jsw
from repro_torch.core import params as tparams
from repro_torch.core import wire
from repro_torch.data import synthetic_weights as tsw

SPECS = [s.name for s in tsw.PAPER_MODELS]


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


def _np(t: torch.Tensor) -> np.ndarray:
    """A port tensor's bit patterns as unsigned numpy integers."""
    if t.element_size() == 2:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.view(torch.int32).numpy().view(np.uint32)


def _jnp_bits(x) -> np.ndarray:
    a = np.asarray(jax.device_get(x))
    return a.view(np.uint16 if a.itemsize == 2 else np.uint32)


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.fixture(scope="module")
def paper_sets():
    jtree = {s.name: jsw.generate(s) for s in jsw.PAPER_MODELS}
    ttree = {s.name: tsw.generate(s, device="cpu") for s in tsw.PAPER_MODELS}
    return jtree, ttree


@pytest.mark.parametrize("name", SPECS)
def test_generate_is_byte_identical(paper_sets, name):
    jtree, ttree = paper_sets
    assert dataclasses.astuple(tsw.by_name(name)) \
        == dataclasses.astuple(jsw.by_name(name))
    assert str(ttree[name].dtype).split(".")[-1] == str(jtree[name].dtype)
    np.testing.assert_array_equal(_np(ttree[name]), _jnp_bits(jtree[name]))


def test_generate_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsw.generate(tsw.PAPER_MODELS[0])


@pytest.fixture(scope="module")
def compressed(paper_sets):
    jtree, ttree = paper_sets
    jcodec, tcodec = jcore.Codec(), tcore.Codec()
    jplan, tplan = jcodec.plan_encode(jtree), tcodec.plan_encode(ttree)
    return (jcodec, jcodec.execute(jplan), jplan,
            tcodec, tcodec.execute(tplan), tplan)


def test_compress_tree_records_byte_identical(compressed):
    jcodec, jct, jplan, tcodec, tct, tplan = compressed
    assert set(tct) == set(jct)
    assert len(tplan.buckets) == len(jplan.buckets)
    assert tplan.predicted_wire_bytes == jplan.predicted_wire_bytes
    assert tcodec.encode_cache_stats()["dispatches"] == len(tplan.buckets)
    for name in jct:
        assert dataclasses.astuple(tct[name].params) \
            == dataclasses.astuple(jct[name].params), name
        assert wire.to_wire(tct[name]) == jax_wire.to_wire(jct[name]), name
    assert tcore.tree_ratio(tct) == jcore.tree_ratio(jct)


def test_tree_ratio_is_one_transfer(compressed, monkeypatch):
    """``tree_ratio`` fills every wire-size cache from ONE host copy."""
    _, _, _, tcodec, _, _ = compressed
    tree = {"a": torch.randn(40_000).bfloat16(),
            "b": [torch.randn(30_000).bfloat16() * 3]}
    ct = tcodec.compress_tree(tree)
    for leaf in (c for _, c in tcore.api.tree_leaves(ct)):
        leaf._wire_bytes = None
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self: calls.append(1) or real(self))
    stats = tcore.tree_ratio(ct)
    assert len(calls) == 1 and stats["tensors"] == 2


def test_decompress_tree_exact_in_one_launch_per_bucket(compressed,
                                                        paper_sets):
    _, _, _, tcodec, tct, _ = compressed
    _, ttree = paper_sets
    plan = tcodec.plan_decode(tct)
    before = tcodec.decode_cache_stats()["dispatches"]
    out = tcodec.decompress_tree(tct)
    assert tcodec.decode_cache_stats()["dispatches"] - before \
        == len(plan.buckets) == plan.dispatch_count
    assert set(out) == set(ttree)
    for name, x in ttree.items():
        assert out[name].dtype == x.dtype
        assert torch.equal(_torch(_np(out[name])), _torch(_np(x))), name


def test_wire_round_trip_of_the_tree(compressed, paper_sets):
    """The quickstart flow: records to the wire and back, decoded bitwise
    equal, and the reference reads the port's records."""
    jcodec, _, _, tcodec, tct, _ = compressed
    _, ttree = paper_sets
    back = {n: wire.from_wire(wire.to_wire(c), codec=tcodec, device="cpu")
            for n, c in tct.items()}
    dec = tcodec.decompress_tree(back)
    name = "Qwen3-32B"
    np.testing.assert_array_equal(_np(dec[name]), _np(ttree[name]))
    jback = jax_wire.from_wire(wire.to_wire(tct[name]), codec=jcodec)
    np.testing.assert_array_equal(_jnp_bits(jcodec.decompress_array(jback)),
                                  _np(ttree[name]))


def _nested(seed: int):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((96, 300)) * 0.02).astype(np.float32)
    w[rng.random(w.shape) < 3e-3] *= 64
    return {
        "layers": [{"w": w.copy(), "b": np.full((40,), 0.25, np.float32)},
                   {"w": (w * 2).astype(np.float32)}],
        "embed": np.asarray(jnp.asarray(w).astype(jnp.bfloat16)),
        "tiny": np.arange(7, dtype=np.float32),
        "ids": np.arange(12, dtype=np.int32),
    }


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return _torch(tree)


@pytest.mark.parametrize("shards", [1, 2])
def test_compress_tree_nested_with_escapes(shards):
    """Nested dicts and lists keep their structure; const, raw and
    non-float leaves escape as in the reference; records byte-identical."""
    tree = _nested(3)
    jcodec = jcore.Codec(block_elems=2048)
    tcodec = tcore.Codec(block_elems=2048)
    jct = jcodec.compress_tree(_to_jax(tree), shards=shards)
    tct = tcodec.compress_tree(_to_torch(tree), shards=shards)
    jleaves = jax.tree.leaves(jct, is_leaf=lambda x: isinstance(
        x, jcore.CompressedTensor))
    tleaves = [c for _, c in tcore.api.tree_leaves(tct)]
    assert [c.mode for c in tleaves] == [c.mode for c in jleaves]
    assert {c.mode for c in tleaves} == {"enec", "const", "raw"}
    for t, j in zip(tleaves, jleaves):
        assert wire.to_wire(t) == jax_wire.to_wire(j)
    assert isinstance(tct["layers"], list) and set(tct["layers"][0]) == {
        "w", "b"}
    assert tcore.tree_ratio(tct) == jcore.tree_ratio(jct)
    out = tcodec.decompress_tree(tct)
    for (_, got), (_, want) in zip(tcore.api.tree_leaves(out),
                                   tcore.api.tree_leaves(_to_torch(tree))):
        assert torch.equal(got.contiguous().reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8))


def test_compress_stacked_and_tile_weights_for_fusion():
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((2, 200, 300)) * 0.02).astype(np.float32)
    w[rng.random(w.shape) < 3e-3] *= 64
    wb = np.asarray(jnp.asarray(w).astype(jnp.bfloat16))
    jcodec, tcodec = jcore.Codec(), tcore.Codec()
    pairs = [(jcodec.compress_stacked(jnp.asarray(wb)),
              tcodec.compress_stacked(_torch(wb))),
             (jcodec.tile_weights_for_fusion(jnp.asarray(wb)),
              tcodec.tile_weights_for_fusion(_torch(wb))),
             (jcodec.tile_weights_for_fusion(jnp.asarray(wb[0])),
              tcodec.tile_weights_for_fusion(_torch(wb[0])))]
    for jct, tct in pairs:
        assert dataclasses.astuple(tct.params) \
            == dataclasses.astuple(jct.params) and tct.shape == jct.shape
        for f in tct.streams._fields:
            np.testing.assert_array_equal(
                getattr(tct.streams, f).numpy(),
                np.asarray(getattr(jct.streams, f)))
    w_tiles = tcodec.untile_matmul_weight(pairs[2][1], 200, 300)
    assert torch.equal(w_tiles.view(torch.int16),
                       _torch(wb[0]).view(torch.int16))
    const = np.zeros((2, 64, 64), np.float32)
    assert tcodec.compress_stacked(_torch(const)) is None
    with pytest.raises(ValueError, match="incompressible or constant"):
        tcodec.tile_weights_for_fusion(_torch(const[0]))


@pytest.mark.parametrize("case", [((1000,), "bfloat16", 1),
                                  ((64, 300), "float16", 1),
                                  ((3, 50000), "float32", 4),
                                  ((128, 128), "bfloat16", 2)])
def test_abstract_compressed_matches_reference(case):
    shape, dtype, shards = case
    p = jcore.EnecParams(b=121, n=6, m=3, L=16, l=110)
    jct = jcore.abstract_compressed(shape, jnp.dtype(dtype), p,
                                    shards=shards)
    tp = tparams.EnecParams(b=121, n=6, m=3, L=16, l=110)
    tct = tcore.abstract_compressed(shape, getattr(torch, dtype), tp,
                                    shards=shards)
    for f in tct.streams._fields:
        t, j = getattr(tct.streams, f), getattr(jct.streams, f)
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(j.shape), f
        assert str(t.dtype).split(".")[-1] == str(j.dtype), f
    for f in ("fmt_name", "shape", "dtype_str", "block_elems", "shards",
              "mode"):
        assert getattr(tct, f) == getattr(jct, f), f


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_exponent_histogram_device_is_exact(dtype):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(70_001) * 0.03).astype(np.float32)
    x[::97] = 0.0
    x[::211] *= -1e4
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    xt = _torch(np.asarray(xj))
    fmt = tcore.format_for(xt.dtype)
    got = tcore.exponent_histogram_device(xt, fmt)
    assert got.dtype == torch.int64 and got.numel() == 1 << fmt.exp_bits
    bits = _np(xt)
    exp = (bits >> fmt.mant_bits) & fmt.exp_mask
    np.testing.assert_array_equal(
        got.numpy(), tparams.exponent_histogram(exp, fmt.exp_bits))
    jfmt = jcore.format_for(xj.dtype)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcore.exponent_histogram_device(xj, jfmt)))


def test_core_all_is_the_reference_minus_deprecated_wrappers():
    want = [n for n in jcore.__all__ if n != "DEPRECATED_WRAPPERS"
            and n not in jcore.DEPRECATED_WRAPPERS]
    assert tcore.__all__ == want
    for name in tcore.__all__:
        assert hasattr(tcore, name), name
    for name in ("compress_tree", "decompress_tree", "compress_stacked",
                 "tile_weights_for_fusion", "configure"):
        assert callable(getattr(tcore.Codec, name)), name


def test_configure_swaps_the_config():
    codec = tcore.Codec()
    plan = codec.plan_encode([torch.randn(5000).bfloat16()])
    cfg = tcore.CodecConfig(block_elems=2048)
    assert codec.configure(cfg) is codec and codec.config == cfg
    with pytest.raises(ValueError, match="different CodecConfig"):
        codec.execute(plan)
    ct = codec.compress_array(torch.randn(5000).bfloat16())
    assert ct.block_elems == 2048


def test_search_for_array_matches_reference(paper_sets):
    """examples/quickstart.py's first step on the port: the params
    searched on each host copy equal the reference's."""
    jtree, ttree = paper_sets
    for name, x in ttree.items():
        p = tcore.search_for_array(_np(x), tcore.format_for(x.dtype))
        jp = jcore.search_for_array(_jnp_bits(jtree[name]),
                                    jcore.format_for(jtree[name].dtype))
        assert dataclasses.astuple(p) == dataclasses.astuple(jp), name
