"""The schedule of the matmul kernel (``csrc/decompress_matmul.cu``) as a
model on the CPU: ordered split-K (one f32 partial per 128x128 tile, any
partition of the tiles among CTAs, each strip summed in k order) and the
serial k walk give exactly the bits of the plain canonical contraction
``kernels/ref.py:tiled_matmul_ref``; the host planner picks the branch
and sizes the workspace by its formula, and the kernel's walks (CTA c of
a grid of g takes tiles c, c + g, ...; a serial CTA one strip's k tiles
for a block of rows) cover every tile once.  The breakdown tool's edited
copies of the kernel source (and of the compressed-KV attention
kernel's) still apply.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there, bitwise across its two branches and M.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.codec_api import Codec as JaxCodec
from repro.core.api import slice_stacked as jax_slice
from repro.kernels.decompress_matmul import decompress_matmul as jax_fused
from repro_torch.kernels.decompress_matmul import SPLIT_MAX_M, TILE, plan
from repro_torch.launch import kv_attention_breakdown, matmul_breakdown
from repro_torch.kernels.ref import tile_product, tiled_matmul_ref


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


# f32 sums of the same products in another order (K <= 512 here)
MATMUL_RTOL, MATMUL_ATOL = 1e-5, 1e-5
ROWS = 32    # x rows of a serial CTA (any block gives the same bits)


def split_walk(p, cta, grid):
    """The tiles CTA ``cta`` of a split-K grid walks, in order: tile t is
    (n_tile, k_tile) = divmod(t, k_tiles)."""
    return range(cta, p.tiles, grid)


def serial_walks(p, rows=ROWS):
    """Each serial CTA's (tiles, row0, rows): one strip's k tiles in order
    for a block of ``rows`` x rows."""
    for row0 in range(0, p.m, rows):
        for strip in range(p.n_tiles):
            yield (range(strip * p.k_tiles, (strip + 1) * p.k_tiles), row0,
                   min(rows, p.m - row0))


def _bf16(a):
    return np.asarray(jnp.asarray(np.asarray(a, np.float32)).astype(
        jnp.bfloat16))


def _torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _padded(x, w):
    """x and w zero-padded to whole tiles, as the kernel stages them."""
    (m, k), n = x.shape, w.shape[1]
    kp, np_ = -(-k // TILE) * TILE, -(-n // TILE) * TILE
    return (F.pad(x.float(), (0, kp - k)),
            F.pad(w.float(), (0, np_ - n, 0, kp - k)).contiguous())


def _partial(xf, wf, p, t, row0, rows):
    n_tile, kt = divmod(t, p.k_tiles)
    ks, ns = slice(kt * TILE, (kt + 1) * TILE), \
        slice(n_tile * TILE, (n_tile + 1) * TILE)
    return tile_product(xf[row0:row0 + rows, ks], wf[ks, ns])


def split_k_model(x, w, grid):
    """Ordered split-K (at any M): CTA c walks its tiles (``split_walk``)
    writing one partial per tile into the workspace; the last arrival of a
    strip sums its partials p0 + p1 + ... in k order."""
    p = dataclasses.replace(plan(x.shape[0], *w.shape), split=True)
    assert p.split
    xf, wf = _padded(x, w)
    ws = torch.full((p.tiles, p.m, TILE), float("nan"))
    arrivals = [0] * p.n_tiles
    out = torch.full((p.m, p.n_tiles * TILE), float("nan"))
    # CTAs finish their tiles in any order: interleave them at random
    order = [t for c in range(grid) for t in split_walk(p, c, grid)]
    for i in np.random.default_rng(grid).permutation(len(order)):
        t = order[i]
        ws[t] = _partial(xf, wf, p, t, 0, p.m)
        strip = t // p.k_tiles
        arrivals[strip] += 1
        if arrivals[strip] == p.k_tiles:
            base = strip * p.k_tiles
            acc = ws[base]
            for kt in range(1, p.k_tiles):
                acc = acc + ws[base + kt]
            out[:, strip * TILE:(strip + 1) * TILE] = acc
    return out[:, :w.shape[1]]


def serial_model(x, w):
    """The serial walk: one CTA per (strip, ROWS rows), k in order,
    acc = p0; acc = acc + p1; ..."""
    p = dataclasses.replace(plan(x.shape[0], *w.shape), split=False)
    xf, wf = _padded(x, w)
    out = torch.full((p.m, p.n_tiles * TILE), float("nan"))
    for tiles, row0, rows in serial_walks(p):
        acc = None
        for t in tiles:
            part = _partial(xf, wf, p, t, row0, rows)
            acc = part if acc is None else acc + part
        strip = tiles[0] // p.k_tiles
        out[row0:row0 + rows, strip * TILE:(strip + 1) * TILE] = acc
    return out[:, :w.shape[1]]


def _case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((m, k)))
    w = _bf16(rng.standard_normal((k, n)) / np.sqrt(k))
    return x, w


@pytest.mark.parametrize("m,k,n,grids", [
    (4, 250, 120, (1, 2, 5)),
    (3, 384, 256, (1, 2, 4, 5, 6, 7)),
    (4, 8192, 2048, (1, 7, 132, 264, 1024)),
    (16, 512, 640, (3, 20, 264)),
    (40, 384, 256, (1, 5, 264)),
])
def test_ordered_split_k_bitwise_equal_to_plain(m, k, n, grids):
    x, w = _case(m, k, n, seed=m + k + n)
    want = tiled_matmul_ref(_torch(x), _torch(w))
    for grid in grids:
        got = split_k_model(_torch(x), _torch(w), grid)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            f"grid {grid}"


@pytest.mark.parametrize("m,k,n", [(40, 250, 120), (70, 384, 256)])
def test_serial_walk_bitwise_equal_to_plain(m, k, n):
    x, w = _case(m, k, n, seed=m * k)
    want = tiled_matmul_ref(_torch(x), _torch(w))
    got = serial_model(_torch(x), _torch(w))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("m,k,n", [(4, 250, 120), (8, 256, 384)])
def test_split_k_model_against_pallas_kernel(m, k, n):
    """The model within tolerance of the JAX fused kernel (interpret mode)
    on the same numpy inputs."""
    x, w = _case(m, k, n, seed=k + n)
    [jct] = JaxCodec().tile_weights_for_fusion_many([jnp.asarray(w)])
    want = np.asarray(jax_fused(jnp.asarray(x), jax_slice(jct, 0), k, n,
                                interpret=True))
    got = split_k_model(_torch(x), _torch(w), grid=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=MATMUL_RTOL,
                               atol=MATMUL_ATOL)


@pytest.mark.parametrize("m,k,n", [(1, 2048, 2048), (4, 8192, 2048),
                                   (16, 3072, 9216), (4, 250, 120),
                                   (17, 2048, 512), (256, 2048, 8192),
                                   (257, 250, 120), (300, 9216, 3072)])
def test_plan_covers_every_tile_once(m, k, n):
    p = plan(m, k, n)
    assert p.split == (m <= SPLIT_MAX_M)
    assert (p.k_tiles, p.n_tiles) == (-(-k // TILE), -(-n // TILE))
    if p.split:
        assert p.ws_floats == p.k_tiles * p.n_tiles * m * TILE
        # a grid of (SM count x resident CTAs), capped at the tile count
        walks = [[(split_walk(p, c, g), 0, m) for c in range(g)]
                 for g in {min(p.tiles, s * r)
                           for s, r in ((132, 2), (132, 1), (7, 3), (1, 1))}]
    else:
        assert p.ws_floats == 0
        walks = [list(serial_walks(p))]
    for walk in walks:
        seen = {}
        for tiles, row0, rows in walk:
            assert rows > 0 and list(tiles)
            if not p.split:   # the serial walk: one strip, k in order
                assert len({t // p.k_tiles for t in tiles}) == 1
                assert [t % p.k_tiles for t in tiles] == \
                    list(range(p.k_tiles))
            for t in tiles:
                for r in range(row0, row0 + rows):
                    seen[(t, r)] = seen.get((t, r), 0) + 1
        assert set(seen.values()) == {1}
        assert len(seen) == p.tiles * m


@pytest.mark.parametrize("name", sorted(matmul_breakdown.ABLATIONS)
                         + ["timeline"])
def test_breakdown_variants_apply_to_kernel_source(name):
    """Every edit the breakdown tool makes to the kernel source still finds
    its line, so a kernel change that breaks one fails here, not on the
    card."""
    subs = (matmul_breakdown._TIMELINE if name == "timeline"
            else matmul_breakdown.ABLATIONS[name])
    src = matmul_breakdown._variant(name, subs)
    assert all(new in src for _, new in subs)


@pytest.mark.parametrize("name", sorted(kv_attention_breakdown.ABLATIONS)
                         + ["timeline"])
def test_kv_breakdown_variants_apply_to_kernel_source(name):
    """The same for the compressed-KV attention kernel's breakdown
    (``launch/kv_attention_breakdown.py``): every edit still finds its line
    in ``csrc/decode_attention_kv.cu``."""
    subs = (kv_attention_breakdown._TIMELINE if name == "timeline"
            else kv_attention_breakdown.ABLATIONS[name])
    src = kv_attention_breakdown.variant_source(name)
    assert all(new in src for _, new in subs)
