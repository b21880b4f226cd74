"""The batched inclusive prefix sum (``ops.idd_scan``): the port's plain
version against the JAX package's Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) on the same numpy inputs, exactly; the CUDA
kernel's two branches (one warp a row; the single-pass look-back scan
across CTAs) as lane-by-lane models, bitwise equal to ``torch.cumsum``
with sums that wrap and to the Pallas kernel; the host planner covering
every element once.

The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it bitwise
against ``torch.cumsum`` and the plain version there.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import idd_scan, ops
from repro_torch.kernels.idd_scan import LAUNCHES, idd_scan_cuda

# the shapes of tests/test_kernels.py::test_idd_scan_matches_cumsum
SHAPES = [(1, 128), (4, 1024), (2, 4096), (3, 2048)]


def _mask(shape, seed):
    return np.random.default_rng(seed).random(shape) < 0.3


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["int32", "bool"])
def test_plain_scan_equals_pallas_kernel(shape, dtype):
    x = _mask(shape, shape[1]).astype(dtype)
    want = np.asarray(jax_ops.idd_scan(jnp.asarray(x), use_pallas=True))
    got = idd_scan(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_scan_of_values_wraps_like_cumsum():
    """int32 values, not only bits: sums that pass 2**31 wrap as
    ``torch.cumsum``'s int32 sum does (the kernel's unsigned adds)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 256),
                                      dtype=np.int64).astype(np.int32))
    want = torch.cumsum(x, -1, dtype=torch.int32)
    assert torch.equal(ops.idd_scan(x), want)
    exact = np.cumsum(x.numpy().astype(np.int64), -1)
    assert np.array_equal(want.numpy(), exact.astype(np.int32))


@pytest.mark.parametrize("shape,dtype", [((2, 100), torch.int32),
                                         ((128,), torch.int32),
                                         ((2, 128), torch.int64),
                                         ((2, 128), torch.float32)])
def test_scan_rejects_what_the_reference_rejects(shape, dtype):
    with pytest.raises(ValueError):
        idd_scan(torch.zeros(shape, dtype=dtype))


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        idd_scan_cuda(torch.zeros((2, 128), dtype=torch.int32))
    assert LAUNCHES.n == 0


# ---- the CUDA kernel's two branches as models on the CPU -------------------

SCAN = importlib.import_module("repro_torch.kernels.idd_scan")
M32 = (1 << 32) - 1


def _i32(t64):
    """uint32 values held in int64 -> the int32 of the same bits."""
    return ((t64 + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def warp_run_model(vals, e):
    """One warp's scan of K chunks of 32 lanes x ``e`` neighbouring values
    (uint32 in int64): each lane sums its run, a scan of the lane totals
    a chunk, chunk totals carried in order.  -> (inclusive values, total)."""
    v = vals.reshape(-1, 32, e)
    lane_incl = torch.cumsum(v, -1) & M32
    lane_tot = lane_incl[..., -1]
    lane_off = (torch.cumsum(lane_tot, -1) - lane_tot) & M32
    chunk_tot = lane_tot.sum(-1) & M32
    chunk_off = (torch.cumsum(chunk_tot, 0) - chunk_tot) & M32
    out = (lane_incl + lane_off[..., None] + chunk_off[:, None, None]) & M32
    return out.reshape(-1), int(chunk_tot.sum()) & M32


def warp_rows_model(x):
    """The warp-rows branch: one warp a row in steps of STEP elements with
    a running carry."""
    e = 16 if x.dtype == torch.bool else 4
    xs = x.to(torch.int64) & M32
    out = torch.empty_like(xs)
    for r in range(xs.shape[0]):
        carry = 0
        for base in range(0, xs.shape[1], SCAN.STEP):
            chunk = xs[r, base:base + SCAN.STEP]
            pad = torch.zeros(SCAN.STEP, dtype=torch.int64)
            pad[:chunk.numel()] = chunk
            vals, total = warp_run_model(pad, e)
            out[r, base:base + chunk.numel()] = \
                (vals[:chunk.numel()] + carry) & M32
            carry = (carry + total) & M32
    return _i32(out)


def lookback_model(x, seed=0, resident=5):
    """The look-back branch: tiles of TILE (16 warp runs of WARP_RUN),
    each tile's aggregate published, then its exclusive prefix found by
    walking back over its row's status words (summing aggregates until an
    inclusive prefix), then its own inclusive prefix published.  Tiles are
    admitted in ticket order, at most ``resident`` at a time, and advance
    one step at a time in a seeded random order; a tile whose predecessor
    has published nothing waits, as the kernel spins."""
    e = 16 if x.dtype == torch.bool else 4
    rows, n = x.shape
    p = SCAN.Plan(rows, n, x.dtype == torch.bool, True)
    xs = x.to(torch.int64) & M32
    out = torch.empty_like(xs)
    rng = np.random.default_rng(seed)
    tiles = []
    for t in range(p.grid):
        row, k = divmod(t, p.tiles_per_row)
        seg = xs[row, k * SCAN.TILE:(k + 1) * SCAN.TILE]
        pad = torch.zeros(SCAN.TILE, dtype=torch.int64)
        pad[:seg.numel()] = seg
        runs = [warp_run_model(pad[w * SCAN.WARP_RUN:(w + 1) * SCAN.WARP_RUN],
                               e) for w in range(SCAN.TILE // SCAN.WARP_RUN)]
        tot = torch.tensor([total for _, total in runs])
        warp_off = (torch.cumsum(tot, 0) - tot) & M32
        vals = torch.cat([(v + int(o)) & M32
                          for (v, _), o in zip(runs, warp_off)])
        tiles.append(dict(row=row, k=k, len=seg.numel(), vals=vals,
                          agg=int(tot.sum()) & M32, step=0, excl=0,
                          pred=k - 1))
    status = {}                 # (row, k) -> ("A" | "P", value)
    waiting, active = list(range(p.grid)), []
    while waiting or active:
        while waiting and len(active) < resident:
            active.append(waiting.pop(0))          # the next ticket
        t = active[rng.integers(len(active))]
        st = tiles[t]
        key = (st["row"], st["k"])
        if st["step"] == 0:                        # publish the aggregate
            status[key] = ("P" if st["k"] == 0 else "A", st["agg"])
            st["step"] = 1 if st["k"] else 2
        elif st["step"] == 1:                      # one look-back step
            s = status.get((st["row"], st["pred"]))
            if s is not None:
                st["excl"] = (st["excl"] + s[1]) & M32
                st["pred"] -= 1
                if s[0] == "P" or st["pred"] < 0:
                    status[key] = ("P", (st["excl"] + st["agg"]) & M32)
                    st["step"] = 2
        else:                                      # store the tile
            base = st["k"] * SCAN.TILE
            out[st["row"], base:base + st["len"]] = \
                (st["vals"][:st["len"]] + st["excl"]) & M32
            active.remove(t)
    return _i32(out)


def _full_range(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -2**31, 2**31, shape, dtype=np.int64).astype(np.int32))


@pytest.mark.parametrize("shape", SHAPES + [(2, 3 * 8192 + 128),
                                            (1, 4 * 8192)])
@pytest.mark.parametrize("kind", ["values", "bool"])
def test_branch_models_bitwise_equal_to_cumsum(shape, kind):
    """Both branches, modelled lane by lane, on full-range values whose
    sums wrap mod 2**32 and on bool input: bitwise torch.cumsum."""
    x = (_full_range(shape, shape[1]) if kind == "values"
         else torch.from_numpy(_mask(shape, shape[1])))
    want = torch.cumsum(x.to(torch.int32), -1, dtype=torch.int32)
    assert torch.equal(warp_rows_model(x), want)
    for seed, resident in ((0, 1), (1, 3), (2, 64)):
        assert torch.equal(lookback_model(x, seed, resident), want), \
            (seed, resident)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["int32", "bool"])
def test_branch_models_equal_pallas_kernel(shape, dtype):
    x = _mask(shape, shape[1]).astype(dtype)
    want = np.asarray(jax_ops.idd_scan(jnp.asarray(x), use_pallas=True))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(warp_rows_model(xt).numpy(), want)
    np.testing.assert_array_equal(lookback_model(xt).numpy(), want)


def pieces(p):
    """What each CTA of plan ``p`` scans, as (cta, row, first element,
    end), as the kernel cuts it: a warp-rows CTA takes up to 8 whole rows
    (one a warp); a look-back CTA one tile of its row."""
    if p.lookback:
        for t in range(p.grid):
            row, k = divmod(t, p.tiles_per_row)
            yield t, row, k * SCAN.TILE, min(p.n, (k + 1) * SCAN.TILE)
    else:
        for row in range(p.rows):
            yield row // SCAN.ROW_WARPS, row, 0, p.n


@pytest.mark.parametrize("rows,n,is_bool,sms", [
    (16032, 1024, False, 132), (8, 1 << 20, False, 132),
    (1, 128, True, 132), (3, 2048, False, 132), (64, 4096, False, 132),
    (2, 3 * 8192 + 128, False, 132), (3, 3 * 8192 + 128, True, 132),
    (32 * 132, 8320, False, 132), (32 * 132 - 1, 8320, False, 132),
    (5, 8192, False, 1), (5, 8320, True, 1)])
def test_plan_covers_every_element_once(rows, n, is_bool, sms):
    p = SCAN.plan(rows, n, is_bool, sms)
    assert p.lookback == (n > SCAN.WARP_MAX_N
                          and rows < SCAN.ROWS_PER_SM * sms)
    if p.lookback:
        assert p.tiles_per_row == -(-n // SCAN.TILE)
        assert p.grid == rows * p.tiles_per_row
    else:
        assert p.grid == -(-rows // SCAN.ROW_WARPS)
    covered = np.zeros((min(rows, 40), n), dtype=np.int64)
    per_cta = {}
    for cta, row, first, end in pieces(p):
        assert 0 <= cta < p.grid and first < end <= n
        per_cta[cta] = per_cta.get(cta, 0) + 1
        if row < covered.shape[0]:
            covered[row, first:end] += 1
    assert (covered == 1).all()
    assert max(per_cta.values()) <= (1 if p.lookback else SCAN.ROW_WARPS)
    assert len(per_cta) == p.grid


def test_plan_spreads_long_rows_over_the_card():
    """(8, 2**20): the look-back branch on 1024 CTAs, not one a row."""
    p = SCAN.plan(8, 1 << 20, False, 132)
    assert p.lookback and p.grid == 8 * 128
