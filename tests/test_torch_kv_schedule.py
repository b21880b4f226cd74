"""The schedule of the compressed-KV attention kernel
(``csrc/decode_attention_kv.cu``) as a model on the CPU: flash-decoding
split-KV (the (pair, chunk) items cut into contiguous ranges, one a CTA;
each CTA runs the online softmax over its range, one per warp over tokens
w, w + 16, .. of every chunk as its 16 warps do, combined at the end of a
pair's segment, and stores a partial (m, l, acc) wherever its range holds
only part of a pair) and the ordered combine of a split pair's partials
(m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m), o =
acc / max(l, 1e-30)), under several partitions of the chunks, held
against the JAX package's Pallas kernel in interpret mode and against the
port's plain version on the same numpy inputs; the host planner covers
every (pair, chunk) once and sizes the workspace by its formula.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there under the planner's grid and others.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BF16 as JAX_BF16
from repro.core import search_for_array as jax_search_for_array
from repro.core.params import EnecParams as JaxEnecParams
from repro.kernels.decode_attention_kv import \
    compress_kv_prefix as jax_compress_kv_prefix
from repro.kernels.decode_attention_kv import \
    decode_attention_kv_enec as jax_decode_attention_kv_enec
from repro_torch.core import codec
from repro_torch.core.dtypes import BF16
from repro_torch.core.params import EnecParams
from repro_torch.kernels import compress_kv_prefix
from repro_torch.kernels.decode_attention_kv import (
    HD, TOK, Plan, decode_attention_kv_plain, plan)

# the tolerance of tests/test_decode_attention_kv.py: f32 sums of the same
# products in another order, through exp and one division
ATOL, RTOL = 2e-5, 1e-4
# (B, S, KV, grp): tests/test_torch_kv_attention.py's SHAPES; m_equals_n
CASES = [((1, 128, 1, 1), False), ((2, 256, 2, 4), False),
         ((1, 512, 4, 8), False), ((2, 256, 2, 4), True)]


def _bf16(rng, shape, scale=0.3):
    return np.asarray(jnp.asarray(
        rng.standard_normal(shape).astype("float32") * scale
    ).astype(jnp.bfloat16))


def _torch(a):
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _case(shape, m_equals_n):
    """q, k, v (numpy bf16, made as the reference test makes them), the
    reference's params (searched over K and V, or m == n over their
    exponents), and the Pallas kernel's output in interpret mode."""
    b, s, kv, grp = shape
    rng = np.random.default_rng(s + grp)
    k, v = _bf16(rng, (b, s, kv, HD)), _bf16(rng, (b, s, kv, HD))
    q = _bf16(rng, (b, kv, grp, HD))
    both = np.concatenate([k.ravel(), v.ravel()])
    if m_equals_n:
        exp = (both.view(np.uint16) >> 7) & 0xFF
        lo, hi = int(exp.min()), int(exp.max())
        width = (hi - lo).bit_length() + 1
        p = JaxEnecParams(b=hi, n=width, m=width, L=16, l=lo)
    else:
        p = jax_search_for_array(both, JAX_BF16, block_elems=TOK * HD)
    ks = jax_compress_kv_prefix(jnp.asarray(k), p)
    vs = jax_compress_kv_prefix(jnp.asarray(v), p)
    want = np.asarray(jax_decode_attention_kv_enec(jnp.asarray(q), ks, vs, p))
    return q, k, v, EnecParams(b=p.b, n=p.n, m=p.m, L=p.L, l=p.l), want


def split_kv_model(q, ks, vs, p, grid, warps=16):
    """The kernel's schedule on the CPU: q (B, KV, grp, 128) bf16 over the
    streams of ``compress_kv_prefix``, on ``grid`` CTAs.  Inside a CTA warp
    w of ``warps`` keeps its own online softmax over tokens w, w + warps,
    .. of every chunk of the segment; at the segment's end the warps' (m, l,
    acc) are combined in warp order into the CTA's.  CTAs finish in any
    order (a seeded permutation); a split pair is combined when its last
    CTA arrives, in chunk order whoever arrives last."""
    b, n_kv, grp, hd = q.shape
    n_chunks = ks.mask.shape[2]
    pl = Plan(b * n_kv, n_chunks, grp, grid)

    def tiles(streams):
        bits = codec.decode_blocks(codec.flatten_blocks(streams),
                                   TOK * HD, BF16, p)
        return bits.view(torch.bfloat16).float().reshape(-1, TOK, hd)

    kt, vt = tiles(ks), tiles(vs)          # (items, tok, hd): block = item
    qf = q.float().reshape(b * n_kv, grp, hd)
    scale = 1.0 / math.sqrt(hd)
    out = torch.full((pl.pairs, grp, hd), float("nan"))
    slots = {}                              # (cta, pair) -> (m, l, acc)
    arrivals = [0] * pl.pairs

    def combine(parts):
        m = torch.stack([pm for pm, _, _ in parts]).amax(dim=0)
        l_sum, acc = None, None
        for pm, pl_, pa in parts:
            w = torch.exp(pm - m)
            l_sum = pl_ * w if l_sum is None else l_sum + pl_ * w
            acc = pa * w if acc is None else acc + pa * w
        return m, l_sum, acc

    for c in np.random.default_rng(grid).permutation(pl.grid):
        begin, end = pl.range(int(c))
        item = begin
        while item < end:
            pair = item // n_chunks
            seg_end = min(end, (pair + 1) * n_chunks)
            tile_state = []
            for w in range(warps):
                toks = slice(w, TOK, warps)
                m = torch.full((grp, 1), -1e30)
                l_run = torch.zeros((grp, 1))
                acc = torch.zeros((grp, hd))
                for it in range(item, seg_end):
                    scores = qf[pair] @ kt[it, toks].T * scale
                    m_new = torch.maximum(m, scores.amax(dim=-1,
                                                         keepdim=True))
                    prob = torch.exp(scores - m_new)
                    corr = torch.exp(m - m_new)
                    l_run = l_run * corr + prob.sum(dim=-1, keepdim=True)
                    acc = acc * corr + prob @ vt[it, toks]
                    m = m_new
                tile_state.append((m, l_run, acc))
            m, l_run, acc = (tile_state[0] if warps == 1
                             else combine(tile_state))
            if item % n_chunks == 0 and seg_end == (pair + 1) * n_chunks:
                out[pair] = acc / torch.clamp(l_run, min=1e-30)
            else:
                slots[(int(c), pair)] = (m, l_run, acc)
                arrivals[pair] += 1
                if arrivals[pair] == len(pl.contributors(pair)):
                    _, l_sum, acc = combine([slots[(k, pair)] for k in
                                             pl.contributors(pair)])
                    out[pair] = acc / torch.clamp(l_sum, min=1e-30)
            item = seg_end
    return out.reshape(b, n_kv, grp, hd)


def _grids(items):
    return sorted({g for g in (1, 2, 3, 5, 7, items // 2, items)
                   if 1 <= g <= items})


@pytest.mark.parametrize("shape,m_equals_n", CASES)
def test_split_kv_model_matches_reference_and_plain(shape, m_equals_n):
    q, k, v, p, want = _case(shape, m_equals_n)
    ks, vs = compress_kv_prefix(_torch(k), p), compress_kv_prefix(
        _torch(v), p)
    qt = _torch(q)
    plain = decode_attention_kv_plain(qt, ks, vs, p)
    np.testing.assert_allclose(plain.numpy(), want, atol=ATOL, rtol=RTOL)
    b, s, kv, grp = shape
    for grid in _grids(b * kv * (s // TOK)):
        got = split_kv_model(qt, ks, vs, p, grid)
        assert bool(torch.isfinite(got).all()), f"grid {grid}"
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"grid {grid}")
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=f"grid {grid}")


def test_model_with_one_warp_at_one_cta_a_pair_is_plain_bitwise():
    """With one warp over all 128 tokens and one CTA a pair (grid ==
    pairs) nothing is combined, and the model is the plain version's chunk
    loop: the same bits."""
    q, k, v, p, _ = _case((1, 512, 4, 8), False)
    ks, vs = compress_kv_prefix(_torch(k), p), compress_kv_prefix(
        _torch(v), p)
    qt = _torch(q)
    got = split_kv_model(qt, ks, vs, p, grid=4, warps=1)
    want = decode_attention_kv_plain(qt, ks, vs, p)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("pairs,n_chunks,grp,sms,per_sm", [
    (64, 256, 3, 132, 1),      # the full-width shapes: ranges cut pairs
    (64, 256, 8, 132, 2),
    (1, 1, 1, 132, 1),         # one single-chunk pair
    (4, 2, 4, 3, 1),           # ranges spanning two pairs
    (4, 4, 8, 7, 1),
    (3, 5, 2, 132, 1),         # fewer items than CTAs: one item a CTA
    (10, 1, 16, 4, 1),         # single-chunk pairs, several a CTA
    (7, 9, 3, 2, 2),
])
def test_plan_covers_every_pair_chunk_once(pairs, n_chunks, grp, sms,
                                           per_sm):
    pl = plan(pairs, n_chunks, grp, sms, per_sm)
    items = pairs * n_chunks
    assert pl.grid == min(items, sms * per_sm) and pl.items == items
    assert pl.ws_floats == 2 * pl.grid * grp * (HD + 2)
    assert pl.ws_bytes == 4 * pl.ws_floats
    seen = {}
    partial_pairs = {}
    for c, (begin, end) in enumerate(pl.ranges()):
        assert begin < end, f"CTA {c} has no item"
        for item in range(begin, end):
            seen[divmod(item, n_chunks)] = seen.get(
                divmod(item, n_chunks), 0) + 1
            assert pl.cta_of(item) == c
        first, last = begin // n_chunks, (end - 1) // n_chunks
        # pairs this CTA holds only part of: at most its first and its last
        partial = [pr for pr in range(first, last + 1)
                   if begin > pr * n_chunks or end < (pr + 1) * n_chunks]
        assert set(partial) <= {first, last}
        partial_pairs[c] = partial
    assert set(seen.values()) == {1}
    assert len(seen) == items
    for pr in range(pairs):
        ctas = pl.contributors(pr)
        held = [c for c, (a, e) in enumerate(pl.ranges())
                if a < (pr + 1) * n_chunks and e > pr * n_chunks]
        assert list(ctas) == held
        assert (len(ctas) > 1) == any(pr in partial_pairs[c] for c in ctas)


def test_plan_at_full_width_fills_the_card():
    """B 8 x KV 8 pairs of 256 chunks on 132 SMs: at least one CTA an SM,
    and ranges that cut pairs mid-way."""
    for per_sm in (1, 2):
        pl = plan(64, 256, 3, 132, per_sm)
        assert pl.grid == 132 * per_sm
        assert any(a % 256 for a, _ in pl.ranges())
        assert max(len(pl.contributors(pr)) for pr in range(64)) >= 2
