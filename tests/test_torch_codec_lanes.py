"""The lane designs of the ENEC codec kernels as models on the CPU.

Kernel 4 (``csrc/enec_encode.cu``) packs every stream without atomics: a
thread owns four lanes of a stream's last halving level and computes the
words of the levels above that feed them (element j + q * SUB of a level
at bit A * bitrev_F(q) of word j; the word's low byte out, its overflow
element j of the next level), values as pairs of 16-bit lanes; the high
stream gathers lane r * L + t from group ``grp_of_rank[r]``.  The model
below follows those steps (stores counted: every byte once) and is held
byte for byte against the JAX package's encoder.

Kernel 1 (``csrc/enec_decode.cu``) decodes a bf16 block by lane groups
(``enec_block.cuh: decode_staged_lanes_bf16``): the model checks that its
thread walk emits every element once in whole 128-element warp rows, that
the high stream's copied prefix (``high_extent``: count * L bytes below 8
bits a lane, not high_len / 8) holds every anomalous row's bytes, from no
anomalous group to all of them, and that the pair arithmetic with l taken
mod 512 gives the reference's bits for any l.

The host planner of both (``kernels/enec_decode.py: plan``,
``kernels/enec_encode.py: plan``) covers every block once under any grid
and takes the generic branch exactly where a lane precondition fails.  The
kernels run only on the card; ``chip_smoke.py`` holds them bitwise against
their plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitio as jax_bitio
from repro.core import codec as jax_codec
from repro.core.dtypes import FORMATS as JAX_FORMATS
from repro.core.params import EnecParams as JaxParams
from repro_torch.core import bitio, codec
from repro_torch.core.dtypes import FORMATS
from repro_torch.core.params import EnecParams
from repro_torch.kernels import enec_decode, enec_encode

THREADS = 512
LANES_N = 16384
NP_UINT = {"bf16": np.uint16, "fp16": np.uint16, "fp32": np.uint32}


def _folds(a: int) -> int:
    f = 0
    while a < 8:
        a, f = a << 1, f + 1
    return f


def _rev(q: int, bits: int) -> int:
    return int(format(q, f"0{bits}b")[::-1], 2) if bits else 0


def _pairs(v: np.ndarray, i: np.ndarray):
    """Elements i .. i + 3 of v as two pairs of 16-bit lanes."""
    v = v.astype(np.uint32)
    return v[i] | (v[i + 1] << 16), v[i + 2] | (v[i + 3] << 16)


def _low_bytes(lo, hi):
    """__byte_perm(lo, hi, 0x6420): the four lanes' low bytes."""
    return ((lo & 0xFF) | (((lo >> 16) & 0xFF) << 8) | ((hi & 0xFF) << 16)
            | (((hi >> 16) & 0xFF) << 24))


class _Out:
    """A stream under construction: its bytes and how often each was
    stored."""

    def __init__(self, nbytes: int):
        self.bytes = np.zeros(nbytes, np.uint8)
        self.writes = np.zeros(nbytes, np.int64)

    def store32(self, off: np.ndarray, word: np.ndarray):
        for k in range(4):
            self.bytes[off + k] = (word >> (8 * k)) & 0xFF
            np.add.at(self.writes, off + k, 1)


def _levels(out: _Out, a: int, length: int, base: int, get):
    """pack::levels: the thread quads of the last level, each computing
    the words above it that feed it."""
    f = _folds(a)
    w_bits, sub = a << f, length >> f

    def words(j):
        w0 = np.zeros(j.shape, np.uint32)
        w1 = np.zeros(j.shape, np.uint32)
        for q in range(1 << f):
            e0, e1 = get(j + q * sub)
            shift = a * _rev(q, f)
            w0 |= e0 << shift
            w1 |= e1 << shift
        out.store32(base + j, _low_bytes(w0, w1))
        return w0, w1

    if w_bits > 8:
        m2 = np.uint32(((1 << (w_bits - 8)) - 1) * 0x10001)
        _levels(out, w_bits - 8, sub, base + sub,
                lambda i: tuple((w >> 8) & m2 for w in words(i)))
    else:   # thread t owns quads j = 4 t, 4 t + 4 * THREADS, ..
        for t in range(min(THREADS, sub // 4)):
            words(np.arange(4 * t, sub, 4 * THREADS))


def pack_model(vals: np.ndarray, width: int) -> np.ndarray:
    """One stream of ``width`` bits over N lanes as the kernel writes it:
    byte planes straight, then the folded residue by lane-owned words."""
    n = vals.shape[0]
    out = _Out(bitio.packed_nbytes(n, width))
    planes, a = width >> 3, width & 7
    i = np.arange(0, n, 4)
    for k in range(planes):
        byte = (vals.astype(np.uint32) >> (8 * k)) & 0xFF
        out.store32(k * n + i, _low_bytes(*_pairs(byte, i)))
    if a:
        res = (vals.astype(np.uint32) >> (8 * planes)) & ((1 << a) - 1)
        _levels(out, a, n, planes * n, lambda j: _pairs(res, j))
    assert (out.writes == 1).all(), "a byte stored other than once"
    return out.bytes


@pytest.mark.parametrize("n", [2048, LANES_N])
@pytest.mark.parametrize("width", list(range(1, 10)) + [11, 24])
def test_lane_packer_matches_reference(n, width):
    rng = np.random.default_rng(width * 31 + n)
    vals = rng.integers(0, 1 << width, n).astype(np.uint32)
    want = np.asarray(jax_bitio.pack_fixed(vals[None], width, xp=np))[0]
    np.testing.assert_array_equal(pack_model(vals, width), want)


def _vsub2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lo = ((a & 0xFFFF) - (b & 0xFFFF)) & 0xFFFF
    hi = ((a >> 16) - (b >> 16)) & 0xFFFF
    return (lo | (hi << 16)).astype(np.uint32)


def encode_model(bits: np.ndarray, fmt_key: str, p: EnecParams,
                 b_vec: np.ndarray) -> dict:
    """Kernel 4 on (B, N) unsigned bit patterns, block by block: the work
    values u (y | raw residue << 9) and the raw byte planes; the group
    flags as ballot words; the ranks (WarpRank's words-and-prefix), the
    count, high_len and grp_of_rank; the low, high and raw streams."""
    fmt = FORMATS[fmt_key]
    nblocks, n = bits.shape
    lanes = enec_encode.lanes_ok(fmt, n, p)
    g_count, hw, big_l = n // p.L, p.n - p.m, p.L
    mod = (1 << p.n) - 1
    raw_bits = fmt.mant_bits + 1
    planes = raw_bits >> 3
    out = {k: [] for k in ("mask", "low", "high", "high_len", "raw")}
    for blk in range(nblocks):
        x = bits[blk].astype(np.uint32)
        b = int(b_vec[blk])
        i = np.arange(0, n, 4)
        raw = (x & ((1 << fmt.mant_bits) - 1)) | (
            ((x >> (fmt.total_bits - 1)) & 1) << fmt.mant_bits)
        if lanes:   # map4<true>: four elements as two pairs
            x0, x1 = _pairs(x, i)
            b2 = np.uint32((b & 0xFFFF) * 0x10001)
            mod2 = np.uint32(mod * 0x10001)
            y0 = _vsub2(np.full_like(x0, b2), (x0 >> 7) & 0x00FF00FF) & mod2
            y1 = _vsub2(np.full_like(x1, b2), (x1 >> 7) & 0x00FF00FF) & mod2
            u = np.zeros(n, np.uint32)
            for k, (y, sh) in enumerate(((y0, 0), (y0, 16), (y1, 0),
                                         (y1, 16))):
                u[i + k] = (y >> sh) & 0xFFFF
        else:       # map4<false>: element by element
            e = (x >> fmt.mant_bits) & ((1 << fmt.exp_bits) - 1)
            y = (b - e.astype(np.int64)) & mod
            u = (y | ((raw >> (8 * planes)) << 9)).astype(np.uint32)
        raw_out = _Out(bitio.packed_nbytes(n, raw_bits))
        for k in range(planes):
            byte = (raw >> (8 * k)) & 0xFF
            raw_out.store32(k * n + i, _low_bytes(*_pairs(byte, i)))
        if raw_bits & 7:
            ra = raw_bits & 7
            res = (u >> 9) & ((1 << ra) - 1)
            _levels(raw_out, ra, n, planes * n, lambda j: _pairs(res, j))
        # flags: OR of each group's y, one ballot word a warp of groups
        o = np.bitwise_or.reduce((u & 0x1FF).reshape(g_count, big_l), axis=1)
        flag = (o >> p.m) != 0
        nw = -(-g_count // 32)
        fpad = np.zeros(nw * 32, bool)
        fpad[:g_count] = flag
        words = (fpad.reshape(nw, 32).astype(np.uint64)
                 << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint64)
        popc = np.array([bin(int(w)).count("1") for w in words])
        before = np.cumsum(popc) - popc
        count = int(popc.sum())
        gor = np.full(g_count, -1)
        for g in np.nonzero(flag)[0]:
            w = int(words[g >> 5])
            r = int(before[g >> 5]) + bin(w & ((1 << (g & 31)) - 1)).count("1")
            gor[r] = g
        assert (gor[:count] >= 0).all() and (gor[count:] == -1).all()
        mask = np.array([(int(words[k >> 2]) >> (8 * (k & 3))) & 0xFF
                         for k in range(g_count // 8)], np.uint8)
        low_vals = u & ((1 << p.m) - 1)
        low = _Out(bitio.packed_nbytes(n, p.m))
        _stream(low, p.m, n, lambda j: _pairs(low_vals, j))
        high = _Out(bitio.packed_nbytes(n, hw))
        if hw:
            def gather(j):   # lane r * L + t <- element t of group gor[r]
                idx = j[:, None] + np.arange(4)[None, :]
                r = idx // big_l
                src = np.where(r < count, gor[np.minimum(r, g_count - 1)]
                               * big_l + idx % big_l, 0)
                v = np.where(r < count, (u[src] >> p.m) & ((1 << hw) - 1), 0)
                v = v.astype(np.uint32)
                return v[:, 0] | (v[:, 1] << 16), v[:, 2] | (v[:, 3] << 16)
            _stream(high, hw, n, gather)
        for s in (raw_out, low, high):
            assert (s.writes == 1).all(), "a byte stored other than once"
        out["mask"].append(mask)
        out["low"].append(low.bytes)
        out["high"].append(high.bytes)
        out["high_len"].append(count * big_l * hw)
        out["raw"].append(raw_out.bytes)
    return {k: np.stack(v) if k != "high_len" else np.array(v, np.int32)
            for k, v in out.items()}


def _stream(out: _Out, width: int, n: int, get):
    """pack::stream: one byte plane for width >= 8, then the residue."""
    planes, a = width >> 3, width & 7
    i = np.arange(0, n, 4)
    if planes:
        out.store32(i, _low_bytes(*get(i)))
    if a:
        m2 = np.uint32(((1 << a) - 1) * 0x10001)
        sh = 8 * planes
        _levels(out, a, n, planes * n,
                lambda j: tuple((e >> sh) & m2 for e in get(j)))


def _bits_for(fmt_key, p, n, nblocks, seed, frac=0.1, b_vec=None):
    """Random float bits whose exponents sit mostly in the low window of
    each block's b (y < 2**m) and, in a fraction of the groups, anywhere
    in the n-bit window; signs and mantissas random."""
    fmt = FORMATS[fmt_key]
    rng = np.random.default_rng(seed)
    g = n // p.L
    b_vec = np.full(nblocks, p.b) if b_vec is None else b_vec
    y = rng.integers(0, 1 << p.m, (nblocks, n))
    anom = np.repeat(rng.random((nblocks, g)) < frac, p.L, axis=1)
    y = np.where(anom, rng.integers(0, 1 << p.n, (nblocks, n)), y)
    e = (b_vec[:, None] - y) % (1 << p.n) % (1 << fmt.exp_bits)
    rest = rng.integers(0, 1 << 32, (nblocks, n), dtype=np.int64)
    sign_mant = rest & ((1 << fmt.mant_bits) - 1)
    sign = (rest >> 31) & 1
    return ((sign << (fmt.total_bits - 1)) | (e << fmt.mant_bits)
            | sign_mant).astype(np.uint64)


# (format, N, (b, n, m, L, l), fraction of anomalous groups): low widths
# m = 1..9, high widths 0..8, the raw widths 8 / 11 / 24, both branches
ENCODE_CASES = [
    ("bf16", LANES_N, (127, 4, 1, 16, 112), 0.1),
    ("bf16", LANES_N, (127, 7, 2, 64, 0), 0.3),
    ("bf16", LANES_N, (125, 6, 3, 16, 62), 0.05),
    ("bf16", LANES_N, (130, 8, 4, 32, 0), 0.2),
    ("bf16", LANES_N, (127, 6, 5, 128, 64), 0.5),
    ("bf16", LANES_N, (200, 9, 7, 16, 0), 0.1),
    ("bf16", LANES_N, (127, 9, 8, 16, 0), 0.1),
    ("bf16", LANES_N, (127, 9, 9, 2048, 0), 0.0),
    ("bf16", LANES_N, (127, 6, 6, 16, 64), 0.0),        # m == n
    ("bf16", LANES_N, (127, 4, 2, 16, 120), 1.0),       # every group
    ("bf16", LANES_N, (127, 4, 2, 16, 120), 0.0),       # no group
    ("bf16", 2048, (127, 6, 3, 16, 62), 0.2),           # generic: N
    ("bf16", LANES_N, (127, 6, 3, 4, 62), 0.2),         # generic: L < 16
    ("bf16", 2048, (127, 5, 2, 2, 0), 0.2),             # generic: L < 4
    ("bf16", 2048, (127, 5, 2, 1, 0), 0.3),
    ("fp16", 2048, (15, 5, 3, 16, 0), 0.2),             # raw 11 bits
    ("fp16", LANES_N, (15, 6, 6, 32, 0), 0.0),
    ("fp32", 2048, (127, 7, 4, 32, 0), 0.2),            # raw 24 bits
    ("fp32", LANES_N, (127, 9, 5, 128, 0), 0.1),
]


@pytest.mark.parametrize("fmt_key,n,pt,frac", ENCODE_CASES)
def test_encode_model_matches_reference(fmt_key, n, pt, frac):
    b, nn, m, big_l, l = pt
    p = EnecParams(b=b, n=nn, m=m, L=big_l, l=l)
    bits = _bits_for(fmt_key, p, n, 2, seed=nn * 131 + m * 7 + big_l,
                     frac=frac)
    got = encode_model(bits, fmt_key, p, np.full(2, b))
    jp = JaxParams(b=b, n=nn, m=m, L=big_l, l=l)
    ref = jax_codec.encode_blocks(jnp.asarray(bits.astype(NP_UINT[fmt_key])),
                                  JAX_FORMATS[fmt_key], jp)
    for name in ("mask", "low", "high", "high_len", "raw"):
        np.testing.assert_array_equal(got[name], np.asarray(
            getattr(ref, name)), err_msg=name)
    if frac in (0.0, 1.0):
        assert (got["high_len"] == (0 if frac == 0.0 else
                                    n * (nn - m))).all()


def test_encode_model_per_block_b_across_the_wrap():
    """Two blocks with their own b, exponents on both sides of b, so
    (b - e) mod 2**n wraps in both branches' arithmetic."""
    p = EnecParams(b=3, n=5, m=2, L=16, l=0)
    b_vec = np.array([3, 29])
    bits = _bits_for("bf16", p, LANES_N, 2, seed=5, frac=0.3, b_vec=b_vec)
    e = (bits >> 7) & 0xFF
    assert (e > b_vec[:, None]).any() and (e <= b_vec[:, None]).any()
    got = encode_model(bits, "bf16", p, b_vec)
    ref = jax_codec.encode_blocks(
        jnp.asarray(bits.astype(np.uint16)), JAX_FORMATS["bf16"],
        JaxParams(b=3, n=5, m=2, L=16, l=0),
        b_vec=jnp.asarray(b_vec, jnp.int32))
    for name in ("mask", "low", "high", "high_len", "raw"):
        np.testing.assert_array_equal(got[name], np.asarray(
            getattr(ref, name)), err_msg=name)


# ---------------------------------------------------------------------------
# kernel 1: the lane branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", range(1, 10))
def test_lane_walk_emits_every_element_once_in_warp_rows(m):
    """decode_bf16's walk at 512 threads: thread t takes lanes j0 = 4 t,
    4 t + 2048, .. of the folded level and emits elements j0 + q * SUB ..
    + 3 for every q; each element once, and each warp's 32 quads of one
    (step, q) one contiguous 128-element row (whole 256-byte stores)."""
    f = _folds(m) if m < 8 else 0
    sub = LANES_N >> f
    hits = np.zeros(LANES_N, np.int64)
    for warp in range(THREADS // 32):
        for step in range(-(-sub // (4 * THREADS))):
            for q in range(1 << f):
                i0 = [4 * (32 * warp + lane) + step * 4 * THREADS + q * sub
                      for lane in range(32)
                      if 4 * (32 * warp + lane) + step * 4 * THREADS < sub]
                if not i0:
                    continue
                assert i0 == list(range(i0[0], i0[0] + 4 * len(i0), 4))
                assert len(i0) == 32 and i0[0] % 128 == 0
                for s in i0:
                    hits[s:s + 4] += 1
    assert (hits == 1).all()


def _extent(c, hw, n, w_high):
    """enec_block.cuh: high_extent."""
    if c <= 0 or hw == 0:
        return 0
    if hw % 8 == 0:
        return (hw // 8 - 1) * n + c
    w, sub = hw, n
    while w < 8 and sub > 1:
        w, sub = w * 2, sub // 2
    return c if c <= sub else w_high


@pytest.mark.parametrize("n", [2048, LANES_N])
@pytest.mark.parametrize("frac", [0.0, 0.02, 0.3, 1.0])
def test_high_extent_holds_every_anomalous_row(n, frac):
    """For every high width: the copied prefix holds every byte that a
    piece of the first count * L lanes occupies (piece_map), and the plain
    decoder reading a stream whose bytes past the prefix are garbage gives
    the clean stream's bits; no anomalous group (high_len 0, nothing
    copied) and every group anomalous (the whole stream) included."""
    fmt = FORMATS["bf16"]
    for m, nn in ((1, 2), (1, 4), (2, 5), (3, 6), (2, 6), (1, 6), (3, 9),
                  (1, 9), (4, 9), (5, 6), (6, 7)):
        p = EnecParams(b=127, n=nn, m=m, L=16, l=127 - (1 << nn) + 1)
        bits = _bits_for("bf16", p, n, 2, seed=nn * 10 + m, frac=frac)
        t_bits = torch.from_numpy(bits.astype(np.int64)).to(torch.int32)
        s = codec.encode_blocks(t_bits, fmt, p)
        hw, w_high = nn - m, codec.stream_shapes(n, fmt, p)["high"]
        clean = codec.decode_blocks(s, n, fmt, p)
        garbled = s.high.clone()
        offs, _, nbits, _ = bitio.piece_map(hw, n)
        for blk in range(2):
            c = int(s.high_len[blk]) // hw
            ext = _extent(c, hw, n, w_high)
            if frac == 0.0:
                assert c == 0 and ext == 0
            if frac == 1.0:
                assert c == n
            used = offs[:, :c][nbits[:, :c] > 0]
            assert used.size == 0 or used.max() < ext, (m, nn, c, ext)
            noise = np.random.default_rng(blk).integers(
                0, 256, w_high - ext).astype(np.uint8)
            garbled[blk, ext:] = torch.from_numpy(noise)
        got = codec.decode_blocks(s._replace(high=garbled), n, fmt, p)
        assert torch.equal(got, clean)


@pytest.mark.parametrize("l", [0, 112, 255, 300, 65023, 65200, -384])
def test_pair_exponent_with_l_mod_512(l):
    """emit_lanes' arithmetic on pairs of 16-bit lanes, l taken mod 512:
    e = l2 + ((c + mod + 1 - y) & mod) never borrows or carries across the
    lanes, and sign | e << 7 | mantissa masked to 16 bits gives the
    reference's bits for any l (the old precondition 0 <= l < 2**16 - 512
    is gone)."""
    rng = np.random.default_rng(l & 0xFFFF)
    for nn in (1, 4, 8, 9):
        mod = (1 << nn) - 1
        b = l + int(rng.integers(0, 1 << nn))
        y = rng.integers(0, 1 << nn, 4096).astype(np.uint32)
        raw = rng.integers(0, 256, 4096).astype(np.uint32)
        want_e = (l + ((b - l - y.astype(np.int64)) & mod)) & 0xFFFF
        want = (((raw >> 7) & 1) << 15) | ((want_e << 7) & 0xFFFF) | (
            raw & 0x7F)
        want &= 0xFFFF
        i = np.arange(0, 4096, 4)
        cb2 = np.uint32((((b - l) & mod) + mod + 1) * 0x10001)
        l2 = np.uint32((l & 511) * 0x10001)
        got = np.zeros(4096, np.uint32)
        for k, (yp, rp) in enumerate(zip(_pairs(y, i), _pairs(raw, i))):
            e = (l2 + ((cb2 - yp) & np.uint32(mod * 0x10001))) & 0xFFFFFFFF
            bits = (((rp & 0x00800080) << 8) | ((e << 7) & 0xFF80FF80)
                    | (rp & 0x007F007F)) & 0xFFFFFFFF
            got[i + 2 * k] = bits & 0xFFFF
            got[i + 2 * k + 1] = bits >> 16
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the host planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [enec_decode, enec_encode])
@pytest.mark.parametrize("nblocks", [1, 5, 131, 16032, 75424])
def test_plan_covers_every_block_once(mod, nblocks):
    """One CTA per resident slot (never more than blocks); under that grid
    and grids 1, 3, SMs and 2 x SMs, CTA c's walk c, c + grid, .. takes
    every block once."""
    fmt, p = FORMATS["bf16"], EnecParams(b=127, n=6, m=3, L=16, l=64)
    sms = 132
    pl = mod.plan(nblocks, fmt, LANES_N, p, sms, 2)
    assert pl.lanes and pl.grid == min(nblocks, 2 * sms)
    for grid in (pl.grid, 1, 3, sms, 2 * sms):
        g = min(grid, nblocks)
        q = mod.Plan(nblocks, pl.lanes, g)
        seen = np.zeros(nblocks, np.int64)
        for cta in range(g):
            blocks = list(q.blocks(cta))
            assert blocks == sorted(blocks)
            np.add.at(seen, blocks, 1)
        assert (seen == 1).all()


def test_plan_takes_generic_exactly_where_a_lane_precondition_fails():
    """Lanes: bf16 (16-bit pairs), 16384-element blocks (the unrolled
    template), L a power of two with N / L in 8..1024 groups (WarpRank's 32
    words) and L % 4 == 0 (a thread's four elements in one group), n <= 9
    (A + HW <= 9, y in 9 bits)."""
    def expect(fmt_key, n_elems, big_l, nn):
        g = n_elems // big_l
        return (fmt_key == "bf16" and n_elems == LANES_N
                and big_l & (big_l - 1) == 0 and big_l % 4 == 0
                and 8 <= g <= 1024 and nn <= 9)
    for fmt_key in ("bf16", "fp16", "fp32"):
        for n_elems in (2048, 8192, LANES_N):
            for big_l in (1, 2, 4, 8, 16, 32, 64, 128, 1024, 2048):
                if n_elems % big_l or (n_elems // big_l) % 8:
                    continue
                for nn, m in ((4, 2), (9, 3), (9, 9), (10, 3)):
                    p = EnecParams(b=127, n=nn, m=m, L=big_l, l=0)
                    want = expect(fmt_key, n_elems, big_l, nn)
                    for mod in (enec_decode, enec_encode):
                        pl = mod.plan(100, FORMATS[fmt_key], n_elems, p,
                                      132, 2)
                        assert pl.lanes == want, (fmt_key, n_elems, big_l,
                                                  nn)
