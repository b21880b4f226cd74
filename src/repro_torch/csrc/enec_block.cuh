// Device code shared by the ENEC decoder (enec_decode.cu), the fused
// decode+matmul (decompress_matmul.cu) and the compressed-KV attention
// (decode_attention_kv.cu): the closed-form unpack of one element from a
// halving-packed stream, stream staging into shared memory, and the decode
// of one block with its exclusive anomaly rank (element by element, or by
// lane groups of a folded level).
//
// The stream layout is the reference's (src/repro/core/bitio.py): byte
// planes first, then the sub-byte residue folded lane i with lane i+len/2
// until the width crosses 8 bits, low byte emitted, overflow recursing.
// unpack_elem follows repro_torch/core/bitio.py:piece_map step for step:
// after F folds of a level with len = N >> F lanes, element i sits in lane
// j = i % len at bit a * bitrev_F(i / len); the bits below 8 are in byte
// base + j, the rest are bits of element j of the next level.
#pragma once
#include <cuda_fp16.h>
#include <cstdint>

#include "idd_scan.cuh"

namespace enec {

constexpr int kThreads = 512;

struct Params {
  int n_elems;     // elements per block (a power of two)
  int L;           // group length
  int n, m;        // base width and threshold width
  int total_bits;  // 16 or 32
  int mant_bits;   // 7 (bf16), 10 (fp16), 23 (fp32)
  int w_mask, w_low, w_high, w_raw;   // stream bytes per block
};

__device__ __forceinline__ unsigned bitrev(unsigned q, int bits) {
  return bits ? __brev(q) >> (32 - bits) : 0u;
}

// The `width`-bit value of element i of an N-lane packed stream s.
__device__ __forceinline__ uint32_t unpack_elem(const uint8_t* s, int i,
                                                int width, int n) {
  uint32_t v = 0;
  const int planes = width >> 3;
  for (int k = 0; k < planes; ++k) v |= uint32_t(s[k * n + i]) << (8 * k);
  int a = width & 7;
  int base = planes * n, elem = i, lo = 0, cnt = a, dst = 8 * planes;
  int len = n;
  while (cnt > 0) {
    int w = a, sub = len, folds = 0;
    while (w < 8 && sub > 1) { w <<= 1; sub >>= 1; ++folds; }
    const int shift_sub = __ffs(sub) - 1;
    const int j = elem & (sub - 1);
    const int pos = a * int(bitrev(unsigned(elem >> shift_sub), folds)) + lo;
    const int hi = pos + cnt;
    if (pos < 8) {
      const int take = min(hi, 8) - pos;
      v |= ((uint32_t(s[base + j]) >> pos) & ((1u << take) - 1u)) << dst;
      dst += take;
    }
    if (hi <= 8) break;
    lo = max(pos, 8) - 8;
    cnt = hi - 8 - lo;
    elem = j; base += sub; a = w - 8; len = sub;
  }
  return v;
}

// Cooperative copy of nbytes from global to shared memory (16-byte
// vectors when both ends allow it).
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src,
                                      int nbytes) {
  if (((reinterpret_cast<uintptr_t>(src) | nbytes) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int k = threadIdx.x; k < (nbytes >> 4); k += blockDim.x) d4[k] = s4[k];
  } else {
    for (int k = threadIdx.x; k < nbytes; k += blockDim.x) dst[k] = src[k];
  }
}

__host__ __device__ __forceinline__ int align16(int x) {
  return (x + 15) & ~15;
}

// The bytes of a block's halving-packed high stream (hw bits a lane over
// n lanes, w_high bytes in all) that hold its first c lanes, the rows of
// the anomalous groups (c = high_len / hw = count * L); the other lanes
// are zero and no decoder reads them for a value it keeps.  Byte planes
// hold lane i at byte k * n + i; below 8 bits, lane i < SUB (the first
// level's lane count after its folds) is the low bits of byte i, so the
// first c lanes sit in bytes [0, c).  Past SUB the lanes fold into every
// byte: the whole stream.  (A prefix of high_len / 8 bytes, the exact
// wire length, would not do: the halving layout spreads the first c lanes
// over c bytes.)
__host__ __device__ inline int high_extent(int c, int hw, int n,
                                           int w_high) {
  if (c <= 0 || hw == 0) return 0;
  if ((hw & 7) == 0) return ((hw >> 3) - 1) * n + c;
  if (hw < 8) {
    int w = hw, sub = n;
    while (w < 8 && sub > 1) { w <<= 1; sub >>= 1; }
    return c <= sub ? c : w_high;
  }
  return w_high;
}

// Shared-memory layout of one staged block.
struct Stage {
  uint8_t *mask, *low, *high, *raw;
  int *rank, *warp_tot;

  __device__ Stage(uint8_t* smem, const Params& P) {
    mask = smem;
    low = mask + align16(P.w_mask);
    high = low + align16(P.w_low);
    raw = high + align16(P.w_high);
    rank = reinterpret_cast<int*>(raw + align16(P.w_raw));
    warp_tot = rank + align16(P.n_elems / P.L);
  }

  static __host__ int bytes(const Params& P) {
    return align16(P.w_mask) + align16(P.w_low) + align16(P.w_high) +
           align16(P.w_raw) + 4 * (align16(P.n_elems / P.L) + 32);
  }
};

// Stage block `blk`'s streams and rank its anomalous groups.
__device__ __forceinline__ void load_block(Stage& S, const Params& P,
                                           const uint8_t* mask,
                                           const uint8_t* low,
                                           const uint8_t* high,
                                           const uint8_t* raw, size_t blk) {
  stage(S.mask, mask + blk * P.w_mask, P.w_mask);
  stage(S.low, low + blk * P.w_low, P.w_low);
  if (P.w_high) stage(S.high, high + blk * P.w_high, P.w_high);
  stage(S.raw, raw + blk * P.w_raw, P.w_raw);
  __syncthreads();
  block_exclusive_rank(S.mask, P.n_elems / P.L, S.rank, S.warp_tot);
}

// Decode the staged block: store(i, bits) for each element i, with the
// block's inverse-map parameters (b, l).  Bit-exact with the reference's
// unsigned arithmetic (exponent kept mod 2**16, result to the format's
// width).
template <typename Store>
__device__ __forceinline__ void decode_staged(const Stage& S, const Params& P,
                                              int b, int l, Store store) {
  const int mod = (1 << P.n) - 1;
  const int c = (b - l) & mod;
  const int hw = P.n - P.m;
  const uint32_t mant_mask = (1u << P.mant_bits) - 1u;
  for (int i = threadIdx.x; i < P.n_elems; i += blockDim.x) {
    const int grp = i / P.L;
    uint32_t y = unpack_elem(S.low, i, P.m, P.n_elems);
    if (hw > 0 && ((S.mask[grp >> 3] >> (grp & 7)) & 1)) {
      const int src = S.rank[grp] * P.L + (i - grp * P.L);
      y |= unpack_elem(S.high, src, hw, P.n_elems) << P.m;
    }
    const uint32_t e = uint32_t(l + ((c - int(y)) & mod)) & 0xFFFFu;
    const uint32_t raw = unpack_elem(S.raw, i, P.mant_bits + 1, P.n_elems);
    uint32_t bits = (((raw >> P.mant_bits) & 1u) << (P.total_bits - 1)) |
                    (e << P.mant_bits) | (raw & mant_mask);
    if (P.total_bits == 16) bits &= 0xFFFFu;
    store(i, bits);
  }
}

// ---- decode with the block size and stream widths known at compile time --
// The fused matmul's tiles are always 16384-element blocks, so the fold
// structure of each packed stream (folds, lanes and byte base of every
// level) is a constant of the width: unpack_fixed<W, N> is unpack_elem with
// its fold loops unrolled, reached through one uniform switch on the width.

namespace fixed {

__host__ __device__ constexpr int folds_of(int a, int len) {
  int f = 0;
  while (a < 8 && len > 1) { a <<= 1; len >>= 1; ++f; }
  return f;
}

__host__ __device__ constexpr int log2_of(int x) {
  int r = 0;
  while (x > 1) { x >>= 1; ++r; }
  return r;
}

// One level of unpack_elem's loop: A bits a lane over LEN lanes at BASE.
template <int A, int LEN, int BASE>
__device__ __forceinline__ void level(const uint8_t* s, int elem, int lo,
                                      int cnt, int dst, uint32_t& v) {
  constexpr int F = folds_of(A, LEN);
  constexpr int SUB = LEN >> F;
  constexpr int W = A << F;
  const int j = elem & (SUB - 1);
  int pos = lo;
  if constexpr (F > 0)
    pos += A * int(__brev(unsigned(elem >> log2_of(SUB))) >> (32 - F));
  const int hi = pos + cnt;
  if (pos < 8) {
    const int take = min(hi, 8) - pos;
    v |= ((uint32_t(s[BASE + j]) >> pos) & ((1u << take) - 1u)) << dst;
    dst += take;
  }
  if constexpr (W > 8) {
    if (hi > 8) {
      const int lo2 = max(pos, 8) - 8;
      level<W - 8, SUB, BASE + SUB>(s, j, lo2, hi - 8 - lo2, dst, v);
    }
  }
}

template <int WIDTH, int N>
__device__ __forceinline__ uint32_t unpack(const uint8_t* s, int i) {
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < (WIDTH >> 3); ++k)
    v |= uint32_t(s[k * N + i]) << (8 * k);
  if constexpr ((WIDTH & 7) != 0)
    level<WIDTH & 7, N, (WIDTH >> 3) * N>(s, i, 0, WIDTH & 7,
                                          8 * (WIDTH >> 3), v);
  return v;
}

}  // namespace fixed

// The `width`-bit value of element i of an N-lane packed stream, through
// the unrolled unpack for the widths ENEC's streams take (1..8 for the
// exponent streams; 8, 11, 24 for bf16 / fp16 / fp32 sign+mantissa).
template <int N>
__device__ __forceinline__ uint32_t unpack_fixed(const uint8_t* s, int i,
                                                 int width) {
  switch (width) {
    case 1: return fixed::unpack<1, N>(s, i);
    case 2: return fixed::unpack<2, N>(s, i);
    case 3: return fixed::unpack<3, N>(s, i);
    case 4: return fixed::unpack<4, N>(s, i);
    case 5: return fixed::unpack<5, N>(s, i);
    case 6: return fixed::unpack<6, N>(s, i);
    case 7: return fixed::unpack<7, N>(s, i);
    case 8: return fixed::unpack<8, N>(s, i);
    case 11: return fixed::unpack<11, N>(s, i);
    case 24: return fixed::unpack<24, N>(s, i);
    default: return unpack_elem(s, i, width, N);
  }
}

// decode_staged for blocks of exactly N elements (P.n_elems == N): the same
// values in the same calls to store, with the unrolled unpacks and the
// group index by a shift when L is a power of two.
template <int N, typename Store>
__device__ __forceinline__ void decode_staged_fixed(const Stage& S,
                                                    const Params& P, int b,
                                                    int l, Store store) {
  const int mod = (1 << P.n) - 1;
  const int c = (b - l) & mod;
  const int hw = P.n - P.m;
  const uint32_t mant_mask = (1u << P.mant_bits) - 1u;
  const int lshift = (P.L & (P.L - 1)) ? -1 : __ffs(P.L) - 1;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int grp = lshift >= 0 ? i >> lshift : i / P.L;
    uint32_t y = unpack_fixed<N>(S.low, i, P.m);
    if (hw > 0 && ((S.mask[grp >> 3] >> (grp & 7)) & 1)) {
      const int src = S.rank[grp] * P.L + (i - grp * P.L);
      y |= unpack_fixed<N>(S.high, src, hw) << P.m;
    }
    const uint32_t e = uint32_t(l + ((c - int(y)) & mod)) & 0xFFFFu;
    const uint32_t raw = unpack_fixed<N>(S.raw, i, P.mant_bits + 1);
    uint32_t bits = (((raw >> P.mant_bits) & 1u) << (P.total_bits - 1)) |
                    (e << P.mant_bits) | (raw & mant_mask);
    if (P.total_bits == 16) bits &= 0xFFFFu;
    store(i, bits);
  }
}

// ---- decode by lane groups, four lanes a thread (bf16 blocks) -------------
// A halving-packed stream of A < 8 bits over N lanes keeps, after F folds,
// SUB = N >> F lanes of W = A << F bits: lane j's W-bit word holds the A
// bits of the 2**F elements j + q * SUB (q < 2**F) at bit A * bitrev_F(q);
// its low byte is byte j of the level and the W - 8 bits above are element
// j of the next level, itself a packed stream over SUB lanes.  So one
// thread that owns lane j reads the word once and emits every element of
// its group, where unpack_fixed re-reads the word for each element.  The
// thread takes four neighbouring lanes (j0 .. j0 + 3, j0 % 4 == 0): their
// bytes are one 32-bit load at every level (SUB >= 4 at every level of a
// 16384-element block), and the four elements j0 + q * SUB .. + 3 it emits
// for each q share one group (L % 4 == 0), one raw word and one 8-byte
// store.  Values travel as two 16-bit lanes a register (elements i0, i0 +
// 1 in one, i0 + 2, i0 + 3 in the other): every value and every field of
// a bf16 fits 16 bits, so one shift, mask or 16-bit SIMD add serves two
// elements.

namespace lanes {

__host__ __device__ constexpr int rev_bits(int q, int bits) {
  int r = 0;
  for (int k = 0; k < bits; ++k) r |= ((q >> k) & 1) << (bits - 1 - k);
  return r;
}

// Bytes b0..b3 of w as two pairs of 16-bit lanes: b0 | b1 << 16, b2 | b3 <<
// 16.
__device__ __forceinline__ void spread(uint32_t w, uint32_t (&p)[2]) {
  p[0] = __byte_perm(w, 0u, 0x4140);
  p[1] = __byte_perm(w, 0u, 0x4342);
}

// fixed::level for the four elements elem0 .. elem0 + 3 (elem0 % 4 == 0),
// ORed into the pairs v.  TOP: the first level of a value (lo == 0, cnt ==
// A), where a word of at most 8 bits holds all of an element's bits.
template <int A, int LEN, int BASE, bool TOP = false>
__device__ __forceinline__ void level4(const uint8_t* s, int elem0, int lo,
                                       int cnt, int dst, uint32_t (&v)[2]) {
  constexpr int F = fixed::folds_of(A, LEN);
  constexpr int SUB = LEN >> F;
  constexpr int W = A << F;
  static_assert(SUB >= 4, "four lanes a load");
  const int j0 = elem0 & (SUB - 1);
  int pos = lo;
  if constexpr (F > 0)
    pos += A * int(__brev(unsigned(elem0 >> fixed::log2_of(SUB))) >> (32 - F));
  if constexpr (TOP && W <= 8) {
    uint32_t p[2];
    spread(*reinterpret_cast<const uint32_t*>(s + BASE + j0), p);
    constexpr uint32_t m = ((1u << A) - 1u) * 0x10001u;
    v[0] |= ((p[0] >> pos) & m) << dst;
    v[1] |= ((p[1] >> pos) & m) << dst;
    return;
  }
  const int hi = pos + cnt;
  if (pos < 8) {
    const int take = min(hi, 8) - pos;
    uint32_t p[2];
    spread(*reinterpret_cast<const uint32_t*>(s + BASE + j0), p);
    const uint32_t m = ((1u << take) - 1u) * 0x10001u;
    v[0] |= ((p[0] >> pos) & m) << dst;
    v[1] |= ((p[1] >> pos) & m) << dst;
    dst += take;
  }
  if constexpr (W > 8) {
    if (hi > 8) {
      const int lo2 = max(pos, 8) - 8;
      level4<W - 8, SUB, BASE + SUB>(s, j0, lo2, hi - 8 - lo2, dst, v);
    }
  }
}

// fixed::unpack for the four elements i0 .. i0 + 3 (i0 % 4 == 0) of a
// stream of WIDTH <= 15 bits, as two pairs.
template <int WIDTH, int N>
__device__ __forceinline__ void unpack4(const uint8_t* s, int i0,
                                        uint32_t (&v)[2]) {
  static_assert(WIDTH < 16, "a value a 16-bit lane");
  v[0] = v[1] = 0u;
  if constexpr (WIDTH >= 8) {
    spread(*reinterpret_cast<const uint32_t*>(s + i0), v);
  }
  if constexpr ((WIDTH & 7) != 0)
    level4<WIDTH & 7, N, (WIDTH >> 3) * N, true>(s, i0, 0, WIDTH & 7,
                                                 8 * (WIDTH >> 3), v);
}

// The anomaly bit and exclusive rank of group g of a block whose mask has
// G <= 1024 groups, with no shared rank array and no block barrier: lane
// i of each warp holds mask word i and the count of anomalous groups
// before it; a lookup is two shuffles and a popcount.  Every lane of the
// warp must call load and at (the shuffles take the full warp).
struct WarpRank {
  uint32_t word, before;

  __device__ __forceinline__ void load(const uint8_t* mask, int G) {
    const int lane = threadIdx.x & 31;
    const int bits = G - 32 * lane;   // groups of this lane's word
    uint32_t w = bits > 0 ? *reinterpret_cast<const uint32_t*>(mask + 4 * lane)
                          : 0u;
    if (bits < 32) w &= bits > 0 ? (1u << bits) - 1u : 0u;
    const uint32_t c = __popc(w);
    uint32_t incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    word = w;
    before = incl - c;
  }

  __device__ __forceinline__ bool at(int g, int& rank) const {
    const uint32_t w = __shfl_sync(0xffffffffu, word, g >> 5);
    const uint32_t e = __shfl_sync(0xffffffffu, before, g >> 5);
    rank = int(e + __popc(w & ((1u << (g & 31)) - 1u)));
    return (w >> (g & 31)) & 1u;
  }
};

// The elements of lanes j0 .. j0 + 3 of NB blocks whose low words (W
// bits a lane, as pairs) are in hand, for high width HW (the params' n -
// m, a template argument so that the units of one thread are straight-line
// code the compiler can interleave).  rank(nb, g, r) -> whether group g
// of block nb is anomalous, with its exclusive rank in r; the high bits
// are unpacked for every group and kept only for the anomalous ones (no
// divergent branch: at the searched params most warps hold an anomalous
// group).  The exponent l + ((c - y) & mod) is taken on both lanes of a
// pair at once: c + mod + 1 - y >= 1 never borrows from the upper lane,
// and with l taken mod 512 (0 <= l < 512: the bf16 bits keep only e's low
// 9 bits, and 2**n divides 512 for n <= 9) the sum never carries into it;
// the bf16 bits (sign << 15 | e << 7 | mantissa) mod 2**16 by masks on the
// pairs.
template <int A, int HW, int N, int NB, typename Rank, typename Store4>
__device__ __forceinline__ void emit_lanes(const Stage (&S)[NB],
                                           const uint32_t (&word)[NB][2],
                                           int j0, int L, int lshift,
                                           uint32_t cb2, uint32_t l2,
                                           uint32_t mod2, Rank& rank,
                                           Store4& store4) {
  constexpr int F = A < 8 ? fixed::folds_of(A, N) : 0;
  constexpr int SUB = N >> F;
#pragma unroll
  for (int q = 0; q < (1 << F); ++q) {
    const int i0 = j0 + q * SUB;
    const int grp = i0 >> lshift;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t y[2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        y[k] = A < 8 ? (word[nb][k] >> (A * rev_bits(q, F))) &
                           (((1u << A) - 1u) * 0x10001u)
                     : word[nb][k];
      if constexpr (HW > 0) {
        int rk;
        const uint32_t keep = rank(nb, grp, rk) ? 0xFFFFFFFFu : 0u;
        uint32_t h[2];
        unpack4<HW, N>(S[nb].high, rk * L + (i0 & (L - 1)), h);
        y[0] |= (h[0] << A) & keep;
        y[1] |= (h[1] << A) & keep;
      }
      uint32_t raw[2];
      spread(*reinterpret_cast<const uint32_t*>(S[nb].raw + i0), raw);
      uint32_t bits[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const uint32_t e = l2 + ((cb2 - y[k]) & mod2);
        bits[k] = ((raw[k] & 0x00800080u) << 8) | ((e << 7) & 0xFF80FF80u) |
                  (raw[k] & 0x007F007Fu);
      }
      store4(nb, i0, bits[0], bits[1]);
    }
  }
}

// NB blocks with low width A (the params' m), decoded together: the same
// lanes of each block in one pass, so a thread has NB independent chains
// of loads in flight.
template <int A, int N, int NB, typename Rank, typename Store4>
__device__ __forceinline__ void decode_bf16(const Stage (&S)[NB],
                                            const Params& P, int b, int l,
                                            Rank rank, Store4 store4) {
  constexpr int F = A < 8 ? fixed::folds_of(A, N) : 0;
  constexpr int SUB = N >> F;
  constexpr int W = A << F;
  const uint32_t mod = (1u << P.n) - 1u;
  // c + mod + 1 on both lanes (c = (b - l) & mod), l mod 512 on both lanes
  const uint32_t cb2 = ((uint32_t(b - l) & mod) + mod + 1u) * 0x10001u;
  const uint32_t l2 = (uint32_t(l) & 511u) * 0x10001u;
  const uint32_t mod2 = mod * 0x10001u;
  const int hw = P.n - P.m;
  const int lshift = __ffs(P.L) - 1;
  for (int j0 = 4 * threadIdx.x; j0 < SUB; j0 += 4 * blockDim.x) {
    uint32_t word[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      if constexpr (A < 8) {
        spread(*reinterpret_cast<const uint32_t*>(S[nb].low + j0), word[nb]);
        if constexpr (W > 8) {
          uint32_t over[2];
          unpack4<W - 8, SUB>(S[nb].low + SUB, j0, over);
          word[nb][0] |= over[0] << 8;
          word[nb][1] |= over[1] << 8;
        }
      } else {
        unpack4<A, N>(S[nb].low, j0, word[nb]);
      }
    }
#define ENEC_EMIT(HW)                                                       \
  case HW:                                                                  \
    if constexpr (A + HW <= 9)                                              \
      emit_lanes<A, HW, N>(S, word, j0, P.L, lshift, cb2, l2, mod2, rank,   \
                           store4);                                         \
    break;
    switch (hw) {   // n <= 9 for bf16, so A + hw <= 9
      ENEC_EMIT(0) ENEC_EMIT(1) ENEC_EMIT(2) ENEC_EMIT(3) ENEC_EMIT(4)
      ENEC_EMIT(5) ENEC_EMIT(6) ENEC_EMIT(7) ENEC_EMIT(8)
    }
#undef ENEC_EMIT
  }
}

}  // namespace lanes

// decode_staged for NB bf16 blocks of exactly N elements each, n <= 9 and
// L a power of two >= 4, any (b, l), decoded together: store4(nb, i0, lo,
// hi) for elements i0 .. i0 + 3 of block nb as two pairs of 16-bit lanes
// (lo = i0 | i0 + 1 << 16, hi = i0 + 2 | i0 + 3 << 16), every i0 % 4 == 0
// once; the same bits as decode_staged.  Thread t emits only i0 ==
// 4 t (mod 4 blockDim.x) when that divides N / 2**F (so at 512 threads
// warp w writes whole 128-element rows w, w + 16, ..).  rank(nb, g, r)
// gives group g's anomaly bit and rank (lanes::WarpRank on the card; it
// must be callable by the whole warp: with blockDim.x and N / 2**F / 4
// multiples of 32, every lane of a warp makes the same calls).  A high
// stream is read past the anomalous groups' rows (and then ignored) up to
// the block's own raw stream, which follows it in the stage.
template <int N, int NB, typename Rank, typename Store4>
__device__ __forceinline__ void decode_staged_lanes_bf16(
    const Stage (&S)[NB], const Params& P, int b, int l, Rank rank,
    Store4 store4) {
  switch (P.m) {
    case 1: lanes::decode_bf16<1, N>(S, P, b, l, rank, store4); return;
    case 2: lanes::decode_bf16<2, N>(S, P, b, l, rank, store4); return;
    case 3: lanes::decode_bf16<3, N>(S, P, b, l, rank, store4); return;
    case 4: lanes::decode_bf16<4, N>(S, P, b, l, rank, store4); return;
    case 5: lanes::decode_bf16<5, N>(S, P, b, l, rank, store4); return;
    case 6: lanes::decode_bf16<6, N>(S, P, b, l, rank, store4); return;
    case 7: lanes::decode_bf16<7, N>(S, P, b, l, rank, store4); return;
    case 8: lanes::decode_bf16<8, N>(S, P, b, l, rank, store4); return;
    default: lanes::decode_bf16<9, N>(S, P, b, l, rank, store4); return;
  }
}


__device__ __forceinline__ float bits_to_float(uint32_t bits, int mant_bits) {
  if (mant_bits == 7) return __uint_as_float(bits << 16);           // bf16
  if (mant_bits == 10) return __half2float(__ushort_as_half((unsigned short)bits));
  return __uint_as_float(bits);                                     // fp32
}

}  // namespace enec
