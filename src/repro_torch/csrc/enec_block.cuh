// Device code shared by the ENEC decoder (enec_decode.cu) and the fused
// decode+matmul (decompress_matmul.cu): the closed-form unpack of one
// element from a halving-packed stream, stream staging into shared memory,
// and the decode of one block with its exclusive anomaly rank.
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

__device__ __forceinline__ float bits_to_float(uint32_t bits, int mant_bits) {
  if (mant_bits == 7) return __uint_as_float(bits << 16);           // bf16
  if (mant_bits == 10) return __half2float(__ushort_as_half((unsigned short)bits));
  return __uint_as_float(bits);                                     // fp32
}

}  // namespace enec
