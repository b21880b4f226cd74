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

__device__ __forceinline__ float bits_to_float(uint32_t bits, int mant_bits) {
  if (mant_bits == 7) return __uint_as_float(bits << 16);           // bf16
  if (mant_bits == 10) return __half2float(__ushort_as_half((unsigned short)bits));
  return __uint_as_float(bits);                                     // fp32
}

}  // namespace enec
