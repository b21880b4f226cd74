// ENEC block encoder for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/enec_encode.py:
// encode_blocks_pallas (body encode_block_body, with _onehot_scatter).
//
// What bounds it on the H100: memory in principle.  Per element it reads
// 2 (or 4) input bytes and writes about (n + raw_bits)/8 compressed bytes,
// with a few dozen integer operations between; at 3.35 TB/s the bytes take
// well under a nanosecond per thousand elements.  This first version is
// bound by its shared-memory atomics instead (one per packed piece, see
// below), which a later tuning pass can replace by warp-level packing.
//
// What the design does: one CTA per block of N elements stages the
// block's input in shared memory with 16-byte loads (each input byte is
// read from device memory once), computes the exponent's linear map
// y = (b - x) mod 2**n with b from a per-block vector, ORs each group of L
// values to flag anomalous groups, and ranks them with the ballot/popc
// warp scan of idd_scan.cuh.  The TPU's one-hot MXU scatter becomes a
// direct write: element t of anomalous group g is packed at lane
// rank[g] * L + t of the high stream; lanes >= count * L stay zero.  Each
// stream is packed into one zeroed shared buffer by OR-ing every element's
// pieces into 32-bit words with atomicOr (pack_elem, the inverse of
// enec_block.cuh's unpack_elem): in the halving layout lanes i and
// i + len/2 share a byte, and OR is commutative, so the bytes do not
// depend on the order of the threads.  The buffer is then copied out with
// 16-byte stores and reused for the next stream, so the largest stream
// (fp32 raw, 3N bytes) and the staged input fit one CTA's shared memory.
#include <cuda_runtime.h>

#include "enec_block.cuh"

namespace {

__device__ __forceinline__ void or_byte(uint32_t* words, int off,
                                        uint32_t bits) {
  if (bits) atomicOr(&words[off >> 2], bits << (8 * (off & 3)));
}

// OR the `width`-bit value v of lane i into a zeroed N-lane packed stream
// held as 32-bit words: unpack_elem's walk, each piece written instead of
// read.
__device__ __forceinline__ void pack_elem(uint32_t* words, int i, uint32_t v,
                                          int width, int n) {
  const int planes = width >> 3;
  for (int k = 0; k < planes; ++k)
    or_byte(words, k * n + i, (v >> (8 * k)) & 0xFFu);
  int a = width & 7;
  int base = planes * n, elem = i, lo = 0, cnt = a, dst = 8 * planes;
  int len = n;
  while (cnt > 0) {
    int w = a, sub = len, folds = 0;
    while (w < 8 && sub > 1) { w <<= 1; sub >>= 1; ++folds; }
    const int shift_sub = __ffs(sub) - 1;
    const int j = elem & (sub - 1);
    const int pos =
        a * int(enec::bitrev(unsigned(elem >> shift_sub), folds)) + lo;
    const int hi = pos + cnt;
    if (pos < 8) {
      const int take = min(hi, 8) - pos;
      or_byte(words, base + j, ((v >> dst) & ((1u << take) - 1u)) << pos);
      dst += take;
    }
    if (hi <= 8) break;
    lo = max(pos, 8) - 8;
    cnt = hi - 8 - lo;
    elem = j; base += sub; a = w - 8; len = sub;
  }
}

__device__ __forceinline__ void zero_words(uint32_t* words, int nbytes) {
  for (int k = threadIdx.x; k < (nbytes + 3) >> 2; k += blockDim.x)
    words[k] = 0u;
}

// Cooperative copy of nbytes from shared to global memory.
__device__ __forceinline__ void unstage(uint8_t* dst, const uint8_t* src,
                                        int nbytes) {
  if (((reinterpret_cast<uintptr_t>(dst) | nbytes) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int k = threadIdx.x; k < (nbytes >> 4); k += blockDim.x) d4[k] = s4[k];
  } else {
    for (int k = threadIdx.x; k < nbytes; k += blockDim.x) dst[k] = src[k];
  }
}

// Shared-memory layout of one block: staged input, one packed-stream
// buffer, the mask bytes, per-group flags and ranks, scan scratch.
struct EncStage {
  uint8_t* x;
  uint32_t* buf;
  uint8_t* mask;
  int *flag, *rank, *warp_tot;

  static __host__ __device__ int buf_bytes(const enec::Params& P) {
    const int w = P.w_low > P.w_high ? P.w_low : P.w_high;
    return enec::align16(w > P.w_raw ? w : P.w_raw);
  }

  __device__ EncStage(uint8_t* smem, const enec::Params& P) {
    const int g = P.n_elems / P.L;
    x = smem;
    buf = reinterpret_cast<uint32_t*>(
        x + enec::align16(P.n_elems * (P.total_bits / 8)));
    mask = reinterpret_cast<uint8_t*>(buf) + buf_bytes(P);
    flag = reinterpret_cast<int*>(mask + enec::align16(P.w_mask));
    rank = flag + enec::align16(g);
    warp_tot = rank + enec::align16(g);
  }

  static __host__ int bytes(const enec::Params& P) {
    const int g = P.n_elems / P.L;
    return enec::align16(P.n_elems * (P.total_bits / 8)) + buf_bytes(P) +
           enec::align16(P.w_mask) + 4 * (2 * enec::align16(g) + 32);
  }
};

__global__ void __launch_bounds__(enec::kThreads)
enec_encode_kernel(const uint8_t* __restrict__ bits,
                   const int* __restrict__ b_vec, uint8_t* __restrict__ mask,
                   uint8_t* __restrict__ low, uint8_t* __restrict__ high,
                   int* __restrict__ high_len, uint8_t* __restrict__ raw,
                   enec::Params P) {
  extern __shared__ __align__(16) uint8_t smem[];
  EncStage S(smem, P);
  const int N = P.n_elems, G = N / P.L;
  const int eb = P.total_bits / 8;
  const size_t blk = blockIdx.x;
  enec::stage(S.x, bits + blk * size_t(N) * eb, N * eb);
  __syncthreads();

  const int b = b_vec[blk];
  const int nmask = (1 << P.n) - 1;
  const uint32_t exp_mask = (1u << (P.total_bits - 1 - P.mant_bits)) - 1u;
  auto x_of = [&](int i) -> uint32_t {
    return eb == 2 ? uint32_t(reinterpret_cast<const uint16_t*>(S.x)[i])
                   : reinterpret_cast<const uint32_t*>(S.x)[i];
  };
  auto y_of = [&](int i) -> uint32_t {
    const int e = int((x_of(i) >> P.mant_bits) & exp_mask);
    return uint32_t((b - e) & nmask);
  };

  // anomaly flags: a group is anomalous iff the OR of its y has a bit >= m
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    uint32_t o = 0;
    for (int t = 0; t < P.L; ++t) o |= y_of(g * P.L + t);
    S.flag[g] = (o >> P.m) != 0;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < P.w_mask; k += blockDim.x) {
    uint32_t byte = 0;
    for (int t = 0; t < 8; ++t) byte |= uint32_t(S.flag[8 * k + t]) << t;
    S.mask[k] = uint8_t(byte);
    mask[blk * P.w_mask + k] = uint8_t(byte);
  }
  __syncthreads();
  block_exclusive_rank(S.mask, G, S.rank, S.warp_tot);
  if (threadIdx.x == 0)
    high_len[blk] = (S.rank[G - 1] + S.flag[G - 1]) * P.L * (P.n - P.m);

  // low stream: the low m bits of every element
  if (P.w_low) {
    zero_words(S.buf, P.w_low);
    __syncthreads();
    const uint32_t low_mask = (1u << P.m) - 1u;
    for (int i = threadIdx.x; i < N; i += blockDim.x)
      pack_elem(S.buf, i, y_of(i) & low_mask, P.m, N);
    __syncthreads();
    unstage(low + blk * P.w_low, reinterpret_cast<uint8_t*>(S.buf), P.w_low);
    __syncthreads();
  }
  // high stream: the high n - m bits of anomalous groups, in rank order
  if (P.w_high) {
    zero_words(S.buf, P.w_high);
    __syncthreads();
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const int g = i / P.L;
      if (S.flag[g])
        pack_elem(S.buf, S.rank[g] * P.L + (i - g * P.L), y_of(i) >> P.m,
                  P.n - P.m, N);
    }
    __syncthreads();
    unstage(high + blk * P.w_high, reinterpret_cast<uint8_t*>(S.buf),
            P.w_high);
    __syncthreads();
  }
  // raw stream: sign | mantissa of every element
  zero_words(S.buf, P.w_raw);
  __syncthreads();
  const uint32_t mant_mask = (1u << P.mant_bits) - 1u;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const uint32_t x = x_of(i);
    const uint32_t r = (x & mant_mask) |
                       (((x >> (P.total_bits - 1)) & 1u) << P.mant_bits);
    pack_elem(S.buf, i, r, P.mant_bits + 1, N);
  }
  __syncthreads();
  unstage(raw + blk * P.w_raw, reinterpret_cast<uint8_t*>(S.buf), P.w_raw);
}

}  // namespace

// Encode `nblocks` blocks of n_elems raw float bits (2 or 4 bytes each);
// returns the cudaError_t of the launch.
extern "C" int enec_encode_launch(const void* bits, const int* b_vec,
                                  uint8_t* mask, uint8_t* low, uint8_t* high,
                                  int* high_len, uint8_t* raw, int nblocks,
                                  int n_elems, int L, int n, int m,
                                  int total_bits, int mant_bits, int w_mask,
                                  int w_low, int w_high, int w_raw,
                                  void* stream) {
  const enec::Params P{n_elems, L, n, m, total_bits, mant_bits,
                       w_mask, w_low, w_high, w_raw};
  const int smem = EncStage::bytes(P);
  cudaError_t err = cudaFuncSetAttribute(
      enec_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  if (nblocks == 0) return 0;
  enec_encode_kernel<<<nblocks, enec::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), b_vec, mask, low, high, high_len,
      raw, P);
  return int(cudaGetLastError());
}
