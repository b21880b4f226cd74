// ENEC block decoder for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/enec_decode.py:
// decode_blocks_pallas (body decode_block_body, with _mask_to_bits,
// _exclusive_rank and _segment_gather).
//
// What bounds it on the H100: memory.  Per element it reads about
// (n + raw_bits)/8 compressed bytes (~1.1 B at bf16) and writes 2 (or 4)
// dense bytes; at 3.35 TB/s the llama embed's 0.9 GB take 0.27 ms.  The
// integer work between (a few dozen operations an element) comes close to
// that: the decode has to issue few instructions per element and keep
// enough warps on each SM to hide the loads.
//
// What the design does about it (the host planner kernels/enec_decode.py:
// plan picks the branch and the grid, the kernel obeys):
// * Persistent grid: SM count x resident CTAs, CTA c walking blocks c,
//   c + grid, ...; (b, l) are per-block vectors, so blocks of tensors with
//   different searched parameters decode in one launch.
// * Lanes branch (bf16 blocks of 16384 elements, L a power of two in
//   16..2048, n <= 9: every block of the serving path): the next block's
//   mask, low and raw streams and the first high_extent bytes of its high
//   stream (the rows of its anomalous groups, from high_len; not the
//   static width) go into one of two stages by cp.async.bulk on an
//   mbarrier (cp.async or loads where a stream is not 16-byte aligned),
//   issued by the last warp while the current block is decoded.  The decode
//   is enec_block.cuh: decode_staged_lanes_bf16, as in kernel 5: a thread
//   owns four lanes of the folded low stream and emits every element of
//   their groups as pairs of 16-bit lanes, each warp ranks the anomalous
//   groups itself from the mask words (lanes::WarpRank: no rank array, no
//   block barrier), and each thread stores its four elements as one 8-byte
//   store, so a warp writes whole 256-byte rows.  One block barrier a block
//   (the stage ring).  512 threads, two CTAs an SM (two blocks decoded
//   together, one CTA an SM, was no faster on the card).
// * Generic branch (fp16, fp32, other block sizes and group lengths): the
//   same persistent walk, one block at a time through shared memory with
//   16-byte loads (high stream to its extent), the ballot/popc rank of
//   idd_scan.cuh and the element-wise unpack (enec_block.cuh:
//   decode_staged).
#include <cuda_runtime.h>

#include "enec_block.cuh"
#include "ptx.cuh"

namespace {

using namespace ptx;

constexpr int kBlock = 16384;    // the lanes branch's block
constexpr int kThreads = 512;
constexpr int kStages = 2;

struct Args {
  const uint8_t *mask, *low, *high, *raw;
  const int *high_len, *b_vec, *l_vec;
  void* out;
  long long nblocks;
  enec::Params P;
};

// Bytes of one staged block's streams (mask, low, high, raw at their
// static widths, each 16-byte aligned): enec::Stage's layout without the
// rank arrays.
__host__ __device__ inline int streams_bytes(const enec::Params& P) {
  using enec::align16;
  return align16(P.w_mask) + align16(P.w_low) + align16(P.w_high) +
         align16(P.w_raw);
}

__host__ inline int lanes_smem(const enec::Params& P) {
  return kStages * streams_bytes(P) + 8 * kStages;
}

// The high-stream bytes of block blk the decoders must see.
__device__ __forceinline__ int high_bytes(const Args& a, long long blk) {
  const int hw = a.P.n - a.P.m;
  return hw ? enec::high_extent(a.high_len[blk] / hw, hw, a.P.n_elems,
                                a.P.w_high)
            : 0;
}

__global__ void __launch_bounds__(kThreads, 2)
decode_lanes_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const enec::Params& P = a.P;
  const int sb = streams_bytes(P);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * sb);
  const int tid = threadIdx.x, lane = tid & 31;
  const int count = a.nblocks > blockIdx.x
      ? int((a.nblocks - 1 - blockIdx.x) / gridDim.x) + 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // block j's streams into stage j % 2 by the last warp alone (the bulk
  // copies issued by its first thread, after it posted their bytes)
  constexpr int kIssuer = kThreads - 32;
  const bool stager = tid >= kIssuer;
  auto prefetch = [&](int j) {
    if (j < count) {
      const long long blk = blockIdx.x + (long long)j * gridDim.x;
      const enec::Stage S(smem + (j % kStages) * sb, P);
      uint64_t* bar = &bars[j % kStages];
      const int hb = high_bytes(a, blk);
      if (tid == kIssuer)
        mbar_expect_tx(bar, bulk_bytes(a.mask, P.w_mask) +
                                bulk_bytes(a.low, P.w_low) +
                                bulk_bytes(a.high, P.w_high, hb) +
                                bulk_bytes(a.raw, P.w_raw));
      stage_stream(S.mask, a.mask, P.w_mask, blk, bar, kIssuer, lane, 32);
      stage_stream(S.low, a.low, P.w_low, blk, bar, kIssuer, lane, 32);
      stage_stream(S.high, a.high, P.w_high, blk, bar, kIssuer, lane, 32,
                   hb);
      stage_stream(S.raw, a.raw, P.w_raw, blk, bar, kIssuer, lane, 32);
    }
    cp_async_commit();   // one group per block, empty past the end
  };

  if (stager) prefetch(0);
  for (int j = 0; j < count; ++j) {
    const long long blk = blockIdx.x + (long long)j * gridDim.x;
    uint8_t* st = smem + (j % kStages) * sb;
    cp_async_wait<0>();
    mbar_wait(&bars[j % kStages], (j / kStages) & 1);
    __syncthreads();   // block j staged; every warp is past block j - 1
    if (stager) prefetch(j + 1);

    const enec::Stage S[1] = {enec::Stage(st, P)};
    enec::lanes::WarpRank rk;
    rk.load(st, P.n_elems / P.L);
    uint16_t* o = static_cast<uint16_t*>(a.out) + blk * kBlock;
    enec::decode_staged_lanes_bf16<kBlock>(
        S, P, a.b_vec[blk], a.l_vec[blk],
        [&](int, int g, int& r) { return rk.at(g, r); },
        [&](int, int i0, uint32_t lo, uint32_t hi) {
          *reinterpret_cast<uint2*>(o + i0) = make_uint2(lo, hi);
        });
  }
}

__global__ void __launch_bounds__(kThreads)
decode_generic_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const enec::Params& P = a.P;
  enec::Stage S(smem, P);
  for (long long blk = blockIdx.x; blk < a.nblocks; blk += gridDim.x) {
    enec::stage(S.mask, a.mask + blk * P.w_mask, P.w_mask);
    enec::stage(S.low, a.low + blk * P.w_low, P.w_low);
    const uint8_t* hsrc = a.high + blk * P.w_high;
    int hb = high_bytes(a, blk);
    if (((reinterpret_cast<uintptr_t>(hsrc) | unsigned(P.w_high)) & 15) == 0)
      hb = min(enec::align16(hb), P.w_high);   // whole 16-byte vectors
    enec::stage(S.high, hsrc, hb);
    enec::stage(S.raw, a.raw + blk * P.w_raw, P.w_raw);
    __syncthreads();
    block_exclusive_rank(S.mask, P.n_elems / P.L, S.rank, S.warp_tot);
    const int b = a.b_vec[blk], l = a.l_vec[blk];
    if (P.total_bits == 16) {
      uint16_t* o = static_cast<uint16_t*>(a.out) + blk * P.n_elems;
      enec::decode_staged(S, P, b, l,
                          [&](int i, uint32_t v) { o[i] = uint16_t(v); });
    } else {
      uint32_t* o = static_cast<uint32_t*>(a.out) + blk * P.n_elems;
      enec::decode_staged(S, P, b, l, [&](int i, uint32_t v) { o[i] = v; });
    }
    __syncthreads();   // the stage is rewritten for the next block
  }
}

// Per device and branch (generic, lanes): the SM count, and the
// shared-memory size last opted into with its resident CTAs per SM.
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
int g_smem[kMaxDevices][2], g_per_sm[kMaxDevices][2];

int prepare(const enec::Params& P, int lanes, int* smem_out, int* per_sm_out,
            int* sms_out) {
  const void* kern = lanes
      ? reinterpret_cast<const void*>(decode_lanes_kernel)
      : reinterpret_cast<const void*>(decode_generic_kernel);
  const int smem = lanes ? lanes_smem(P) : enec::Stage::bytes(P);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return int(err);
  }
  if (g_smem[dev][lanes] != smem) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return int(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &g_per_sm[dev][lanes], kern, kThreads, smem);
    if (err != cudaSuccess) return int(err);
    if (g_per_sm[dev][lanes] == 0) return int(cudaErrorInvalidConfiguration);
    g_smem[dev][lanes] = smem;
  }
  *smem_out = smem;
  *per_sm_out = g_per_sm[dev][lanes];
  *sms_out = g_sms[dev];
  return 0;
}

enec::Params params_of(int n_elems, int L, int n, int m, int total_bits,
                       int mant_bits, int w_mask, int w_low, int w_high,
                       int w_raw) {
  return enec::Params{n_elems, L, n, m, total_bits, mant_bits,
                      w_mask, w_low, w_high, w_raw};
}

}  // namespace

// The launch resources of one configuration on the current device (lanes
// 0: the generic branch; 1: the lanes branch): out = {dynamic shared
// bytes, resident CTAs per SM, SM count}; returns the cudaError_t of the
// queries.
extern "C" int enec_decode_resources(int lanes, int n_elems, int L, int n,
                                     int m, int total_bits, int mant_bits,
                                     int w_mask, int w_low, int w_high,
                                     int w_raw, int* out) {
  return prepare(params_of(n_elems, L, n, m, total_bits, mant_bits, w_mask,
                           w_low, w_high, w_raw),
                 lanes, &out[0], &out[1], &out[2]);
}

// Decode `nblocks` blocks on `grid` CTAs (the host's plan: lanes 1 takes
// bf16 blocks of 16384 elements with L a power of two in 16..2048 and
// n <= 9); high_len: each block's high-stream length in bits.  Returns the
// cudaError_t of the launch.
extern "C" int enec_decode_launch(const uint8_t* mask, const uint8_t* low,
                                  const uint8_t* high, const int* high_len,
                                  const uint8_t* raw, const int* b_vec,
                                  const int* l_vec, void* out,
                                  long long nblocks, int n_elems, int L,
                                  int n, int m, int total_bits,
                                  int mant_bits, int w_mask, int w_low,
                                  int w_high, int w_raw, int lanes, int grid,
                                  void* stream) {
  Args a{};
  a.mask = mask;
  a.low = low;
  a.high = high;
  a.raw = raw;
  a.high_len = high_len;
  a.b_vec = b_vec;
  a.l_vec = l_vec;
  a.out = out;
  a.nblocks = nblocks;
  a.P = params_of(n_elems, L, n, m, total_bits, mant_bits, w_mask, w_low,
                  w_high, w_raw);
  if (lanes && (n_elems != kBlock || total_bits != 16 || mant_bits != 7 ||
                n > 9 || L < 16 || L > 2048 || (L & (L - 1))))
    return int(cudaErrorInvalidValue);
  int smem, per_sm, sms;
  const int err = prepare(a.P, lanes, &smem, &per_sm, &sms);
  if (err) return err;
  if (nblocks == 0) return 0;
  if (grid < 1) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes)
    decode_lanes_kernel<<<grid, kThreads, smem, s>>>(a);
  else
    decode_generic_kernel<<<grid, kThreads, smem, s>>>(a);
  return int(cudaGetLastError());
}
