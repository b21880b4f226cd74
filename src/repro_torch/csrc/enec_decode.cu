// ENEC block decoder for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/enec_decode.py:
// decode_blocks_pallas (body decode_block_body, with _mask_to_bits,
// _exclusive_rank and _segment_gather).
//
// What bounds it on the H100: memory.  Per element it reads about
// (n + raw_bits)/8 compressed bytes (~1.1 B at bf16) and writes 2 (or 4)
// dense bytes, with a few dozen integer operations in between; at
// 3.35 TB/s the bytes take ~1 ns per thousand elements, far below what
// the integer pipes need, so the bound is bytes moved.
//
// What the design does about it: one CTA per block of N elements stages
// the block's mask/low/high/raw streams in shared memory with 16-byte
// loads (each compressed byte is read from device memory once), ranks the
// anomalous groups with ballot/popc and a warp scan (idd_scan.cuh, in
// place of the MXU triangular matmul), and then each thread decodes
// elements i = tid, tid + 512, ... so neighbouring threads write
// neighbouring outputs.  The halving layout is read through the closed-form
// map (enec_block.cuh: unpack_elem) instead of replaying the fold; the
// high bits of an anomalous group come from row rank[g] of the staged high
// stream, a direct shared-memory gather in place of the TPU's one-hot
// matmul.  (b, l) are per-block vectors, so blocks of tensors with
// different searched parameters decode in one launch.  A simple kernel:
// byte-wise shared loads and one element per thread step are left for a
// later tuning pass.
#include <cuda_runtime.h>

#include "enec_block.cuh"

namespace {

__global__ void __launch_bounds__(enec::kThreads)
enec_decode_kernel(const uint8_t* __restrict__ mask,
                   const uint8_t* __restrict__ low,
                   const uint8_t* __restrict__ high,
                   const uint8_t* __restrict__ raw,
                   const int* __restrict__ b_vec,
                   const int* __restrict__ l_vec, void* __restrict__ out,
                   enec::Params P) {
  extern __shared__ __align__(16) uint8_t smem[];
  enec::Stage S(smem, P);
  const size_t blk = blockIdx.x;
  enec::load_block(S, P, mask, low, high, raw, blk);
  const int b = b_vec[blk], l = l_vec[blk];
  if (P.total_bits == 16) {
    uint16_t* o = static_cast<uint16_t*>(out) + blk * P.n_elems;
    enec::decode_staged(S, P, b, l,
                        [&](int i, uint32_t v) { o[i] = uint16_t(v); });
  } else {
    uint32_t* o = static_cast<uint32_t*>(out) + blk * P.n_elems;
    enec::decode_staged(S, P, b, l, [&](int i, uint32_t v) { o[i] = v; });
  }
}

}  // namespace

// Decode `nblocks` blocks; returns the cudaError_t of the launch.
extern "C" int enec_decode_launch(const uint8_t* mask, const uint8_t* low,
                                  const uint8_t* high, const uint8_t* raw,
                                  const int* b_vec, const int* l_vec,
                                  void* out, int nblocks, int n_elems, int L,
                                  int n, int m, int total_bits, int mant_bits,
                                  int w_mask, int w_low, int w_high,
                                  int w_raw, void* stream) {
  const enec::Params P{n_elems, L, n, m, total_bits, mant_bits,
                       w_mask, w_low, w_high, w_raw};
  const int smem = enec::Stage::bytes(P);
  cudaError_t err = cudaFuncSetAttribute(
      enec_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  if (nblocks == 0) return 0;
  enec_decode_kernel<<<nblocks, enec::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      mask, low, high, raw, b_vec, l_vec, out, P);
  return int(cudaGetLastError());
}
