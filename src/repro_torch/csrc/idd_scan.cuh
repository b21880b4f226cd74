// Exclusive rank of the per-group anomaly bits of one ENEC block, as a
// block-wide device function.
//
// Replaces the scan inside the TPU kernels: src/repro/kernels/idd_scan.py
// (scan_2d, inlined by enec_decode._exclusive_rank), which sums on the MXU
// with a triangular matmul per 128 lanes plus a log-step row scan.  On
// Hopper a warp has the primitive directly: __ballot_sync gathers 32 bits,
// __popc of the bits below a lane gives its rank inside the warp, one warp
// scans the per-warp totals with shuffles, and a running carry crosses
// chunks of blockDim.x groups.  G <= 1024 groups per block, so this costs
// a few hundred cycles next to the block's decode.
#pragma once
#include <cstdint>

// rank_s[g] = number of anomalous groups before g, for g < G.
// mask_s: G/8 bytes, little-endian bits.  warp_tot: 32 ints of scratch.
// Every thread of the block must call it (it synchronises the block).
__device__ __forceinline__ void block_exclusive_rank(const uint8_t* mask_s,
                                                     int G, int* rank_s,
                                                     int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int carry = 0;
  for (int base = 0; base < G; base += blockDim.x) {
    const int g = base + threadIdx.x;
    const int bit = g < G ? (mask_s[g >> 3] >> (g & 7)) & 1 : 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, bit);
    const int in_warp = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      int v = lane < nwarps ? warp_tot[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
      }
      if (lane < nwarps) warp_tot[lane] = v;   // inclusive over warps
    }
    __syncthreads();
    if (g < G) rank_s[g] = carry + (warp ? warp_tot[warp - 1] : 0) + in_warp;
    carry += warp_tot[nwarps - 1];
    __syncthreads();   // warp_tot is rewritten by the next chunk
  }
}
