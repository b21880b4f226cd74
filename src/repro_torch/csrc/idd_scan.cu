// Standalone batched inclusive prefix sum for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/idd_scan.py: idd_scan (body
// _idd_scan_kernel over scan_2d), which sums each row of 128 lanes with a
// triangular matmul on the MXU and then scans the row totals log-step.
// Its entry point is repro.kernels.ops.idd_scan; here it is
// kernels/ops.py:idd_scan.  (The exclusive rank that the codec kernels
// inline is the device function idd_scan.cuh, over mask bits; this kernel
// scans int32 values.)
//
// What bounds it on the H100: memory.  Per element it reads 4 bytes (1
// for bool input) and writes 4, with one add; at 3.35 TB/s the bytes set
// the time by far.
//
// What the design does: one CTA of 1024 threads per row walks the row in
// chunks of 4096 elements.  A chunk is loaded coalesced into shared
// memory, each thread scans its 4 consecutive values in registers, a warp
// scan with shuffles and one more over the 32 warp totals give each
// thread its offset, and a running carry crosses chunks.  The result is
// written back through shared memory, coalesced.  Sums are unsigned, so
// they wrap mod 2**32 like torch.cumsum's int32 sum, and the result is
// bitwise equal to it.  A simple kernel: a row longer than one chunk is
// scanned by one CTA in series (a decoupled look-back across CTAs is
// left for a later pass).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;
constexpr int kChunk = kThreads * kItems;

template <typename T>
__global__ void __launch_bounds__(kThreads)
idd_scan_kernel(const T* __restrict__ x, int32_t* __restrict__ out, int n) {
  __shared__ uint32_t buf[kChunk];
  __shared__ uint32_t warp_tot[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* row = x + size_t(blockIdx.x) * n;
  int32_t* orow = out + size_t(blockIdx.x) * n;
  uint32_t carry = 0;
  for (int base = 0; base < n; base += kChunk) {
    const int len = min(kChunk, n - base);
    for (int k = threadIdx.x; k < kChunk; k += kThreads)
      buf[k] = k < len ? uint32_t(row[base + k]) : 0u;
    __syncthreads();
    uint32_t v[kItems];
    uint32_t sum = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      sum += buf[threadIdx.x * kItems + j];
      v[j] = sum;
    }
    // inclusive scan of the thread totals inside the warp
    uint32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      uint32_t w = warp_tot[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += t;
      }
      warp_tot[lane] = w;   // inclusive over warps
    }
    __syncthreads();
    const uint32_t off =
        carry + (warp ? warp_tot[warp - 1] : 0u) + (incl - sum);
#pragma unroll
    for (int j = 0; j < kItems; ++j) buf[threadIdx.x * kItems + j] = off + v[j];
    carry += warp_tot[31];
    __syncthreads();
    for (int k = threadIdx.x; k < len; k += kThreads)
      orow[base + k] = int32_t(buf[k]);
    __syncthreads();   // buf and warp_tot are rewritten by the next chunk
  }
}

}  // namespace

// Scan `rows` rows of n values (int32 when is_bool == 0, else one byte
// each); returns the cudaError_t of the launch.
extern "C" int idd_scan_launch(const void* x, int is_bool, int32_t* out,
                               int rows, int n, void* stream) {
  if (rows == 0 || n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bool)
    idd_scan_kernel<uint8_t><<<rows, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(x), out, n);
  else
    idd_scan_kernel<int32_t><<<rows, kThreads, 0, s>>>(
        static_cast<const int32_t*>(x), out, n);
  return int(cudaGetLastError());
}
