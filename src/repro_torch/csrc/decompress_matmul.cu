// Fused ENEC decode + matmul for Hopper (sm_90a), with a dense-tile entry.
//
// Replaces the TPU kernel src/repro/kernels/decompress_matmul.py:
// decompress_matmul (body _fused_kernel): out (M, N) f32 = x (M, K) @ W,
// where W exists only as 128x128 tile streams, one ENEC block per tile,
// n-major (t = n_tile * k_tiles + k_tile).
//
// What bounds it on the H100: at decode batch (M = 1..4) memory — the
// compressed weight bytes dominate, and the point of the kernel is that
// only those cross device memory (the dense weight never exists there);
// 2*M*K*N flops are far below the line.  At prefill (M = batch*prompt)
// the f32 FMAs grow with M and the bound moves towards operations.
//
// What the design does about it: one CTA per 128-wide output strip walks
// its k tiles in order.  Each step stages the tile's streams in shared
// memory and decodes them with the ENEC decoder's device code
// (enec_block.cuh) into a 128x128 f32 tile in shared memory (66 KB with
// row padding, dynamic shared memory), then every thread accumulates a column of
// x[:, k-tile] @ tile for 8 rows of a 32-row x chunk in f32 registers with
// fmaf, k in a fixed order, and adds the tile's partial product to the
// output strip.  No atomics and no split-K, so the sum's order is fixed and
// the result deterministic; no TF32 anywhere.  The dense-tile entry runs
// the same accumulation on tiles loaded from a dense (K, N) weight (any
// strides), so dense, stream and fused serving give bitwise-equal logits.
// Known cost of this simple design: a 2048x2048 weight has 16 strips, so
// 16 of the 132 SMs work; wgmma, TMA and split scheduling are later work.
#include <cuda_runtime.h>

#include "enec_block.cuh"

namespace {

constexpr int kTile = 128;
// shared tile row stride: one float of padding lets the dense-tile entry
// fill a transposed (stride_k == 1) weight column-wise without bank
// conflicts, while the accumulation reads rows conflict-free either way
constexpr int kWStride = kTile + 1;
constexpr int kXRows = 32;                       // x rows staged per pass
constexpr int kSlots = enec::kThreads / kTile;   // row slots per pass
constexpr int kRowsPerThread = kXRows / kSlots;

__device__ __forceinline__ float load_x(const void* x, int x_bf16,
                                        size_t idx) {
  if (x_bf16)
    return __uint_as_float(uint32_t(static_cast<const uint16_t*>(x)[idx]) << 16);
  return static_cast<const float*>(x)[idx];
}

// out[:, n0:n0+128] (+)= x[:, k0:k0+128] @ w_s, one f32 partial per tile.
__device__ __forceinline__ void accumulate_tile(const float* w_s, float* x_s,
                                                const void* x, int x_bf16,
                                                float* out, int M, int K,
                                                int N, int k0, int n0,
                                                bool first) {
  const int c = threadIdx.x % kTile;
  const int slot = threadIdx.x / kTile;
  for (int r0 = 0; r0 < M; r0 += kXRows) {
    const int rows = min(kXRows, M - r0);
    for (int e = threadIdx.x; e < kXRows * kTile; e += blockDim.x) {
      const int r = e / kTile, kg = k0 + e % kTile;
      x_s[e] = (r < rows && kg < K)
                   ? load_x(x, x_bf16, size_t(r0 + r) * K + kg) : 0.f;
    }
    __syncthreads();
    float part[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) part[j] = 0.f;
    for (int kk = 0; kk < kTile; ++kk) {
      const float w = w_s[kk * kWStride + c];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j)
        part[j] = fmaf(x_s[(slot + kSlots * j) * kTile + kk], w, part[j]);
    }
    const int ng = n0 + c;
    if (ng < N) {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int r = slot + kSlots * j;
        if (r < rows) {
          float* o = out + size_t(r0 + r) * N + ng;
          *o = first ? part[j] : *o + part[j];
        }
      }
    }
    __syncthreads();   // x_s is restaged by the next pass
  }
}

__global__ void __launch_bounds__(enec::kThreads)
fused_matmul_kernel(const void* __restrict__ x, int x_bf16,
                    const uint8_t* __restrict__ mask,
                    const uint8_t* __restrict__ low,
                    const uint8_t* __restrict__ high,
                    const uint8_t* __restrict__ raw, int b, int l,
                    enec::Params P, float* __restrict__ out, int M, int K,
                    int N, int k_tiles) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* w_s = reinterpret_cast<float*>(smem);
  float* x_s = w_s + kTile * kWStride;
  enec::Stage S(reinterpret_cast<uint8_t*>(x_s + kXRows * kTile), P);
  const int n_tile = blockIdx.x;
  for (int kt = 0; kt < k_tiles; ++kt) {
    enec::load_block(S, P, mask, low, high, raw,
                     size_t(n_tile) * k_tiles + kt);
    enec::decode_staged(S, P, b, l, [&](int i, uint32_t v) {
      w_s[(i / kTile) * kWStride + i % kTile] =
          enec::bits_to_float(v, P.mant_bits);
    });
    __syncthreads();
    accumulate_tile(w_s, x_s, x, x_bf16, out, M, K, N, kt * kTile,
                    n_tile * kTile, kt == 0);
  }
}

// w_fmt: 0 bf16, 1 fp16, 2 fp32; strides in elements.
__global__ void __launch_bounds__(enec::kThreads)
dense_tile_matmul_kernel(const void* __restrict__ x, int x_bf16,
                         const void* __restrict__ w, int w_fmt,
                         long long stride_k, long long stride_n,
                         float* __restrict__ out, int M, int K, int N,
                         int k_tiles) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* w_s = reinterpret_cast<float*>(smem);
  float* x_s = w_s + kTile * kWStride;
  const int n0 = blockIdx.x * kTile;
  const int mant_bits = w_fmt == 0 ? 7 : (w_fmt == 1 ? 10 : 23);
  // neighbouring threads walk the weight's unit-stride dim (coalesced)
  const bool k_major = stride_k == 1 && stride_n != 1;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * kTile;
    for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
      const int kk = k_major ? i % kTile : i / kTile;
      const int nn = k_major ? i / kTile : i % kTile;
      const int kg = k0 + kk, ng = n0 + nn;
      float v = 0.f;
      if (kg < K && ng < N) {
        const long long idx = kg * stride_k + ng * stride_n;
        const uint32_t bits =
            w_fmt == 2 ? static_cast<const uint32_t*>(w)[idx]
                       : uint32_t(static_cast<const uint16_t*>(w)[idx]);
        v = enec::bits_to_float(bits, mant_bits);
      }
      w_s[kk * kWStride + nn] = v;
    }
    __syncthreads();
    accumulate_tile(w_s, x_s, x, x_bf16, out, M, K, N, k0, n0, kt == 0);
  }
}

constexpr int kMatmulSmem = (kTile * kWStride + kXRows * kTile) * 4;

}  // namespace

// Fused entry: W as (k_tiles * n_tiles) tile blocks with params (b, l).
extern "C" int decompress_matmul_launch(
    const void* x, int x_bf16, const uint8_t* mask, const uint8_t* low,
    const uint8_t* high, const uint8_t* raw, int b, int l, int L, int n,
    int m, int total_bits, int mant_bits, int w_mask, int w_low, int w_high,
    int w_raw, float* out, int M, int K, int N, void* stream) {
  const enec::Params P{kTile * kTile, L, n, m, total_bits, mant_bits,
                       w_mask, w_low, w_high, w_raw};
  const int smem = kMatmulSmem + enec::Stage::bytes(P);
  cudaError_t err = cudaFuncSetAttribute(
      fused_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const int k_tiles = (K + kTile - 1) / kTile;
  const int n_tiles = (N + kTile - 1) / kTile;
  if (M == 0 || n_tiles == 0) return 0;
  fused_matmul_kernel<<<n_tiles, enec::kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, mask, low, high, raw, b, l, P, out, M, K, N, k_tiles);
  return int(cudaGetLastError());
}

// Dense-tile entry: the same accumulation over a dense (K, N) weight.
extern "C" int dense_tile_matmul_launch(const void* x, int x_bf16,
                                        const void* w, int w_fmt,
                                        long long stride_k,
                                        long long stride_n, float* out,
                                        int M, int K, int N, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dense_tile_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMatmulSmem);
  if (err != cudaSuccess) return int(err);
  const int k_tiles = (K + kTile - 1) / kTile;
  const int n_tiles = (N + kTile - 1) / kTile;
  if (M == 0 || n_tiles == 0) return 0;
  dense_tile_matmul_kernel<<<n_tiles, enec::kThreads, kMatmulSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, w, w_fmt, stride_k, stride_n, out, M, K, N, k_tiles);
  return int(cudaGetLastError());
}
