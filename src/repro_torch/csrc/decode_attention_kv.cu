// Flash-decoding attention over an ENEC-compressed bf16 KV prefix, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention_kv.py:
// decode_attention_kv_enec (body _kernel, which inlines
// enec_decode.decode_block_body for the K and V tiles).
//
// Layout (the reference's compress_kv_prefix): the prefix of K and of V
// is one ENEC block per (batch, kv_head, chunk of 128 tokens), 128 tokens
// x head_dim 128 = 16384 bf16 elements, streams (B, KV, C, width).  One
// (b, kv_head) pair attends with its GQA group of `grp` query heads.
//
// What bounds it on the H100: memory.  Per chunk it reads the K and V
// streams (~1/1.3 of 64 KB of bf16) and does 2 * grp * 128 * 128 FMAs per
// tile pair; at grp <= 8 that is < 10 FLOP a compressed byte, far below
// the card's ridge, so the bound is the compressed bytes.
//
// What the design does: one CTA of 512 threads per (b, kv_head) walks its
// chunks in order, as the TPU grid's sequential chunk axis did, keeping
// the online-softmax state (running max m, sum l, acc) in shared memory.
// Each chunk: stage the K block's streams and rank its anomalous groups
// (enec_block.cuh: load_block), decode it into a bf16 tile in shared
// memory, transposed with a padded row so that the score loop reads it
// without bank conflicts; scores = q . k * scale in f32, one per
// (query, token); one warp per query row updates (m, l) and turns the
// scores into probabilities; then the V block is decoded into the same
// tile (natural layout) and acc = acc * corr + p @ V.  The dense tile never
// leaves shared memory.  The reference's constants are kept: m starts at
// -1e30, the output is acc / max(l, 1e-30).  A simple kernel: 64 CTAs at
// B = 8, KV = 8 leave half of the 132 SMs idle and each walks 256 chunks
// in series; splitting the chunks across CTAs with a combine pass is left
// for a later PR.
#include <cuda_runtime.h>

#include "enec_block.cuh"

namespace {

constexpr int kTok = 128;
constexpr int kHd = 128;
constexpr int kKtStride = kTok + 2;   // padded row of the transposed K tile

struct Smem {
  uint16_t* tile;   // K as [hd][kKtStride], then V as [tok][hd]
  float *q, *sc, *acc, *m, *l, *corr;
  uint8_t* stage;

  __host__ __device__ static int tile_bytes() {
    return enec::align16(kHd * kKtStride * 2);
  }
  __host__ __device__ static int head_bytes(int grp) {
    return tile_bytes() + 3 * enec::align16(grp * kHd * 4) +
           3 * enec::align16(grp * 4);
  }
  __device__ Smem(uint8_t* base, int grp) {
    uint8_t* p = base;
    tile = reinterpret_cast<uint16_t*>(p);
    p += tile_bytes();
    q = reinterpret_cast<float*>(p);
    p += enec::align16(grp * kHd * 4);
    sc = reinterpret_cast<float*>(p);
    p += enec::align16(grp * kHd * 4);
    acc = reinterpret_cast<float*>(p);
    p += enec::align16(grp * kHd * 4);
    m = reinterpret_cast<float*>(p);
    p += enec::align16(grp * 4);
    l = reinterpret_cast<float*>(p);
    p += enec::align16(grp * 4);
    corr = reinterpret_cast<float*>(p);
    p += enec::align16(grp * 4);
    stage = p;
  }
};

__global__ void __launch_bounds__(enec::kThreads)
decode_attention_kv_kernel(const uint16_t* __restrict__ q,
                           const uint8_t* __restrict__ km,
                           const uint8_t* __restrict__ kl,
                           const uint8_t* __restrict__ kh,
                           const uint8_t* __restrict__ kr,
                           const uint8_t* __restrict__ vm,
                           const uint8_t* __restrict__ vl,
                           const uint8_t* __restrict__ vh,
                           const uint8_t* __restrict__ vr,
                           float* __restrict__ out, int grp, int n_chunks,
                           int b, int l, float scale, enec::Params P) {
  extern __shared__ __align__(16) uint8_t smem[];
  Smem sm(smem, grp);
  enec::Stage S(sm.stage, P);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rows = grp * kHd;   // == grp * kTok
  const size_t pair = blockIdx.x;   // b * KV + kv_head
  const uint16_t* qp = q + pair * rows;
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    sm.q[j] = __uint_as_float(uint32_t(qp[j]) << 16);
    sm.acc[j] = 0.f;
  }
  for (int g = threadIdx.x; g < grp; g += blockDim.x) {
    sm.m[g] = -1e30f;
    sm.l[g] = 0.f;
  }
  // visible to all threads after load_block's first __syncthreads
  for (int c = 0; c < n_chunks; ++c) {
    const size_t blk = pair * n_chunks + c;
    // K: decode into the tile transposed, element (t, h) at [h][t]
    enec::load_block(S, P, km, kl, kh, kr, blk);
    enec::decode_staged(S, P, b, l, [&](int i, uint32_t v) {
      sm.tile[(i & (kHd - 1)) * kKtStride + (i >> 7)] = uint16_t(v);
    });
    __syncthreads();
    for (int j = threadIdx.x; j < rows; j += blockDim.x) {
      const int g = j >> 7, t = j & (kTok - 1);
      const float* qg = sm.q + g * kHd;
      float s = 0.f;
      for (int h = 0; h < kHd; ++h)
        s = fmaf(qg[h],
                 __uint_as_float(uint32_t(sm.tile[h * kKtStride + t]) << 16),
                 s);
      sm.sc[j] = s * scale;
    }
    __syncthreads();
    // one warp per query row: running max, probabilities, running sum
    for (int g = warp; g < grp; g += nwarps) {
      float* row = sm.sc + g * kTok;
      float mx = -__int_as_float(0x7f800000);   // -inf
      for (int t = lane; t < kTok; t += 32) mx = fmaxf(mx, row[t]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm.m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kTok; t += 32) {
        const float p = expf(row[t] - m_new);
        row[t] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sm.corr[g] = corr;
        sm.l[g] = sm.l[g] * corr + sum;
        sm.m[g] = m_new;
      }
    }
    // V: decode into the tile, element (t, h) at [t][h]; load_block's
    // first __syncthreads orders it after the score loop's reads
    enec::load_block(S, P, vm, vl, vh, vr, blk);
    enec::decode_staged(S, P, b, l, [&](int i, uint32_t v) {
      sm.tile[i] = uint16_t(v);
    });
    __syncthreads();
    for (int j = threadIdx.x; j < rows; j += blockDim.x) {
      const int g = j >> 7, h = j & (kHd - 1);
      const float* pg = sm.sc + g * kTok;
      float a = 0.f;
      for (int t = 0; t < kTok; ++t)
        a = fmaf(pg[t], __uint_as_float(uint32_t(sm.tile[t * kHd + h]) << 16),
                 a);
      sm.acc[j] = sm.acc[j] * sm.corr[g] + a;
    }
    __syncthreads();
  }
  float* op = out + pair * rows;
  for (int j = threadIdx.x; j < rows; j += blockDim.x)
    op[j] = sm.acc[j] / fmaxf(sm.l[j >> 7], 1e-30f);
}

}  // namespace

// Attend q (pairs, grp, 128) bf16 over the ENEC K/V streams of `pairs`
// (b, kv_head) pairs of n_chunks blocks each -> out (pairs, grp, 128) f32;
// returns the cudaError_t of the launch.
extern "C" int decode_attention_kv_launch(
    const uint16_t* q, const uint8_t* km, const uint8_t* kl,
    const uint8_t* kh, const uint8_t* kr, const uint8_t* vm,
    const uint8_t* vl, const uint8_t* vh, const uint8_t* vr, float* out,
    int pairs, int grp, int n_chunks, int b, int l, int L, int n, int m,
    int w_mask, int w_low, int w_high, int w_raw, float scale, void* stream) {
  const enec::Params P{kTok * kHd, L, n, m, 16, 7,
                       w_mask, w_low, w_high, w_raw};
  const int smem = Smem::head_bytes(grp) + enec::Stage::bytes(P);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return int(err);
  if (pairs == 0) return 0;
  decode_attention_kv_kernel<<<pairs, enec::kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      q, km, kl, kh, kr, vm, vl, vh, vr, out, grp, n_chunks, b, l, scale, P);
  return int(cudaGetLastError());
}
