// Flash-decoding attention over an ENEC-compressed bf16 KV prefix, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention_kv.py:
// decode_attention_kv_enec (body _kernel, which inlines
// enec_decode.decode_block_body for the K and V tiles).
//
// Layout (the reference's compress_kv_prefix): the prefix of K and of V
// is one ENEC block per (batch, kv_head, chunk of 128 tokens), 128 tokens
// x head_dim 128 = 16384 bf16 elements, streams (B, KV, C, width), so the
// block of item (pair, chunk) is pair * C + chunk.  One (b, kv_head) pair
// attends with its GQA group of `grp` <= 16 query heads.
//
// What bounds it on the H100: memory, the compressed K and V streams (the
// dense tiles never leave shared memory); 2 * grp * 128 * 128 FMAs per
// chunk is < 10 FLOP a compressed byte.  In practice the block decode (a
// few dozen integer operations an element) sets the pace.
//
// What the design does about it:
// * Split-KV over the whole card (flash-decoding): the (pair, chunk) items
//   are cut into `grid` contiguous ranges, CTA c taking items
//   [c * I / grid, (c + 1) * I / grid) of I = pairs * C, on a grid sized by
//   the host planner (kernels/decode_attention_kv.py: plan) to the SM
//   count x resident CTAs per SM.  A range may start or end inside a pair.
//   A CTA walks its items in order with the online softmax (m from -1e30,
//   l, acc) and, at the end of each pair's segment, either writes the
//   output (it held the whole pair) or stores a partial (m, l, acc[grp][128]
//   in f32) in its own workspace slot (slot 0 for the first pair of its
//   range, 1 for the last) and counts one arrival on the pair's counter.
//   The CTA whose arrival completes the pair combines the partials of the
//   pair's CTAs in chunk order: m = max m_i, l = sum l_i e^(m_i - m), acc =
//   sum acc_i e^(m_i - m), o = acc / max(l, 1e-30); and resets the counter,
//   so the counters need no memset per call.  No float atomics: two calls
//   give the same bits.  The combine is a tail of one CTA per split pair
//   (a few partials of grp x 130 floats), so it runs in place, not as a
//   second kernel.
// * Asynchrony: the K and V streams of the CTA's items are copied by
//   cp.async.bulk on an mbarrier (cp.async / loads where a stream is not
//   16-byte aligned) into two stages, by the last warp alone: once every
//   warp is past item j - 1 (the barrier at the top of item j), item j +
//   1's copies go into its stage and land while item j is decoded and
//   multiplied.
// * Decode: the K and V blocks of an item in one pass, by lane groups of
//   the folded low stream, four lanes a thread (enec_block.cuh:
//   decode_staged_lanes_bf16), into bf16 tiles [tok][hd] with 272-byte
//   rows; each warp ranks the anomalous groups itself from the mask words
//   (lanes::WarpRank: no rank array, no barrier), and the high bits are
//   unpacked branch-free.  The decode has warp w write whole rows: tokens
//   w, w + 16, .., w + 112.
// * Products on the tensor cores, by the warp that decoded the rows, with
//   no block barrier between decode and products (one barrier an item, for
//   the staged streams): warp w keeps its own online softmax over its 8
//   tokens of every chunk (m, l per query; acc[128 hd][8 queries] in
//   registers).  scores = q K^T by mma.sync m16n8k16 (q the 16-row operand,
//   zero past grp; K^T the 8-wide one, the warp's rows; exact bf16
//   products); acc += V^T p^T by m16n8k8 (V^T from the warp's rows by
//   ldmatrix.trans; p^T straight from the scores' accumulator layout, split
//   exactly into three bf16 parts, hi + mid + lo == p in f32), so every
//   product is exact and only the order of the f32 sums differs from the
//   plain version.  At the end of a pair's segment the 16 warps' (m, l, acc)
//   are combined in warp order, through the then free tiles, as the CTA's
//   result or partial.  grp <= 8 runs one block of 8 queries, 9..16 two.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "enec_block.cuh"
#include "ptx.cuh"

namespace {

using namespace ptx;

constexpr int kTok = 128;
constexpr int kHd = 128;
constexpr int kBlock = kTok * kHd;
constexpr int kRow = 136;        // halfwords a shared tile / q row
// Halfword offset of token row t in a tile: 272-byte rows, and 16 more
// bytes every 16 rows, so that a warp's rows t, t + 16, .. + 112 start in
// eight different 16-byte bank groups.
__host__ __device__ constexpr int tile_row(int t) {
  return t * kRow + (t >> 4) * 8;
}
constexpr int kTileHalfs = tile_row(kTok);
constexpr int kThreads = 512;    // 16 warps; warp w decodes and multiplies
                                 // the tokens w, w + 16, .. of each chunk
constexpr int kMaxGrp = 16;
constexpr int kStages = 2;
// one warp's share at a segment end: m[8], l[8], acc[8 queries][128]
constexpr int kRed = 16 + 8 * kHd;

struct Args {
  const uint16_t* q;
  const uint8_t *km, *kl, *kh, *kr, *vm, *vl, *vh, *vr;
  float* out;
  float* ws;        // 2 partials a CTA of grp * (kHd + 2) floats
  int* counters;    // one a pair, 0 between launches
  int pairs, grp, n_chunks, b, l;
  float scale;
  enec::Params P;
};

// Byte offsets of the shared regions.  At a segment end the tiles are
// free and hold the warps' shares (16 x kRed floats <= 2 tiles).
struct Layout {
  int k_tile, v_tile, q, stat, stage, stage_bytes, v_off, bars, total;
};

__host__ __device__ inline int streams_bytes(const enec::Params& P) {
  using enec::align16;
  return align16(P.w_mask) + align16(P.w_low) + align16(P.w_high) +
         align16(P.w_raw);
}

__host__ __device__ inline Layout make_layout(const enec::Params& P) {
  Layout L;
  const int tile = kTileHalfs * 2;
  L.k_tile = 0;
  L.v_tile = tile;
  L.q = 2 * tile;                      // 16 query rows, zeros past grp
  L.stat = L.q + 16 * kRow * 2;        // the combine flag
  L.stage = L.stat + 16;
  L.v_off = streams_bytes(P);
  L.stage_bytes = 2 * L.v_off;
  L.bars = L.stage + kStages * L.stage_bytes;
  L.total = L.bars + 8 * kStages;
  return L;
}

// d += a (16x8, row) * b (8x8, col), bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// p as three bf16 parts, hi + mid + lo == p exactly in f32.
__device__ __forceinline__ void split3(float p, uint16_t (&part)[3]) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(p);
  const float r1 = p - __bfloat162float(hi);
  const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
  const __nv_bfloat16 lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
  part[0] = __bfloat16_as_ushort(hi);
  part[1] = __bfloat16_as_ushort(mid);
  part[2] = __bfloat16_as_ushort(lo);
}

// The CTA whose range holds item i, for ranges [c * I / G, (c+1) * I / G).
__device__ __forceinline__ int cta_of(long long i, long long items, int grid) {
  return int(((i + 1) * grid + items - 1) / items) - 1;
}

// NQB query blocks of 8 (grp <= 8 * NQB).
template <int NQB>
__global__ void __launch_bounds__(kThreads, 1)
decode_attention_kv_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const enec::Params& P = a.P;
  const Layout L = make_layout(P);
  uint16_t* kt = reinterpret_cast<uint16_t*>(smem + L.k_tile);
  uint16_t* vt = reinterpret_cast<uint16_t*>(smem + L.v_tile);
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem + L.q);
  int* flag_s = reinterpret_cast<int*>(smem + L.stat);
  float* red = reinterpret_cast<float*>(smem + L.k_tile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;      // mma fragment coordinates
  const int mi = lane >> 3, rr = lane & 7;      // ldmatrix row provider
  const int C = a.n_chunks, grp = a.grp;
  const long long items = (long long)a.pairs * C;
  const long long s0 = items * blockIdx.x / gridDim.x;
  const int count = int(items * (blockIdx.x + 1) / gridDim.x - s0);
  const int first_pair = int(s0 / C);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = grp * kHd + tid; e < 16 * kHd; e += kThreads)
    qs[(e >> 7) * kRow + (e & 127)] = 0;   // queries past grp: zeros
  __syncthreads();

  // item j's streams into stage j % 2, staged by the last warp alone (the
  // bulk copies issued by its first thread): the others never run this
  constexpr int kIssuer = kThreads - 32;
  const bool stager = tid >= kIssuer;
  auto prefetch = [&](int j) {
    if (j < count) {
      const size_t blk = size_t(s0 + j);
      uint8_t* st = smem + L.stage + (j % kStages) * L.stage_bytes;
      enec::Stage SK(st, P), SV(st + L.v_off, P);
      uint64_t* bar = &bars[j % kStages];
      if (tid == kIssuer)
        mbar_expect_tx(bar, bulk_bytes(a.km, P.w_mask) +
                                bulk_bytes(a.kl, P.w_low) +
                                bulk_bytes(a.kh, P.w_high) +
                                bulk_bytes(a.kr, P.w_raw) +
                                bulk_bytes(a.vm, P.w_mask) +
                                bulk_bytes(a.vl, P.w_low) +
                                bulk_bytes(a.vh, P.w_high) +
                                bulk_bytes(a.vr, P.w_raw));
      stage_stream(SK.mask, a.km, P.w_mask, blk, bar, kIssuer, lane, 32);
      stage_stream(SK.low, a.kl, P.w_low, blk, bar, kIssuer, lane, 32);
      stage_stream(SK.high, a.kh, P.w_high, blk, bar, kIssuer, lane, 32);
      stage_stream(SK.raw, a.kr, P.w_raw, blk, bar, kIssuer, lane, 32);
      stage_stream(SV.mask, a.vm, P.w_mask, blk, bar, kIssuer, lane, 32);
      stage_stream(SV.low, a.vl, P.w_low, blk, bar, kIssuer, lane, 32);
      stage_stream(SV.high, a.vh, P.w_high, blk, bar, kIssuer, lane, 32);
      stage_stream(SV.raw, a.vr, P.w_raw, blk, bar, kIssuer, lane, 32);
    }
    cp_async_commit();   // one group per item, empty past the end
  };

  // This warp's tokens of every chunk: w + 16 k, k < 8 -- the rows the
  // decode below has this warp write.  Its online softmax over them, per
  // query: running max and sum for queries g8 + 8 qb (the scores' d rows),
  // and acc[hd][query] as the p @ V d fragments (hd (ht * 16 + g8 (+8)),
  // queries 2 t4 (+1) + 8 qb).
  float m_run[NQB], l_run[NQB], acc[NQB][8][4];
  int seg_chunk0 = int(s0 % C);   // first chunk of the current segment
  const uint16_t* k_row = kt + tile_row(warp + 16 * g8);  // token of b cols

  if (stager) prefetch(0);
  for (int j = 0; j < count; ++j) {
    const long long item = s0 + j;
    const int pair = int(item / C), chunk = int(item % C);
    uint8_t* st = smem + L.stage + (j % kStages) * L.stage_bytes;
    cp_async_wait<0>();
    mbar_wait(&bars[j % kStages], (j / kStages) & 1);
    __syncthreads();
    if (stager) prefetch(j + 1);   // every warp is done with stage j - 1

    if (j == 0 || chunk == 0) {   // a new pair's segment
      seg_chunk0 = chunk;
      const uint16_t* qp = a.q + size_t(pair) * grp * kHd;
      for (int e = tid; e < grp * kHd; e += kThreads)
        qs[(e >> 7) * kRow + (e & 127)] = qp[e];
#pragma unroll
      for (int qb = 0; qb < NQB; ++qb) {
        m_run[qb] = -1e30f;
        l_run[qb] = 0.f;
#pragma unroll
        for (int ht = 0; ht < 8; ++ht)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[qb][ht][e] = 0.f;
      }
      __syncthreads();   // q in place for every warp
    }

    // decode the K and V blocks together; warp w writes tokens w + 16 k of
    // both tiles, so its products below need no block barrier; each warp
    // ranks the anomalous groups itself
    const enec::Stage S[2] = {enec::Stage(st, P),
                              enec::Stage(st + L.v_off, P)};
    enec::lanes::WarpRank rk[2];
    rk[0].load(S[0].mask, P.n_elems / P.L);
    rk[1].load(S[1].mask, P.n_elems / P.L);
    enec::decode_staged_lanes_bf16<kBlock>(
        S, P, a.b, a.l,
        [&](int kv, int g, int& r) { return rk[kv].at(g, r); },
        [&](int kv, int i0, uint32_t lo, uint32_t hi) {
          *reinterpret_cast<uint2*>((kv ? vt : kt) + tile_row(i0 >> 7) +
                                    (i0 & 127)) = make_uint2(lo, hi);
        });
    __syncwarp();

    // scores[query][token] = scale * q K^T over the warp's 8 tokens:
    // q the 16-row operand (zeros past grp), K^T the 8-wide one
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < kHd / 16; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, qs + ((mi & 1) * 8 + rr) * kRow + ks * 16 +
                          (mi >> 1) * 8, false);
      const uint16_t* kr = k_row + ks * 16 + 2 * t4;
      mma_bf16(sc, af, *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 8));
    }
    // per query g8 + 8 qb: the max and the sum over the warp's 8 tokens
    // (the 4 lanes of one g8), p = exp(s - m) as the b fragment of p @ V
    // (tokens 2 t4, 2 t4 + 1 of query g8 + 8 qb: the d layout of the
    // scores), in three exact bf16 parts
    uint32_t bp[NQB][3];
    float corr_q[NQB];
#pragma unroll
    for (int qb = 0; qb < NQB; ++qb) {
      const float s0v = sc[2 * qb] * a.scale, s1v = sc[2 * qb + 1] * a.scale;
      float mx = fmaxf(s0v, s1v);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[qb], mx);
      const float p0 = expf(s0v - m_new), p1 = expf(s1v - m_new);
      float sum = p0 + p1;
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      corr_q[qb] = expf(m_run[qb] - m_new);
      l_run[qb] = l_run[qb] * corr_q[qb] + sum;
      m_run[qb] = m_new;
      uint16_t h0[3], h1[3];
      split3(p0, h0);
      split3(p1, h1);
#pragma unroll
      for (int part = 0; part < 3; ++part)
        bp[qb][part] = uint32_t(h0[part]) | (uint32_t(h1[part]) << 16);
    }
    // acc = acc * corr + V^T p^T: V^T (16 hd x 8 tokens) by ldmatrix.trans
    // of the warp's V rows, two hd tiles a load; the corrections of queries
    // 2 t4, 2 t4 + 1 come from the lanes that hold them
#pragma unroll
    for (int qb = 0; qb < NQB; ++qb) {
      const float c0 = __shfl_sync(0xffffffffu, corr_q[qb], 8 * t4);
      const float c1 = __shfl_sync(0xffffffffu, corr_q[qb], 8 * t4 + 4);
#pragma unroll
      for (int ht = 0; ht < 8; ++ht)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[qb][ht][e] *= (e & 1) ? c1 : c0;
    }
#pragma unroll
    for (int ht = 0; ht < 8; ht += 2) {
      uint32_t av[4];
      ldmatrix_x4(av, vt + tile_row(warp + 16 * rr) + ht * 16 + mi * 8, true);
#pragma unroll
      for (int qb = 0; qb < NQB; ++qb)
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          mma_bf16_k8(acc[qb][ht], av[0], av[1], bp[qb][part]);
          mma_bf16_k8(acc[qb][ht + 1], av[2], av[3], bp[qb][part]);
        }
    }

    if (j == count - 1 || chunk == C - 1) {   // the pair's segment ends
      const bool whole = seg_chunk0 == 0 && chunk == C - 1;
      const int per = grp * (kHd + 2);
      float* part = a.ws + (size_t(blockIdx.x) * 2 +
                            (pair == first_pair ? 0 : 1)) * per;
      // the 16 warps' shares of each block of 8 queries, through the free
      // tiles, combined in warp order into the CTA's (m, l, acc)
#pragma unroll
      for (int qb = 0; qb < NQB; ++qb) {
        __syncthreads();   // the tiles are free (or this pass's reads done)
        float* r = red + warp * kRed;
        if (t4 == 0) {
          r[g8] = m_run[qb];
          r[8 + g8] = l_run[qb];
        }
#pragma unroll
        for (int ht = 0; ht < 8; ++ht)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            r[16 + (2 * t4 + (e & 1)) * kHd + ht * 16 + g8 + (e >> 1) * 8] =
                acc[qb][ht][e];
        __syncthreads();
        for (int e = tid; e < 8 * kHd; e += kThreads) {
          const int qi = qb * 8 + (e >> 7), h = e & 127;
          if (qi >= grp) break;
          float m = -__int_as_float(0x7f800000);
#pragma unroll
          for (int w = 0; w < 16; ++w) m = fmaxf(m, red[w * kRed + (e >> 7)]);
          float l = 0.f, o = 0.f;
#pragma unroll
          for (int w = 0; w < 16; ++w) {
            const float* rw = red + w * kRed;
            const float f = expf(rw[e >> 7] - m);
            l = l + rw[8 + (e >> 7)] * f;
            o = o + rw[16 + e] * f;
          }
          if (whole) {   // this CTA held the whole pair
            a.out[(size_t(pair) * grp + qi) * kHd + h] = o / fmaxf(l, 1e-30f);
          } else {       // a partial: m[grp], l[grp], acc[grp][128]
            if (h == 0) {
              part[qi] = m;
              part[grp + qi] = l;
            }
            part[2 * grp + qi * kHd + h] = o;
          }
        }
      }
      if (!whole) {
        __threadfence();
        __syncthreads();
        const int c_lo = cta_of((long long)pair * C, items, gridDim.x);
        const int c_hi = cta_of((long long)pair * C + C - 1, items, gridDim.x);
        if (tid == 0) {
          const bool last =
              atomicAdd(&a.counters[pair], 1) == c_hi - c_lo;
          if (last) __threadfence();
          *flag_s = last;
        }
        __syncthreads();
        if (*flag_s) {
          // the pair's partials in chunk (= CTA) order
          for (int e = tid; e < grp * kHd; e += kThreads) {
            const int qi = e >> 7;
            float m = -__int_as_float(0x7f800000);
            for (int c = c_lo; c <= c_hi; ++c) {
              const int slot =
                  (pair == int((items * c / gridDim.x) / C)) ? 0 : 1;
              m = fmaxf(m, __ldcg(a.ws + (size_t(c) * 2 + slot) * per + qi));
            }
            float l = 0.f, o = 0.f;
            for (int c = c_lo; c <= c_hi; ++c) {
              const int slot =
                  (pair == int((items * c / gridDim.x) / C)) ? 0 : 1;
              const float* pc = a.ws + (size_t(c) * 2 + slot) * per;
              const float w = expf(__ldcg(pc + qi) - m);
              l = l + __ldcg(pc + grp + qi) * w;
              o = o + __ldcg(pc + 2 * grp + e) * w;
            }
            a.out[size_t(pair) * grp * kHd + e] = o / fmaxf(l, 1e-30f);
          }
          if (tid == 0) a.counters[pair] = 0;
        }
      }
    }
  }
}

// Per device and instantiation (NQB - 1): the SM count, and the
// shared-memory size last opted into with its resident CTAs per SM.
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
int g_smem[kMaxDevices][2], g_per_sm[kMaxDevices][2];

template <int NQB>
int prepare(const enec::Params& P, int* smem_out, int* per_sm_out,
            int* sms_out) {
  auto kern = decode_attention_kv_kernel<NQB>;
  const int smem = make_layout(P).total;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return int(err);
  }
  if (g_smem[dev][NQB - 1] != smem) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &g_per_sm[dev][NQB - 1], kern, kThreads, smem);
    if (err != cudaSuccess) return int(err);
    if (g_per_sm[dev][NQB - 1] == 0) return int(cudaErrorInvalidConfiguration);
    g_smem[dev][NQB - 1] = smem;
  }
  *smem_out = smem;
  *per_sm_out = g_per_sm[dev][NQB - 1];
  *sms_out = g_sms[dev];
  return 0;
}

int prepare_for(const enec::Params& P, int grp, int* smem, int* per_sm,
                int* sms) {
  return grp > 8 ? prepare<2>(P, smem, per_sm, sms)
                 : prepare<1>(P, smem, per_sm, sms);
}

enec::Params params_of(int L, int n, int m, int w_mask, int w_low,
                       int w_high, int w_raw) {
  return enec::Params{kBlock, L, n, m, 16, 7, w_mask, w_low, w_high, w_raw};
}

}  // namespace

// The launch resources of one configuration on the current device:
// out = {dynamic shared bytes, resident CTAs per SM, SM count}; returns
// the cudaError_t of the queries.
extern "C" int decode_attention_kv_resources(int grp, int L, int n, int m,
                                             int w_mask, int w_low,
                                             int w_high, int w_raw,
                                             int* out) {
  if (grp < 1 || grp > kMaxGrp) return int(cudaErrorInvalidValue);
  return prepare_for(params_of(L, n, m, w_mask, w_low, w_high, w_raw), grp,
                     &out[0], &out[1], &out[2]);
}

// Attend q (pairs, grp, 128) bf16 over the ENEC K/V streams of `pairs`
// (b, kv_head) pairs of n_chunks blocks each -> out (pairs, grp, 128) f32,
// on `grid` CTAs (the host's plan: at most pairs * n_chunks); ws holds 2 *
// grid * grp * 130 floats, counters `pairs` ints at 0.  Returns the
// cudaError_t of the launch.
extern "C" int decode_attention_kv_launch(
    const uint16_t* q, const uint8_t* km, const uint8_t* kl,
    const uint8_t* kh, const uint8_t* kr, const uint8_t* vm,
    const uint8_t* vl, const uint8_t* vh, const uint8_t* vr, float* out,
    float* ws, int* counters, int pairs, int grp, int n_chunks, int grid,
    int b, int l, int L, int n, int m, int w_mask, int w_low, int w_high,
    int w_raw, float scale, void* stream) {
  if (grp < 1 || grp > kMaxGrp) return int(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.km = km; a.kl = kl; a.kh = kh; a.kr = kr;
  a.vm = vm; a.vl = vl; a.vh = vh; a.vr = vr;
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.pairs = pairs;
  a.grp = grp;
  a.n_chunks = n_chunks;
  a.b = b;
  a.l = l;
  a.scale = scale;
  a.P = params_of(L, n, m, w_mask, w_low, w_high, w_raw);
  int smem, per_sm, sms;
  const int err = prepare_for(a.P, grp, &smem, &per_sm, &sms);
  if (err) return err;
  if (pairs == 0 || n_chunks == 0) return 0;
  if (grid < 1 || (long long)grid > (long long)pairs * n_chunks)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grp > 8)
    decode_attention_kv_kernel<2><<<grid, kThreads, smem, s>>>(a);
  else
    decode_attention_kv_kernel<1><<<grid, kThreads, smem, s>>>(a);
  return int(cudaGetLastError());
}
