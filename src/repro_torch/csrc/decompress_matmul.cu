// Fused ENEC decode + matmul for Hopper (sm_90a), with a dense-tile entry.
//
// Replaces the TPU kernel src/repro/kernels/decompress_matmul.py:
// decompress_matmul (body _fused_kernel): out (M, N) f32 = x (M, K) @ W,
// where W exists only as 128x128 tile streams, one ENEC block per tile,
// n-major (t = n_tile * k_tiles + k_tile).  The dense-tile entry computes
// the same function from a dense (K, N) weight of any strides (it stands
// in for the plain src/repro/kernels/ref.py: tiled_matmul_ref).
//
// The numeric contract (the TPU grid's, and kernels/ref.py's): one f32
// partial product per 128x128 tile, added to its strip's sum in k order
// (acc = p0; acc = acc + p1; ...).  Dense, stream and fused serving give
// bitwise-equal logits because both entries run the same device functions
// for the tile product (tile_partial) and for that sum; only the source of
// a tile's bits differs (decoded from an ENEC block, or copied from W).
//
// What bounds it on the H100: at decode batch (M <= 16) memory -- the
// compressed bytes of W (the dense weight never exists in device memory),
// 2*M*K*N operations being far below the line; in practice the decode of
// the streams (a few dozen integer operations an element) sets the pace.
// At prefill M (batch * prompt) the operations grow with M and the bound
// moves towards the tensor cores.
//
// What the design does about it:
// * Schedule, chosen by the caller (kernels/decompress_matmul.py: plan
//   passes a workspace for M <= 16, none above):
//   - With a workspace (decode batches; M <= kRows): ordered split-K.
//     Every (n_tile, k_tile) tile of the leaf is in flight at once, on a
//     grid of (SM count queried at run time) x (resident CTAs per SM)
//     CTAs, CTA c walking tiles c, c + grid, ...  Each tile's f32 partial
//     for all M rows goes to a workspace of k_tiles * n_tiles * M * 128
//     floats.  When its walk is done a CTA counts one arrival per tile on
//     per-strip counters (after a __threadfence); the CTA that brings a
//     strip's count to k_tiles sums that strip's partials in k order,
//     writes out and resets the counter to 0, so the counters need no
//     memset per call.
//   - Without one (prefill): one CTA per (strip, 32 rows) walks the
//     strip's k tiles in order and keeps the sum in registers, so no
//     workspace grows with the prompt (the fused entry decodes each tile
//     once per 32 rows).
//   Same partials, same order: the bits of a row depend neither on the
//   branch, nor on M, nor on the SM count.
// * Shared memory: a decoded tile is held as its 16-bit patterns (bf16 /
//   fp16, 34 KB with a 272-byte row; 32-bit only for fp32 weights); x is
//   staged only as deep as M (rounded up to 8, the MMA width; 32 rows in
//   the serial branch).  512 threads a CTA, two CTAs resident per SM at bf16
//   and M <= 8 (see the ptxas line and matmul_last_plan).
// * Asynchrony: the streams of the CTA's next tile are copied with
//   cp.async.bulk on an mbarrier (16-byte aligned streams; cp.async or
//   plain loads otherwise) while the current one is ranked, decoded and
//   multiplied; x rows and the dense entry's weight tiles are copied with
//   16-byte cp.async along the weight's unit-stride dimension (row-major
//   weights land [k][n], a stride_k == 1 view lands [n][k], and the
//   product reads either layout through ldmatrix / ldmatrix.trans).
// * Tensor cores: where W and x are both bf16 (the serving path) the tile
//   partial is mma.sync m16n8k16 with A = W^T (the 16-row operand, 128 n a
//   tile) and B = x^T (M <= 8 rows pad to one 8-wide operand), f32
//   accumulators starting from 0 in every tile, never TF32.  fp16 or fp32
//   weights and f32 activations keep an f32 fmaf chain in k order.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "enec_block.cuh"
#include "ptx.cuh"

namespace {

using namespace ptx;

constexpr int kTile = 128;
constexpr int kThreads = enec::kThreads;   // 512: 16 warps
constexpr int kRows = 32;     // x rows a CTA holds: all of a split-K
                              // launch's, a block of a serial one's
constexpr int kVals = 8;      // partial values per thread (kRows * 128 / 512)

constexpr int kStages = 2;   // stage buffers: the next tile lands while
                              // this one is decoded and multiplied

// Shared row of a tile or of x, in elements: 136 halfwords (272 B) or 132
// words (528 B).  Rows stay 16-byte aligned for cp.async and ldmatrix, and
// eight consecutive rows start in eight distinct 4-bank groups.
__host__ __device__ constexpr int row_elems(int esz) {
  return esz == 2 ? 136 : 132;
}
__host__ __device__ constexpr int rows_bytes(int rows, int esz) {
  return rows * row_elems(esz) * esz;
}

struct Args {
  const void* x;
  int x_bf16;
  // fused entry: tile streams and their parameters
  const uint8_t *mask, *low, *high, *raw;
  int b, l;
  enec::Params P;
  // dense-tile entry: the weight and its strides (elements)
  const void* w;
  long long stride_k, stride_n;
  int w_fmt;     // 0 bf16, 1 fp16, 2 fp32
  int nmajor;    // dense tiles held [n][k] (a stride_k == 1 weight)
  float* out;
  float* ws;     // split branch: per-tile partials
  int* counters; // split branch: per-strip arrivals, 0 between launches
  int M, K, N, k_tiles, n_tiles, mc;
};

__host__ __device__ inline int w_esz(const Args& a) {
  return a.w_fmt == 2 ? 4 : 2;
}
__host__ __device__ inline int x_esz(const Args& a) {
  return a.x_bf16 ? 2 : 4;
}

// Shared-memory layout.  Fused: one decoded tile, the stage buffers
// (streams + x rows), the ranks, one mbarrier a stage.  Dense: the stage
// buffers (tile + x rows).
struct Layout {
  int tile, stage, stage_bytes, streams, x_off, rank, misc, total;
};

__host__ __device__ inline Layout make_layout(bool fused, const Args& a) {
  using enec::align16;
  Layout L;
  const int tile_bytes = rows_bytes(kTile, w_esz(a));
  L.streams = fused ? align16(a.P.w_mask) + align16(a.P.w_low) +
                          align16(a.P.w_high) + align16(a.P.w_raw)
                    : 0;
  L.tile = 0;
  L.x_off = fused ? L.streams : tile_bytes;
  L.stage_bytes = L.x_off + rows_bytes(a.mc, x_esz(a));
  L.stage = fused ? tile_bytes : 0;
  L.rank = L.stage + kStages * L.stage_bytes;
  const int rank_bytes =
      fused ? 4 * (align16(a.P.n_elems / a.P.L) + 32) : 0;
  L.misc = L.rank + rank_bytes;
  L.total = L.misc + 32;   // mbarriers, 8 bytes a stage
  return L;
}

// ---- the tile product, shared by both entries -------------------------------

// A tile in shared memory: element (k, n) at [k][n] or, nmajor, [n][k].
struct TileView {
  const uint8_t* p;
  int fmt, nmajor;

  __device__ __forceinline__ float at(int k, int n) const {
    const int esz = fmt == 2 ? 4 : 2;
    const int idx = nmajor ? n * row_elems(esz) + k : k * row_elems(esz) + n;
    if (fmt == 2) return reinterpret_cast<const float*>(p)[idx];
    const uint32_t bits = reinterpret_cast<const uint16_t*>(p)[idx];
    return enec::bits_to_float(bits, fmt == 0 ? 7 : 10);
  }
};

__device__ __forceinline__ float x_at(const uint8_t* xs, int x_bf16, int r,
                                      int k) {
  if (x_bf16)
    return __uint_as_float(
        uint32_t(reinterpret_cast<const uint16_t*>(xs)[r * 136 + k]) << 16);
  return reinterpret_cast<const float*>(xs)[r * 132 + k];
}

// Where value j of this thread's partial lands in the (mc x 128) tile.
__device__ __forceinline__ void val_coord(bool mma, int j, int& r, int& n) {
  const int tid = threadIdx.x;
  if (mma) {
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int nb = (warp >> 3) + 2 * (j >> 2);
    n = (warp & 7) * 16 + g + ((j >> 1) & 1) * 8;
    r = nb * 8 + 2 * t + (j & 1);
  } else {
    n = tid & (kTile - 1);
    r = (tid >> 7) + 4 * j;
  }
}

// This thread's share of the tile's f32 partial x_s[0:mc] @ W, from zero.
// mma: warp w computes n rows (w % 8) * 16 .. +16 for the 8-row x blocks
// w / 8, w / 8 + 2; each output is an m16n8k16 chain over the tile's 8
// k16 steps in order.  fmaf: thread (n = tid % 128, rows tid / 128 + 4j)
// runs one fmaf chain over k = 0..127 in order.  Either way an output
// depends only on its own x row and W column.
__device__ __forceinline__ void tile_partial(const TileView& W,
                                             const uint8_t* xs, int x_bf16,
                                             int mc, bool mma,
                                             float (&p)[kVals]) {
#pragma unroll
  for (int j = 0; j < kVals; ++j) p[j] = 0.f;
  if (mma) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int n0 = (warp & 7) * 16, h = warp >> 3;
    const int mi = lane >> 3, rr = lane & 7;
    const uint16_t* w16 = reinterpret_cast<const uint16_t*>(W.p);
    const uint16_t* x16 = reinterpret_cast<const uint16_t*>(xs);
    const int nbs = mc >> 3;
    float acc[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t a[4];
      // matrix mi: n block (mi & 1), k block (mi >> 1); lane rr gives row rr
      const int kr = ks * 16 + (mi >> 1) * 8, nr = n0 + (mi & 1) * 8;
      const uint16_t* src = W.nmajor ? w16 + (nr + rr) * 136 + kr
                                     : w16 + (kr + rr) * 136 + nr;
      ldmatrix_x4(a, src, !W.nmajor);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int nb = h + 2 * q;
        if (nb < nbs) {
          const uint16_t* xr = x16 + (nb * 8 + g) * 136 + ks * 16 + 2 * t;
          mma_bf16(acc[q], a, *reinterpret_cast<const uint32_t*>(xr),
                   *reinterpret_cast<const uint32_t*>(xr + 8));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[q * 4 + e] = acc[q][e];
  } else {
    const int c = threadIdx.x & (kTile - 1), slot = threadIdx.x >> 7;
    for (int kk = 0; kk < kTile; ++kk) {
      const float w = W.at(kk, c);
#pragma unroll
      for (int j = 0; j < kVals; ++j) {
        const int r = slot + 4 * j;
        if (r < mc) p[j] = fmaf(x_at(xs, x_bf16, r, kk), w, p[j]);
      }
    }
  }
}

// ---- staging ----------------------------------------------------------------

// Copy a (rows x 128) block of a strided global matrix into shared rows of
// row_elems(esz): 16-byte cp.async along the unit-stride dimension when
// the rows allow it (zero-filling past `cols` and `valid_rows`), plain
// loads otherwise.  `pitch` is the row stride in elements.
__device__ __forceinline__ void stage_rows(uint8_t* dst, const uint8_t* src,
                                           long long pitch, int esz,
                                           int rows, int valid_rows,
                                           int cols) {
  const int vec = 16 / esz;
  const int rb = row_elems(esz) * esz;
  if (((reinterpret_cast<uintptr_t>(src) | uintptr_t(pitch * esz)) & 15) ==
      0) {
    const int per_row = kTile / vec;
    for (int v = threadIdx.x; v < rows * per_row; v += blockDim.x) {
      const int r = v / per_row, c = (v % per_row) * vec;
      const int n_ok = (r < valid_rows) ? max(0, min(vec, cols - c)) : 0;
      const uint8_t* s = n_ok ? src + (r * pitch + c) * esz : src;
      cp_async16(dst + r * rb + c * esz, s, n_ok * esz);
    }
  } else {
    for (int e = threadIdx.x; e < rows * kTile; e += blockDim.x) {
      const int r = e / kTile, c = e % kTile;
      const bool ok = r < valid_rows && c < cols;
      if (esz == 2)
        reinterpret_cast<uint16_t*>(dst + r * rb)[c] =
            ok ? reinterpret_cast<const uint16_t*>(src)[r * pitch + c] : 0;
      else
        reinterpret_cast<uint32_t*>(dst + r * rb)[c] =
            ok ? reinterpret_cast<const uint32_t*>(src)[r * pitch + c] : 0u;
    }
  }
}

// The dense entry's tile (k0, n0): [k][n] from a weight with stride_n == 1,
// [n][k] from one with stride_k == 1, element-wise [k][n] otherwise.
__device__ __forceinline__ void stage_w_tile(uint8_t* dst, const Args& a,
                                             int k0, int n0) {
  const int esz = w_esz(a);
  const uint8_t* w = static_cast<const uint8_t*>(a.w);
  if (a.nmajor) {
    stage_rows(dst, w + (n0 * a.stride_n + k0) * esz, a.stride_n, esz,
               kTile, a.N - n0, a.K - k0);
  } else if (a.stride_n == 1) {
    stage_rows(dst, w + (k0 * a.stride_k + n0) * esz, a.stride_k, esz,
               kTile, a.K - k0, a.N - n0);
  } else {
    const int rb = row_elems(esz) * esz;
    for (int e = threadIdx.x; e < kTile * kTile; e += blockDim.x) {
      const int kk = e / kTile, nn = e % kTile;
      const int kg = k0 + kk, ng = n0 + nn;
      const bool ok = kg < a.K && ng < a.N;
      const long long idx = kg * a.stride_k + ng * a.stride_n;
      if (esz == 2)
        reinterpret_cast<uint16_t*>(dst + kk * rb)[nn] =
            ok ? reinterpret_cast<const uint16_t*>(w)[idx] : 0;
      else
        reinterpret_cast<uint32_t*>(dst + kk * rb)[nn] =
            ok ? reinterpret_cast<const uint32_t*>(w)[idx] : 0u;
    }
  }
}

// ---- the kernel -------------------------------------------------------------

template <bool kFused, bool kSplit>
__global__ void __launch_bounds__(kThreads, 2) matmul_kernel(const Args a) {
  constexpr int S = kStages;
  extern __shared__ __align__(128) uint8_t smem[];
  const Layout L = make_layout(kFused, a);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.misc);
  const int tiles = a.k_tiles * a.n_tiles;
  const bool mma = a.w_fmt == 0 && a.x_bf16;
  const int xe = x_esz(a);
  const uint8_t* x = static_cast<const uint8_t*>(a.x);

  // this CTA's walk: tiles first, first + step, ... (count of them) over
  // x rows m0 .. m0 + rows
  int first, step, count, m0, rows;
  if (kSplit) {
    first = blockIdx.x;
    step = gridDim.x;
    count = (tiles - first + step - 1) / step;
    m0 = 0;
    rows = a.M;
  } else {
    const int strip = blockIdx.x % a.n_tiles;
    first = strip * a.k_tiles;
    step = 1;
    count = a.k_tiles;
    m0 = (blockIdx.x / a.n_tiles) * kRows;
    rows = min(kRows, a.M - m0);
  }


  if (kFused) {
    if (threadIdx.x == 0) {
      for (int q = 0; q < S; ++q) mbar_init(&bars[q]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // x rows r0 .. r0 + a.mc of k tile kt into a stage buffer's x region
  auto stage_x = [&](uint8_t* st, int kt, int r0) {
    stage_rows(st + L.x_off, x + (size_t(m0 + r0) * a.K +
                                  size_t(kt) * kTile) * xe,
               a.K, xe, a.mc, rows - r0, a.K - kt * kTile);
  };
  auto prefetch = [&](int j) {
    if (j < count) {
      const int t = first + j * step;
      const int kt = t % a.k_tiles;
      uint8_t* st = smem + L.stage + (j % S) * L.stage_bytes;
      if (kFused) {
        enec::Stage SB(st, a.P);
        uint64_t* bar = &bars[j % S];
        if (threadIdx.x == 0)
          mbar_expect_tx(bar, bulk_bytes(a.mask, a.P.w_mask) +
                                  bulk_bytes(a.low, a.P.w_low) +
                                  bulk_bytes(a.high, a.P.w_high) +
                                  bulk_bytes(a.raw, a.P.w_raw));
        stage_stream(SB.mask, a.mask, a.P.w_mask, t, bar);
        stage_stream(SB.low, a.low, a.P.w_low, t, bar);
        stage_stream(SB.high, a.high, a.P.w_high, t, bar);
        stage_stream(SB.raw, a.raw, a.P.w_raw, t, bar);
      } else {
        stage_w_tile(st, a, kt * kTile, (t / a.k_tiles) * kTile);
      }
      stage_x(st, kt, 0);
    }
    cp_async_commit();   // one group per step, empty past the end
  };

  float acc[kVals];
#pragma unroll
  for (int v = 0; v < kVals; ++v) acc[v] = 0.f;

  for (int j = 0; j < S - 1; ++j) prefetch(j);
  for (int j = 0; j < count; ++j) {
    const int t = first + j * step;
    uint8_t* st = smem + L.stage + (j % S) * L.stage_bytes;
    prefetch(j + S - 1);
    cp_async_wait<S - 1>();
    if (kFused) mbar_wait(&bars[j % S], (j / S) & 1);
    __syncthreads();

    TileView W{st, a.w_fmt, a.nmajor};
    if (kFused) {
      enec::Stage SB(st, a.P);
      SB.rank = reinterpret_cast<int*>(smem + L.rank);
      SB.warp_tot = SB.rank + enec::align16(a.P.n_elems / a.P.L);
      block_exclusive_rank(SB.mask, a.P.n_elems / a.P.L, SB.rank,
                           SB.warp_tot);
      uint8_t* tile = smem + L.tile;
      if (a.P.total_bits == 16) {
        uint16_t* o = reinterpret_cast<uint16_t*>(tile);
        enec::decode_staged_fixed<kTile * kTile>(
            SB, a.P, a.b, a.l, [&](int i, uint32_t v) {
              o[(i >> 7) * 136 + (i & 127)] = uint16_t(v);
            });
      } else {
        uint32_t* o = reinterpret_cast<uint32_t*>(tile);
        enec::decode_staged_fixed<kTile * kTile>(
            SB, a.P, a.b, a.l, [&](int i, uint32_t v) {
              o[(i >> 7) * 132 + (i & 127)] = v;
            });
      }
      __syncthreads();
      W = TileView{tile, a.w_fmt, 0};
    }

    float p[kVals];
    tile_partial(W, st + L.x_off, a.x_bf16, a.mc, mma, p);
    if (kSplit) {
      float* part = a.ws + size_t(t) * a.M * kTile;
#pragma unroll
      for (int v = 0; v < kVals; ++v) {
        int r, n;
        val_coord(mma, v, r, n);
        if (r < rows) part[r * kTile + n] = p[v];
      }
    } else {
#pragma unroll
      for (int v = 0; v < kVals; ++v) acc[v] = j == 0 ? p[v] : acc[v] + p[v];
    }
    __syncthreads();   // the tile and the stage buffer are reused
  }

  if (kSplit) {
    // every thread makes its partials visible device-wide, then the CTA
    // counts one arrival per tile, all at once, and lists the strips whose
    // last arrival it made (that thread acquires the other CTAs' partials;
    // the barrier passes them on)
    __threadfence();
    __syncthreads();
    int* done = reinterpret_cast<int*>(smem + L.stage);   // free by now
    for (int q = threadIdx.x; q < count; q += blockDim.x) {
      const int strip = (first + q * step) / a.k_tiles;
      const bool last = atomicAdd(&a.counters[strip], 1) == a.k_tiles - 1;
      if (last) __threadfence();
      done[q] = last ? strip : -1;
    }
    __syncthreads();
    for (int q = 0; q < count; ++q) {
      const int strip = done[q];
      if (strip < 0) continue;
      // the strip's partials summed in k order, loads 16 deep in flight
      const float* base = a.ws + size_t(strip) * a.k_tiles * a.M * kTile;
      const size_t stride = size_t(a.M) * kTile;
      for (int e = threadIdx.x; e < a.M * kTile; e += blockDim.x) {
        float s = __ldcg(base + e);
        int k = 1;
        for (; k + 16 <= a.k_tiles; k += 16) {
          float v[16];
#pragma unroll
          for (int u = 0; u < 16; ++u)
            v[u] = __ldcg(base + (k + u) * stride + e);
#pragma unroll
          for (int u = 0; u < 16; ++u) s = s + v[u];
        }
        for (; k < a.k_tiles; ++k) s = s + __ldcg(base + k * stride + e);
        const int ng = strip * kTile + e % kTile;
        if (ng < a.N) a.out[size_t(e / kTile) * a.N + ng] = s;
      }
      if (threadIdx.x == 0) a.counters[strip] = 0;
    }
  } else {
    const int n0 = (first / a.k_tiles) * kTile;
#pragma unroll
    for (int v = 0; v < kVals; ++v) {
      int r, n;
      val_coord(mma, v, r, n);
      if (r < rows && n0 + n < a.N)
        a.out[size_t(m0 + r) * a.N + n0 + n] = acc[v];
    }
  }
}

struct Plan {
  int grid, ctas_per_sm, smem, sm_count, split;
};
Plan g_last{};

// Per device: the SM count, and per kernel the shared-memory size last
// opted into with its resident CTAs per SM (host queries cost more than
// the launch itself at decode batch).
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
int g_smem[kMaxDevices][4], g_per_sm[kMaxDevices][4];

template <bool kFused, bool kSplit>
int launch(Args a, cudaStream_t stream) {
  auto kern = matmul_kernel<kFused, kSplit>;
  constexpr int id = 2 * kFused + kSplit;
  a.mc = kSplit ? (a.M + 7) / 8 * 8 : kRows;
  const int smem = make_layout(kFused, a).total;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return int(err);
  }
  if (g_smem[dev][id] != smem) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_per_sm[dev][id],
                                                        kern, kThreads, smem);
    if (err != cudaSuccess) return int(err);
    if (g_per_sm[dev][id] == 0) return int(cudaErrorInvalidConfiguration);
    g_smem[dev][id] = smem;
  }
  const int per_sm = g_per_sm[dev][id], sms = g_sms[dev];
  const int tiles = a.k_tiles * a.n_tiles;
  const int grid = kSplit ? min(tiles, per_sm * sms)
                          : a.n_tiles * ((a.M + kRows - 1) / kRows);
  g_last = Plan{grid, per_sm, smem, sms, int(kSplit)};
  kern<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <bool kFused>
int dispatch(Args& a, void* stream) {
  a.k_tiles = (a.K + kTile - 1) / kTile;
  a.n_tiles = (a.N + kTile - 1) / kTile;
  if (a.M == 0 || a.n_tiles == 0 || a.k_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.ws == nullptr) return launch<kFused, false>(a, s);
  if (a.counters == nullptr || a.M > kRows)
    return int(cudaErrorInvalidValue);
  return launch<kFused, true>(a, s);
}

}  // namespace

// Fused entry: W as (k_tiles * n_tiles) tile blocks with params (b, l).
// ws: k_tiles * n_tiles * M * 128 floats and counters: n_tiles ints, all
// 0, select ordered split-K (M <= 32); ws == nullptr the serial k walk.
extern "C" int decompress_matmul_launch(
    const void* x, int x_bf16, const uint8_t* mask, const uint8_t* low,
    const uint8_t* high, const uint8_t* raw, int b, int l, int L, int n,
    int m, int total_bits, int mant_bits, int w_mask, int w_low, int w_high,
    int w_raw, float* out, float* ws, int* counters, int M, int K, int N,
    void* stream) {
  Args a{};
  a.x = x;
  a.x_bf16 = x_bf16;
  a.mask = mask;
  a.low = low;
  a.high = high;
  a.raw = raw;
  a.b = b;
  a.l = l;
  a.P = enec::Params{kTile * kTile, L,          n,     m,      total_bits,
                     mant_bits,     w_mask,     w_low, w_high, w_raw};
  a.w_fmt = total_bits == 32 ? 2 : (mant_bits == 10 ? 1 : 0);
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.M = M;
  a.K = K;
  a.N = N;
  return dispatch<true>(a, stream);
}

// Dense-tile entry: the same schedule and tile product over a dense (K, N)
// weight; w_fmt: 0 bf16, 1 fp16, 2 fp32; strides in elements.
extern "C" int dense_tile_matmul_launch(const void* x, int x_bf16,
                                        const void* w, int w_fmt,
                                        long long stride_k,
                                        long long stride_n, float* out,
                                        float* ws, int* counters, int M,
                                        int K, int N, void* stream) {
  Args a{};
  a.x = x;
  a.x_bf16 = x_bf16;
  a.w = w;
  a.w_fmt = w_fmt;
  a.stride_k = stride_k;
  a.stride_n = stride_n;
  a.nmajor = stride_k == 1 && stride_n != 1;
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.M = M;
  a.K = K;
  a.N = N;
  return dispatch<false>(a, stream);
}

// The last launch's plan: grid, resident CTAs per SM, dynamic shared
// bytes, SM count, split (1) or serial (0).
extern "C" void matmul_last_plan(int* out) {
  out[0] = g_last.grid;
  out[1] = g_last.ctas_per_sm;
  out[2] = g_last.smem;
  out[3] = g_last.sm_count;
  out[4] = g_last.split;
}
