// ENEC block encoder for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/enec_encode.py:
// encode_blocks_pallas (body encode_block_body, with _onehot_scatter).
//
// What bounds it on the H100: memory.  Per element it reads 2 (or 4) input
// bytes and writes about (n + raw_bits)/8 compressed bytes (the high stream
// at its static width); at 3.35 TB/s the llama embed's 1.0 GB take 0.30 ms.
// The packing between is integer work that has to stay below that.
//
// What the design does about it (the host planner kernels/enec_encode.py:
// plan picks the branch and the grid, as for the decoder):
// * Persistent grid: SM count x resident CTAs, CTA c walking blocks c,
//   c + grid, ...; the next block's input goes into one of two stages by
//   cp.async.bulk on an mbarrier (cp.async or loads where unaligned),
//   issued by the last warp while the current block is packed.
// * Per block, four barriers: (1) each thread maps four elements at a time
//   to their work value y = (b - x) mod 2**n (the TPU's linear map, b
//   per block) and any sign|mantissa residue above its whole bytes, kept
//   as 16-bit values in shared memory, and writes the raw stream's byte
//   planes straight to device memory; (2) one thread per group ORs its y
//   values, a warp ballot makes each 32 groups' anomaly bits one mask
//   word; the low stream (and an fp16 raw residue) is packed meanwhile;
//   (3) the exclusive rank of the anomalous groups, from the mask words
//   by shuffles (lanes::WarpRank) in the lanes branch or a prefix over the
//   words in the generic one, gives high_len and the inverse map
//   grp_of_rank (rank r -> group); the mask bytes go out; (4) the high
//   stream is packed, lane r * L + t gathering element t of group
//   grp_of_rank[r] (the TPU's one-hot MXU scatter, inverted into a
//   gather), zero past count * L.
// * Packing without atomics: the halving layout has a closed form
//   (core/bitio.py: piece_map).  After F folds of a level of A-bit
//   elements over LEN lanes, word j (j < SUB = LEN >> F) holds the A bits
//   of elements j + q * SUB at bit A * bitrev_F(q); its low byte is byte j
//   of the level and the W - 8 bits above are element j of the next level.
//   A thread owning four lanes of the last level (pack::levels) computes
//   the words of the upper levels that feed them, gathering their
//   elements from shared memory as pairs of 16-bit lanes, and stores every
//   level's four bytes as one 32-bit store: each output byte is written
//   once, with no zeroing pass, no shared buffer and no atomics.  The lanes
//   branch (bf16 blocks of 16384 elements, L a power of two in 16..2048,
//   n <= 9: every block the serving path encodes) maps four elements at a
//   time in pairs; the generic branch (fp16, fp32, other block sizes and
//   group lengths) maps element by element and gathers the high rows
//   element by element when L < 4.
#include <cuda_runtime.h>

#include "enec_block.cuh"
#include "ptx.cuh"

namespace {

using namespace ptx;

constexpr int kBlock = 16384;    // the lanes branch's block
constexpr int kThreads = 512;
constexpr int kStages = 2;

struct Args {
  const uint8_t* bits;   // (nblocks, N) raw float bits, 2 or 4 bytes each
  const int* b_vec;
  uint8_t *mask, *low, *high, *raw;
  int* high_len;
  long long nblocks;
  enec::Params P;
};

// Byte offsets of the shared regions: the input stages, the work values
// u (y in bits 0..8, a raw residue in bits 9..15), the mask words, their
// exclusive prefix and the count (generic branch), grp_of_rank, barriers.
struct Layout {
  int x_bytes, u, words, prefix, gor, bars, total;
};

__host__ __device__ inline Layout make_layout(const enec::Params& P) {
  using enec::align16;
  const int g = P.n_elems / P.L, nw = (g + 31) / 32;
  Layout L;
  L.x_bytes = align16(P.n_elems * (P.total_bits / 8));
  L.u = kStages * L.x_bytes;
  L.words = L.u + align16(2 * P.n_elems);
  L.prefix = L.words + align16(4 * nw);
  L.gor = L.prefix + align16(4 * nw + 4);
  L.bars = L.gor + align16(2 * g);
  L.total = L.bars + 8 * kStages;
  return L;
}

namespace pack {

// The low bytes of the four lanes held as two pairs, as one word.
__device__ __forceinline__ uint32_t low_bytes(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x6420);
}

// The halving-packed levels of A-bit elements (A < 8) over `len` lanes
// (len >> 3 >= 8), starting at byte `base` of `out`; get(i, e) gives
// elements i .. i + 3 (i % 4 == 0) as two pairs of 16-bit lanes.  The
// threads own four lanes each of the last level and compute, for each, the
// words of the levels above that feed it (words(j) gathers elements j + q *
// sub, the next level's element j is words(j) >> 8), storing every word's
// low byte on the way: each byte once.
template <int A, typename Get>
__device__ __forceinline__ void levels(uint8_t* out, int len, int base,
                                       const Get& get) {
  constexpr int F = enec::fixed::folds_of(A, 1 << 20);
  constexpr int W = A << F;
  const int sub = len >> F;
  auto words = [&](int j, uint32_t (&w)[2]) {
    w[0] = w[1] = 0u;
#pragma unroll
    for (int q = 0; q < (1 << F); ++q) {
      uint32_t e[2];
      get(j + q * sub, e);
      const int shift = A * enec::lanes::rev_bits(q, F);
      w[0] |= e[0] << shift;
      w[1] |= e[1] << shift;
    }
    *reinterpret_cast<uint32_t*>(out + base + j) = low_bytes(w[0], w[1]);
  };
  if constexpr (W > 8) {
    constexpr uint32_t m2 = ((1u << (W - 8)) - 1u) * 0x10001u;
    levels<W - 8>(out, sub, base + sub, [&](int i, uint32_t (&e)[2]) {
      words(i, e);
      e[0] = (e[0] >> 8) & m2;
      e[1] = (e[1] >> 8) & m2;
    });
  } else {
    for (int j = 4 * threadIdx.x; j < sub; j += 4 * blockDim.x) {
      uint32_t w[2];
      words(j, w);
    }
  }
}

// The folded residue of `a` bits (0 <= a < 8) a lane: get(i, e) gives the
// residue values of elements i .. i + 3 (a bits each) as pairs.
template <typename Get>
__device__ __forceinline__ void residue(uint8_t* out, int a, int n,
                                        int base, const Get& get) {
  switch (a) {
    case 1: levels<1>(out, n, base, get); break;
    case 2: levels<2>(out, n, base, get); break;
    case 3: levels<3>(out, n, base, get); break;
    case 4: levels<4>(out, n, base, get); break;
    case 5: levels<5>(out, n, base, get); break;
    case 6: levels<6>(out, n, base, get); break;
    case 7: levels<7>(out, n, base, get); break;
    default: break;
  }
}

// A packed stream of `width` <= 15 bits over n lanes (core/bitio.py:
// pack_fixed): one byte plane if width >= 8, then the folded residue.
template <typename Get>
__device__ __forceinline__ void stream(uint8_t* out, int width, int n,
                                       const Get& get) {
  const int planes = width >> 3, a = width & 7;
  if (planes)
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
      uint32_t v[2];
      get(i, v);
      *reinterpret_cast<uint32_t*>(out + i) = low_bytes(v[0], v[1]);
    }
  const uint32_t m2 = ((1u << a) - 1u) * 0x10001u;
  const int sh = 8 * planes;
  residue(out, a, n, planes * n, [&](int i, uint32_t (&e)[2]) {
    get(i, e);
    e[0] = (e[0] >> sh) & m2;
    e[1] = (e[1] >> sh) & m2;
  });
}

}  // namespace pack

// Step (1) for elements i0 .. i0 + 3 of the staged block xs: u and the
// raw byte planes.
template <bool LANES>
__device__ __forceinline__ void map4(const Args& a, const uint8_t* xs,
                                     uint16_t* u, uint8_t* raw_out, int i0,
                                     int b) {
  const enec::Params& P = a.P;
  const int N = P.n_elems;
  const uint32_t mod = (1u << P.n) - 1u;
  if constexpr (LANES) {   // bf16: sign | 8 exponent | 7 mantissa bits
    const uint2 x = *reinterpret_cast<const uint2*>(xs + 2 * i0);
    const uint32_t b2 = (uint32_t(b) & 0xFFFFu) * 0x10001u;
    const uint32_t mod2 = mod * 0x10001u;
    // y = (b - e) mod 2**16 on each lane, then mod 2**n (2**n | 2**16)
    const uint32_t y0 = __vsub2(b2, (x.x >> 7) & 0x00FF00FFu) & mod2;
    const uint32_t y1 = __vsub2(b2, (x.y >> 7) & 0x00FF00FFu) & mod2;
    *reinterpret_cast<uint2*>(u + i0) = make_uint2(y0, y1);
    const uint32_t r0 = ((x.x >> 8) & 0x00800080u) | (x.x & 0x007F007Fu);
    const uint32_t r1 = ((x.y >> 8) & 0x00800080u) | (x.y & 0x007F007Fu);
    *reinterpret_cast<uint32_t*>(raw_out + i0) = pack::low_bytes(r0, r1);
  } else {
    const int eb = P.total_bits / 8;
    const int planes = (P.mant_bits + 1) >> 3;
    const uint32_t exp_mask = (1u << (P.total_bits - 1 - P.mant_bits)) - 1u;
    const uint32_t mant_mask = (1u << P.mant_bits) - 1u;
    uint32_t plane[3] = {0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t x =
          eb == 2 ? uint32_t(reinterpret_cast<const uint16_t*>(xs)[i0 + k])
                  : reinterpret_cast<const uint32_t*>(xs)[i0 + k];
      const int e = int((x >> P.mant_bits) & exp_mask);
      const uint32_t y = uint32_t(b - e) & mod;
      const uint32_t r = (x & mant_mask) |
                         (((x >> (P.total_bits - 1)) & 1u) << P.mant_bits);
      u[i0 + k] = uint16_t(y | ((r >> (8 * planes)) << 9));
#pragma unroll
      for (int p = 0; p < 3; ++p)
        plane[p] |= ((r >> (8 * p)) & 0xFFu) << (8 * k);
    }
    for (int p = 0; p < planes; ++p)
      *reinterpret_cast<uint32_t*>(raw_out + p * N + i0) = plane[p];
  }
}

template <bool LANES>
__global__ void __launch_bounds__(kThreads, 2)
encode_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const enec::Params& P = a.P;
  const Layout Ly = make_layout(P);
  const int N = LANES ? kBlock : P.n_elems;
  const int L = P.L, G = N / L, hw = P.n - P.m;
  uint16_t* u = reinterpret_cast<uint16_t*>(smem + Ly.u);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + Ly.words);
  int* prefix = reinterpret_cast<int*>(smem + Ly.prefix);
  uint16_t* gor = reinterpret_cast<uint16_t*>(smem + Ly.gor);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Ly.bars);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int count_blocks =
      a.nblocks > blockIdx.x
          ? int((a.nblocks - 1 - blockIdx.x) / gridDim.x) + 1
          : 0;
  const int in_bytes = N * (P.total_bits / 8);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  constexpr int kIssuer = kThreads - 32;
  const bool stager = tid >= kIssuer;
  auto prefetch = [&](int j) {
    if (j < count_blocks) {
      const long long blk = blockIdx.x + (long long)j * gridDim.x;
      uint64_t* bar = &bars[j % kStages];
      if (tid == kIssuer) mbar_expect_tx(bar, bulk_bytes(a.bits, in_bytes));
      stage_stream(smem + (j % kStages) * Ly.x_bytes, a.bits, in_bytes, blk,
                   bar, kIssuer, lane, 32);
    }
    cp_async_commit();
  };

  const int lshift = __ffs(L) - 1;   // L is a power of two
  const uint32_t lm2 = ((1u << P.m) - 1u) * 0x10001u;
  const uint32_t hm2 = ((1u << hw) - 1u) * 0x10001u;

  if (stager) prefetch(0);
  for (int j = 0; j < count_blocks; ++j) {
    const long long blk = blockIdx.x + (long long)j * gridDim.x;
    const uint8_t* xs = smem + (j % kStages) * Ly.x_bytes;
    cp_async_wait<0>();
    mbar_wait(&bars[j % kStages], (j / kStages) & 1);
    __syncthreads();   // block j staged; every warp is done with block j - 1
    if (stager) prefetch(j + 1);
    const int b = a.b_vec[blk];
    uint8_t* raw_out = a.raw + blk * P.w_raw;

    // (1) work values and the raw byte planes
    for (int i0 = 4 * tid; i0 < N; i0 += 4 * kThreads)
      map4<LANES>(a, xs, u, raw_out, i0, b);
    __syncthreads();

    // (2) anomaly flags -> mask words; the low stream; an fp16 raw residue
    for (int g0 = 32 * warp; g0 < G; g0 += kThreads) {
      const int g = g0 + lane;
      uint32_t o = 0u;
      if (g < G) {
        if (L >= 8) {
          const uint4* v = reinterpret_cast<const uint4*>(u + g * L);
          for (int k = 0; k < (L >> 3); ++k)
            o |= v[k].x | v[k].y | v[k].z | v[k].w;
          o |= o >> 16;
        } else {
          for (int t = 0; t < L; ++t) o |= u[g * L + t];
        }
      }
      const uint32_t word =
          __ballot_sync(0xffffffffu, ((o & 0x1FFu) >> P.m) != 0u);
      if (lane == 0) words[g0 >> 5] = word;
    }
    if (P.w_low)
      pack::stream(a.low + blk * P.w_low, P.m, N,
                   [&](int i, uint32_t (&e)[2]) {
                     const uint2 v = *reinterpret_cast<const uint2*>(u + i);
                     e[0] = v.x & lm2;
                     e[1] = v.y & lm2;
                   });
    if constexpr (!LANES) {   // fp16: 3 raw bits above the byte plane
      const int ra = (P.mant_bits + 1) & 7;
      const uint32_t rm2 = ((1u << ra) - 1u) * 0x10001u;
      pack::residue(raw_out, ra, N, ((P.mant_bits + 1) >> 3) * N,
                    [&](int i, uint32_t (&e)[2]) {
                      const uint2 v = *reinterpret_cast<const uint2*>(u + i);
                      e[0] = (v.x >> 9) & rm2;
                      e[1] = (v.y >> 9) & rm2;
                    });
    }
    __syncthreads();

    // (3) ranks -> count, high_len, grp_of_rank; the mask bytes
    int count;
    if constexpr (LANES) {   // G <= 1024: every warp ranks from the words
      enec::lanes::WarpRank rk;
      rk.load(reinterpret_cast<const uint8_t*>(words), G);
      count = int(__shfl_sync(0xffffffffu, rk.before + __popc(rk.word), 31));
      for (int g0 = 32 * warp; g0 < G; g0 += kThreads) {
        int r;
        if (rk.at(g0 + lane, r) && g0 + lane < G) gor[r] = uint16_t(g0 + lane);
      }
    } else {                 // a prefix over the words, then a barrier
      const int nw = (G + 31) >> 5;
      if (warp == 0) {
        const int per = (nw + 31) >> 5, w0 = lane * per;
        int sum = 0;
        for (int k = 0; k < per; ++k)
          if (w0 + k < nw) sum += __popc(words[w0 + k]);
        int incl = sum;
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += t;
        }
        int run = incl - sum;
        for (int k = 0; k < per; ++k)
          if (w0 + k < nw) {
            prefix[w0 + k] = run;
            run += __popc(words[w0 + k]);
          }
        if (lane == 31) prefix[nw] = incl;   // the count
      }
      __syncthreads();
      count = prefix[nw];
      for (int g = tid; g < G; g += kThreads) {
        const uint32_t w = words[g >> 5];
        if ((w >> (g & 31)) & 1u)
          gor[prefix[g >> 5] + __popc(w & ((1u << (g & 31)) - 1u))] =
              uint16_t(g);
      }
    }
    if (tid == 0) a.high_len[blk] = count * L * hw;
    for (int k = tid; k < P.w_mask; k += kThreads)
      a.mask[blk * P.w_mask + k] = uint8_t(words[k >> 2] >> (8 * (k & 3)));
    __syncthreads();

    // (4) the high stream: lane r * L + t <- element t of group gor[r]
    if (P.w_high) {
      uint8_t* out = a.high + blk * P.w_high;
      // L >= 4: the four lanes i .. i + 3 are one row's
      auto rows4 = [&](int i, uint32_t (&e)[2]) {
        const int r = i >> lshift;
        if (r < count) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              u + (int(gor[r]) << lshift) + (i & (L - 1)));
          e[0] = (v.x >> P.m) & hm2;
          e[1] = (v.y >> P.m) & hm2;
        } else {
          e[0] = e[1] = 0u;
        }
      };
      if constexpr (LANES) {
        pack::stream(out, hw, N, rows4);
      } else if (L >= 4) {
        pack::stream(out, hw, N, rows4);
      } else {
        pack::stream(out, hw, N, [&](int i, uint32_t (&e)[2]) {
          uint32_t v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int r = (i + k) >> lshift;
            v[k] = r < count ? (uint32_t(u[(int(gor[r]) << lshift) +
                                           ((i + k) & (L - 1))]) >> P.m) &
                                   (hm2 & 0xFFFFu)
                             : 0u;
          }
          e[0] = v[0] | (v[1] << 16);
          e[1] = v[2] | (v[3] << 16);
        });
      }
    }
  }
}

// Per device and branch: the SM count, and the shared-memory size last
// opted into with its resident CTAs per SM.
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
int g_smem[kMaxDevices][2], g_per_sm[kMaxDevices][2];

int prepare(const enec::Params& P, int lanes, int* smem_out, int* per_sm_out,
            int* sms_out) {
  const void* kern = lanes
      ? reinterpret_cast<const void*>(encode_kernel<true>)
      : reinterpret_cast<const void*>(encode_kernel<false>);
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

bool takes(const enec::Params& P, int lanes) {
  const int N = P.n_elems, L = P.L;
  if (N < 64 || (N & (N - 1)) || L < 1 || (L & (L - 1)) || N % L ||
      (N / L) % 8 || P.m < 1 || P.m > P.n || P.n > 9)
    return false;
  return !lanes || (N == kBlock && P.total_bits == 16 && P.mant_bits == 7 &&
                    L >= 16 && L <= 2048);
}

}  // namespace

// The launch resources of one configuration on the current device: out =
// {dynamic shared bytes, resident CTAs per SM, SM count}; returns the
// cudaError_t of the queries.
extern "C" int enec_encode_resources(int lanes, int n_elems, int L, int n,
                                     int m, int total_bits, int mant_bits,
                                     int w_mask, int w_low, int w_high,
                                     int w_raw, int* out) {
  const enec::Params P{n_elems, L, n, m, total_bits, mant_bits,
                       w_mask, w_low, w_high, w_raw};
  if (!takes(P, lanes)) return int(cudaErrorInvalidValue);
  return prepare(P, lanes, &out[0], &out[1], &out[2]);
}

// Encode `nblocks` blocks of n_elems raw float bits (2 or 4 bytes each) on
// `grid` CTAs (the host's plan); returns the cudaError_t of the launch.
extern "C" int enec_encode_launch(const void* bits, const int* b_vec,
                                  uint8_t* mask, uint8_t* low, uint8_t* high,
                                  int* high_len, uint8_t* raw,
                                  long long nblocks, int n_elems, int L,
                                  int n, int m, int total_bits,
                                  int mant_bits, int w_mask, int w_low,
                                  int w_high, int w_raw, int lanes, int grid,
                                  void* stream) {
  Args a{};
  a.bits = static_cast<const uint8_t*>(bits);
  a.b_vec = b_vec;
  a.mask = mask;
  a.low = low;
  a.high = high;
  a.raw = raw;
  a.high_len = high_len;
  a.nblocks = nblocks;
  a.P = enec::Params{n_elems, L, n, m, total_bits, mant_bits,
                     w_mask, w_low, w_high, w_raw};
  if (!takes(a.P, lanes)) return int(cudaErrorInvalidValue);
  int smem, per_sm, sms;
  const int err = prepare(a.P, lanes, &smem, &per_sm, &sms);
  if (err) return err;
  if (nblocks == 0) return 0;
  if (grid < 1) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes)
    encode_kernel<true><<<grid, kThreads, smem, s>>>(a);
  else
    encode_kernel<false><<<grid, kThreads, smem, s>>>(a);
  return int(cudaGetLastError());
}
