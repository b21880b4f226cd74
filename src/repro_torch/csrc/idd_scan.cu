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
// What the design does: every load and store is 16 bytes a lane (4 int32
// or 16 bools), a warp's 32 lanes on 512 neighbouring bytes, and the scan
// stays in registers: each lane sums its own run, one shuffle scan of the
// lane totals a chunk gives each lane its offset.  Two branches, chosen
// by the host (kernels/idd_scan.py: plan):
// * Warp rows (rows of up to a few thousand elements): one warp a row,
//   eight rows a CTA, the warp walking its row in steps of 1024 elements
//   (eight 16-byte loads a lane in flight) with a running carry.  No
//   shared memory, no block barrier, no thread idle.
// * Look-back (long rows): a single-pass decoupled look-back scan across
//   CTAs (Merrill & Garland), the "dependency-decoupled" scan of the paper
//   on this card.  A CTA of 8 warps scans a tile of 8192 elements; its
//   tile comes from an atomic ticket, so the tiles before it in its row
//   have all started.  It publishes its aggregate, then warp 0 walks back
//   over the status words of its predecessors 32 at a time, summing
//   aggregates until it meets an inclusive prefix, and publishes its own
//   inclusive prefix.  A status word is (epoch, flag, value) in 64 bits,
//   the epoch new at every launch, so the words need no memset; the CTA
//   that draws the last ticket resets the ticket counter.
// Sums are unsigned 32-bit, so they wrap mod 2**32 like torch.cumsum's
// int32 sum; integer addition is associative, so the result is bitwise
// torch.cumsum's for any tiling.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowWarps = 8;        // warp rows: rows a CTA
constexpr int kTileWarps = 8;       // look-back: warps a CTA
constexpr int kWarpRun = 1024;      // look-back: elements a warp
constexpr int kTile = kTileWarps * kWarpRun;   // 8192 elements a tile
constexpr int kStep = 1024;         // warp rows: elements a warp step

// 16 bytes a lane: E values of T.
template <typename T>
struct Vec {
  static constexpr int E = 16 / int(sizeof(T));
  __device__ static void load(const T* p, uint32_t (&v)[E]) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    if constexpr (E == 4) {
      v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
    } else {
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        v[k] = (words[k >> 2] >> (8 * (k & 3))) & 0xFFu;
    }
  }
};

// K chunks of 32 * E neighbouring elements scanned by one warp: lane l
// holds elements base + k * 32 E + l E .. + E of chunk k.  Elements at or
// past n (whole lanes: n and the chunks are multiples of E) read as 0 and
// are not stored.
template <typename T, int K>
struct WarpRun {
  static constexpr int E = Vec<T>::E;
  static constexpr int kLen = K * 32 * E;
  uint32_t v[K][E];
  uint32_t off[K];   // lane offsets within the run
  uint32_t total;    // the run's sum

  __device__ void load(const T* row, long long base, long long n, int lane) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = base + (long long)k * 32 * E + lane * E;
      if (i < n) {
        Vec<T>::load(row + i, v[k]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) v[k][e] = 0u;
      }
    }
  }

  __device__ void scan(int lane) {
    uint32_t run = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int e = 1; e < E; ++e) v[k][e] += v[k][e - 1];
      const uint32_t mine = v[k][E - 1];
      uint32_t incl = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      off[k] = run + incl - mine;
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
    total = run;
  }

  __device__ void store(int32_t* orow, long long base, long long n, int lane,
                        uint32_t carry) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = base + (long long)k * 32 * E + lane * E;
      if (i < n) {
        const uint32_t o = carry + off[k];
#pragma unroll
        for (int e = 0; e < E; e += 4)
          *reinterpret_cast<uint4*>(orow + i + e) =
              make_uint4(o + v[k][e], o + v[k][e + 1], o + v[k][e + 2],
                         o + v[k][e + 3]);
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
scan_rows_kernel(const T* __restrict__ x, int32_t* __restrict__ out,
                 int rows, int n) {
  constexpr int K = kStep / (32 * Vec<T>::E);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + size_t(row) * n;
  int32_t* orow = out + size_t(row) * n;
  uint32_t carry = 0;
  for (int base = 0; base < n; base += kStep) {
    WarpRun<T, K> r;
    r.load(xr, base, n, lane);
    r.scan(lane);
    r.store(orow, base, n, lane, carry);
    carry += r.total;
  }
}

// status word: epoch (30 bits) | flag (2 bits) | value (32 bits)
constexpr unsigned long long kAggregate = 1, kPrefix = 2;

__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kTileWarps * 32)
scan_lookback_kernel(const T* __restrict__ x, int32_t* __restrict__ out,
                     int n, int tiles_per_row, int total_tiles,
                     unsigned long long* __restrict__ status,
                     unsigned int* __restrict__ ticket, unsigned epoch) {
  constexpr int K = kWarpRun / (32 * Vec<T>::E);
  __shared__ uint32_t warp_off[kTileWarps];
  __shared__ uint32_t tile_prefix;
  __shared__ int tile_id;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const int t = int(atomicAdd(ticket, 1u));
    if (t == total_tiles - 1) *ticket = 0u;   // every ticket is drawn
    tile_id = t;
  }
  __syncthreads();
  const int t = tile_id;
  const int row = t / tiles_per_row, k = t % tiles_per_row;
  const T* xr = x + size_t(row) * n;
  int32_t* orow = out + size_t(row) * n;
  const long long base = (long long)k * kTile + warp * kWarpRun;

  WarpRun<T, K> r;
  r.load(xr, base, n, lane);
  r.scan(lane);
  if (lane == 0) warp_off[warp] = r.total;
  __syncthreads();
  if (warp == 0) {
    // the warp totals' exclusive scan and the tile's aggregate
    const uint32_t mine = lane < kTileWarps ? warp_off[lane] : 0u;
    uint32_t incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t s = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += s;
    }
    if (lane < kTileWarps) warp_off[lane] = incl - mine;
    const uint32_t agg = __shfl_sync(0xffffffffu, incl, kTileWarps - 1);
    unsigned long long* st = status + size_t(row) * tiles_per_row;
    const unsigned long long tag = (unsigned long long)epoch << 34;
    if (lane == 0)
      st_status(&st[k], tag | ((k ? kAggregate : kPrefix) << 32) | agg);
    // walk back until an inclusive prefix: lane i reads tile pred - i
    uint32_t excl = 0;
    for (int pred = k - 1; pred >= 0; pred -= 32) {
      const int idx = pred - lane;
      unsigned long long s;
      unsigned flag;
      long long tries = 0;
      do {   // traps (a launch error, not a hang) if a status never comes
        s = idx >= 0 ? ld_status(&st[idx])
                     : (tag | (kPrefix << 32));   // before the row: 0
        flag = (s >> 34) == epoch ? unsigned(s >> 32) & 3u : 0u;
        if (++tries > (1ll << 26)) __trap();
      } while (__any_sync(0xffffffffu, flag == 0));
      const unsigned done = __ballot_sync(0xffffffffu, flag == kPrefix);
      const int stop = done ? __ffs(done) - 1 : 31;
      uint32_t val = lane <= stop ? uint32_t(s) : 0u;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        val += __shfl_xor_sync(0xffffffffu, val, o);
      excl += val;
      if (done) break;
    }
    if (lane == 0) {
      if (k) st_status(&st[k], tag | (kPrefix << 32) | uint32_t(excl + agg));
      tile_prefix = excl;
    }
  }
  __syncthreads();
  r.store(orow, base, n, lane, tile_prefix + warp_off[warp]);
}

}  // namespace

// Scan `rows` rows of n values (int32 when is_bool == 0, else one byte
// each) on `grid` CTAs: warp rows when lookback == 0 (grid = ceil(rows /
// 8)); else the look-back scan (grid = rows * ceil(n / 8192) tiles) with
// `status` (a word a tile, from any earlier launch or zero), `ticket` (0
// between launches) and this launch's `epoch` (1 .. 2**30 - 1, never the
// one of the launch before on the same status words).  Returns the
// cudaError_t of the launch.
extern "C" int idd_scan_launch(const void* x, int is_bool, int32_t* out,
                               int rows, int n, int lookback, int grid,
                               unsigned long long* status,
                               unsigned int* ticket, unsigned epoch,
                               void* stream) {
  if (rows == 0 || n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!lookback) {
    if (grid != (rows + kRowWarps - 1) / kRowWarps)
      return int(cudaErrorInvalidValue);
    if (is_bool)
      scan_rows_kernel<uint8_t><<<grid, kRowWarps * 32, 0, s>>>(
          static_cast<const uint8_t*>(x), out, rows, n);
    else
      scan_rows_kernel<int32_t><<<grid, kRowWarps * 32, 0, s>>>(
          static_cast<const int32_t*>(x), out, rows, n);
  } else {
    const int tiles_per_row = (n + kTile - 1) / kTile;
    if ((long long)grid != (long long)rows * tiles_per_row || epoch == 0 ||
        epoch >= (1u << 30))
      return int(cudaErrorInvalidValue);
    if (is_bool)
      scan_lookback_kernel<uint8_t><<<grid, kTileWarps * 32, 0, s>>>(
          static_cast<const uint8_t*>(x), out, n, tiles_per_row, grid,
          status, ticket, epoch);
    else
      scan_lookback_kernel<int32_t><<<grid, kTileWarps * 32, 0, s>>>(
          static_cast<const int32_t*>(x), out, n, tiles_per_row, grid,
          status, ticket, epoch);
  }
  return int(cudaGetLastError());
}
