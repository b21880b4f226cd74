// PTX helpers for Hopper (sm_90a) shared by the fused decode+matmul
// (decompress_matmul.cu), the compressed-KV attention
// (decode_attention_kv.cu) and the block decoder and encoder
// (enec_decode.cu, enec_encode.cu): asynchronous copies into shared memory
// (16- and 4-byte cp.async, cp.async.bulk completing on an mbarrier), the
// mbarrier itself, and the bf16 tensor-core fragments (ldmatrix, mma.sync
// m16n8k16 with f32 accumulators).
#pragma once
#include <cstdint>

namespace ptx {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>   // wait until at most kPending groups are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `parity` to complete; traps (a launch error, not
// a hang) if the expected bytes never arrive.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (long long tries = 0; !done; ++tries) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (tries > (1ll << 26)) __trap();
  }
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One stream of block `blk` (w bytes a block), or only its first `nbytes`
// (<= w): bulk copy on the mbarrier when aligned (issued by thread
// `issuer`, bytes already expected; nbytes rounded up to 16), else
// cp.async / loads by the calling threads: the whole block, or the `nt`
// threads numbered t = 0 .. nt - 1 that call it.
__device__ __forceinline__ void stage_stream(uint8_t* dst, const uint8_t* base,
                                             int w, size_t blk,
                                             uint64_t* bar, int issuer = 0,
                                             int t = -1, int nt = 0,
                                             int nbytes = -1) {
  const int nb = nbytes < 0 ? w : nbytes;
  if (nb == 0) return;
  if (t < 0) {
    t = threadIdx.x;
    nt = blockDim.x;
  }
  const uint8_t* src = base + blk * w;
  if (((reinterpret_cast<uintptr_t>(base) | unsigned(w)) & 15) == 0) {
    if (threadIdx.x == issuer) bulk_g2s(dst, src, (nb + 15) & ~15, bar);
  } else if (((reinterpret_cast<uintptr_t>(src) | unsigned(w)) & 3) == 0) {
    for (int k = t; k < ((nb + 3) >> 2); k += nt)
      cp_async4(dst + 4 * k, src + 4 * k);
  } else {
    for (int k = t; k < nb; k += nt) dst[k] = src[k];
  }
}

// The bytes stage_stream moves by bulk copy (what the mbarrier expects).
__device__ __forceinline__ int bulk_bytes(const uint8_t* base, int w,
                                          int nbytes = -1) {
  const int nb = nbytes < 0 ? w : nbytes;
  return (nb && ((reinterpret_cast<uintptr_t>(base) | unsigned(w)) & 15) == 0)
             ? (nb + 15) & ~15 : 0;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p,
                                            bool trans) {
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace ptx
