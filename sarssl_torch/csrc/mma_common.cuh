// Tensor-core and asynchronous-copy primitives shared by the kernels that
// multiply with mma.sync (attention_mma.cu, attention_f32_mma.cu,
// conv3x3_mma.cu): cp.async copies of 16, 8 and 4 bytes, ldmatrix loads of four
// 8x8 bf16 matrices (or, read as 32-bit words, four 8x4 f32 ones), the
// m16n8k16 bf16 -> f32 product and the f32 -> packed bf16 conversion, and the
// m16n8k8 TF32 product with the split that makes three of them about as
// exact as an f32 product (3xTF32); the wgmma fence, commit and wait of the
// sources that multiply with wgmma (conv3x3_mma.cu, conv3x3_any_mma.cu,
// conv3x3_tf32.cu), and the 128-byte swizzle, its shared-memory descriptor
// and the launch helper that the last two share.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
// copies `bytes` (0 or 16) from src and fills the rest of the 16 with zeros
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
// copies `bytes` (0 or 4) from src and fills the rest of the 4 with zeros
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
// copies `bytes` (0 or 8) from src and fills the rest of the 8 with zeros
__device__ __forceinline__ void cp_async8_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
// 16 zero bytes at shared address `addr`
__device__ __forceinline__ void st_shared_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(0), "r"(0), "r"(0),
               "r"(0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats -> packed bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16x8, f32) += a (16x8, tf32, row) * b (8x8, tf32, col). Fragments: a[0]
// (row g, col t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4); b0
// (row t, col g), b1 (t + 4, g); c as mma16816's, with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// f32 -> tf32 in a 32-bit word: round to nearest, ties away from zero, the
// 13 low mantissa bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo to about 2^-22 of x: hi = tf32(x), lo = tf32(x - hi) (x - hi is
// exact in f32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
// c += a b from split operands (3xTF32): the two small products first, then
// hi * hi; the lo * lo term (about 2^-22 of the product) is left out
__device__ __forceinline__ void mma1688_3x(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma1688(c, al, bh0, bh1);
  mma1688(c, ah, bl0, bl1);
  mma1688(c, ah, bh0, bh1);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// byte offset of 16-byte piece `piece` of row `idx` of 128-byte rows (a
// pixel's K chunk, or a weight block's output channel) in the 128-byte swizzle
__device__ __forceinline__ uint32_t swz128(int idx, int piece) {
  return (uint32_t)(idx * 128 + ((piece ^ (idx & 7)) << 4));
}
// wgmma descriptor of a K-major operand of 128-byte rows in the 128-byte
// swizzle, eight rows a 1024-byte period (the stride field); `addr` a
// multiple of 1024. A step of 32 bytes along K (a bf16 k16 or a tf32 k8) adds
// 2 to it (the start address in 16-byte units).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the blocks the card holds at once of `kernel` at `threads` a block and
// `bytes` of shared memory, found on the first call for each device (the
// shared-memory attribute is set there too); `slots_of` is the kernel's own
// table
template <class K>
cudaError_t card_slots(K kernel, int threads, int bytes, int (&slots_of)[16], int& slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 16) return cudaErrorInvalidDevice;
  if (slots_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    bytes)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes)) !=
            cudaSuccess)
      return err;
    slots_of[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  slots = slots_of[dev];
  return cudaSuccess;
}
