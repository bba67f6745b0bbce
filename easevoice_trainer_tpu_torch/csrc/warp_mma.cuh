// Warp-level tensor-core, ldmatrix and async-copy pieces shared by the
// kernels: K1 (prefill_attention.cu), K5 (prefill_attention_bwd*.cu), the
// K3/K4 loops (mrf_conv_tile.cuh, mrf_conv_tile_bf16.cuh) and K4-dW
// (mrf_conv_wgrad.cu).
//
// fp32 accuracy from TF32 tensor cores ("3xTF32"): every operand v is split
// as v = hi + lo, both TF32 (split_tf32), and each product is taken as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with fp32 accumulators (the lo*lo term,
// ~2^-22 relative, is dropped).  The bf16 loops take mma.sync.m16n8k16 in
// bf16 with fp32 accumulators (a product of two bf16 values is exact in
// fp32), their operands from shared memory by ldmatrix.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ev {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; ok = false writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4-byte copy for rows that are not 16-byte aligned; ok = false writes zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo: hi is v rounded to TF32 (10 mantissa bits, to nearest) by
// an integer add and mask, lo = v - hi exactly.  The tensor core reads the top 19 bits of
// each operand register, so lo enters truncated to TF32: |lo| <= 2^-11 |v|
// and the truncation costs at most 2^-10 |lo|.
__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
  lo = v - hi;
}

// d += a * b on one m16n8k8 TF32 tile.  A fragment: a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4) for row g = lane / 4, column t = lane % 4;
// B fragment: b0 (k = t, n = g), b1 (k = t+4, n = g); C fragment: c0 (g, 2t),
// c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 16-bit elements from shared memory, lanes 8i to
// 8i+7 giving the addresses of matrix i's eight 16-byte rows; d[i] is
// matrix i, lane l holding its row l / 4, elements 2(l % 4) and 2(l % 4)+1
// (.trans: its column l / 4, rows 2(l % 4) and 2(l % 4)+1)
__device__ __forceinline__ void ldsm4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4_trans(uint32_t (&d)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}

// The inverse of ldsm4: lanes 8i to 8i+7 give the addresses of matrix i's
// eight 16-byte rows, and s[i] of lane l is written to its row l / 4,
// elements 2(l % 4) and 2(l % 4)+1.  After ldsm4_trans of the same kind of
// rows, it writes the four 8 x 8 matrices transposed.
__device__ __forceinline__ void stsm4(uint32_t addr, const uint32_t (&s)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n" ::"r"(
          addr),
      "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3])
      : "memory");
}

// d += a * b on one m16n8k16 bf16 tile, fp32 accumulators.  A fragment:
// a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..) for
// row g = lane / 4, t = lane % 4; B: b0 (k = 2t..2t+1, n = g), b1 (k =
// 2t+8.., n = g); C: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
// In each 32-bit register the lower k (or column) is the low half.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same on one m16n8k8 tile: a0 (g, 2t..2t+1), a1 (g+8, 2t..); b0
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4],
                                            const uint32_t (&a)[2],
                                            uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

}  // namespace ev
