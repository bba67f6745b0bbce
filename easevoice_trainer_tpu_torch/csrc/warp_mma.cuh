// Warp-level tensor-core and async-copy pieces shared by K1
// (prefill_attention.cu) and the K3/K4 loops (mrf_conv_tile.cuh, and the
// async-copy pieces in mrf_conv_tile_bf16.cuh).
//
// fp32 accuracy from TF32 tensor cores ("3xTF32"): every operand v is split
// as v = hi + lo, both TF32 (split_tf32), and each product is taken as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with fp32 accumulators (the lo*lo term,
// ~2^-22 relative, is dropped).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ev {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; ok = false writes 16 zero bytes
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
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

}  // namespace ev
