// Fragment pieces of the bf16 attention kernels, K1's
// (prefill_attention_bf16.cu) and K5's (prefill_attention_bwd_bf16.cu):
// rows of 32 bf16 head dims staged in shared memory LDS elements apart,
// read by ldmatrix into mma.sync.m16n8k16 (warp_mma.cuh); a warp's own 16
// rows as A fragments straight from device memory; P and dS, fp32 in the
// accumulators, as the A fragments of TERMS bf16 terms.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_io.cuh"
#include "warp_mma.cuh"

namespace ev {

// 2^x by the MUFU unit alone (exp2f adds a rescue of subnormal results,
// which only flushes P < 2^-126 to 0 here)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, zeros where !ok: by cp.async (ASYNC) or by a
// plain load and store
template <bool ASYNC>
__device__ __forceinline__ void stage16(bf16* dst, const bf16* src, bool ok) {
  if constexpr (ASYNC) {
    cp_async16(dst, src, ok);
  } else {
    *reinterpret_cast<uint4*>(dst) =
        ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
  }
}

// v = t[0] + t[1] + ... in bf16 terms for two values a (low half) and b
template <int TERMS>
__device__ __forceinline__ void split(float a, float b,
                                      uint32_t (&t)[TERMS]) {
#pragma unroll
  for (int i = 0; i < TERMS; ++i) {
    t[i] = narrow2(a, b);
    a -= bf16_lo(t[i]);
    b -= bf16_hi(t[i]);
  }
}

// Rows r0 + g and r0 + g + 8 of a view (time stride st, `base` at dim 0 of
// the head) as the A fragments of the two k16 steps over the head dims;
// rows at or past `end` are 0
__device__ __forceinline__ void load_a(const bf16* base, long long st,
                                       int r0, int end, int g, int t,
                                       uint32_t (&a)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(base + row * st);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      a[s][r] = row < end ? __ldg(p + 8 * s + t) : 0u;
      a[s][r + 2] = row < end ? __ldg(p + 8 * s + 4 + t) : 0u;
    }
  }
}

// B fragments over the head dims of rows x0..x0+7 of a staged tile (n8
// column g = row x0 + g): b[0], b[1] the k16 step of dims 0-15, b[2], b[3]
// of dims 16-31; with .trans, b[m] is the k8 step over those rows of dim
// tile m (dims 8m..8m+7)
template <int LDS, bool TRANS = false>
__device__ __forceinline__ void ldsm_dims(uint32_t (&b)[4], const bf16* tile,
                                          int x0, int lane) {
  const uint32_t a =
      smem_addr(tile + (x0 + (lane & 7)) * LDS + 8 * (lane >> 3));
  if constexpr (TRANS) {
    ldsm4_trans(b, a);
  } else {
    ldsm4(b, a);
  }
}

// B fragments of the k16 step over rows x0..x0+15 of a staged tile for dim
// tiles 2m and 2m+1: b[0], b[1] tile 2m, b[2], b[3] tile 2m+1
template <int LDS>
__device__ __forceinline__ void ldsm_rows(uint32_t (&b)[4], const bf16* tile,
                                          int x0, int m, int lane) {
  ldsm4_trans(b, smem_addr(tile + (x0 + (lane & 15)) * LDS +
                           8 * (2 * m + (lane >> 4))));
}

}  // namespace ev
