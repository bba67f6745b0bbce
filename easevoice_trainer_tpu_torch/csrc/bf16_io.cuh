// Device-memory access of the bf16 instances of K1, K5 and K4-dW (K3 and
// K4-dx keep bf16 in shared memory: mrf_conv_tile_bf16.cuh): bf16
// elements widened to fp32 (exactly, by a shift of their bits) on the way in,
// fp32 results rounded to the nearest even bf16 on the way out.
//
// Why the fp32 loops carry over: a bf16 value has 8 significant bits and is
// exact in TF32 (11), so split_tf32 (warp_mma.cuh) gives it a zero lo half
// and one TF32 product replaces the three of 3xTF32; a product of two bf16
// values is exact in fp32, so the sums keep fp32 accuracy.  What the JAX
// package rounds to bf16 between two products (a leaky relu, a conv output,
// a bias or residual add) is rounded here at the same point (round_bf16).
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace ev {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// 8 elements at p (16-byte aligned) as floats
__device__ __forceinline__ void widen8(const bf16* p, float (&d)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  d[0] = bf16_lo(u.x); d[1] = bf16_hi(u.x);
  d[2] = bf16_lo(u.y); d[3] = bf16_hi(u.y);
  d[4] = bf16_lo(u.z); d[5] = bf16_hi(u.z);
  d[6] = bf16_lo(u.w); d[7] = bf16_hi(u.w);
}

// 4 elements at p (8-byte aligned) as a float4
__device__ __forceinline__ float4 widen4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                     bf16_hi(u.y));
}

// a at the lower address
__device__ __forceinline__ uint32_t narrow2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 floats rounded into p (16-byte aligned)
__device__ __forceinline__ void narrow8(bf16* p, const float (&d)[8]) {
  uint4 u;
  u.x = narrow2(d[0], d[1]);
  u.y = narrow2(d[2], d[3]);
  u.z = narrow2(d[4], d[5]);
  u.w = narrow2(d[6], d[7]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the store of one result: rounded for bf16, as is for fp32
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace ev
