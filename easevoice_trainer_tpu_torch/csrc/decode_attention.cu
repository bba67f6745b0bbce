// K2: single-token decode attention over one layer's KV cache, with the
// cache-validity test computed inline.
//
// Replaces: no Pallas kernel; it carries the per-layer attention of
// Text2SemanticDecoder.decode_step (easevoice_trainer_tpu/models/gpt/
// t2s.py:356-376) together with the kv_bias of the decode loop
// (easevoice_trainer_tpu/models/gpt/decode.py:141-156).
//
// Bound on the H100: the bytes of the cache.  Each (b, h) reads 2 * 32 * 4
// bytes per valid slot and does 128 flops on them, far below the card's
// flop/byte balance.  Design: one block per (head, batch row), one thread per
// slot in turn with 16-byte loads of whole 128-byte rows, a private online
// softmax per thread, then one merge across the block through warp shuffles
// and shared memory.  Only valid slots are read: [0, x_lens[b]) of the text
// and [x_len, kv_end) of prompt + generated tokens; the text pads in the
// middle of the cache (slots x_lens[b] .. x_len-1) are skipped, so the plain
// version's (B, 1, 1, cache_len) bias is never built.
//
// Layout: q is (B, H, 32) contiguous, the caches are (B, cache_len, H, 32)
// contiguous (one layer of the (L, B, cache_len, H, dk) stack), o is
// (B, H, 32).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DK = 32;
constexpr int NT = 128;
constexpr int NW = NT / 32;

__global__ void __launch_bounds__(NT) decode_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ kc,
    const float* __restrict__ vc, float* __restrict__ o,
    const int* __restrict__ x_lens, int H, int cache_len, int x_len,
    int kv_end, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  float qr[DK], acc[DK];
  const float4* q4 = reinterpret_cast<const float4*>(q + ((long long)b * H + h) * DK);
#pragma unroll
  for (int i = 0; i < DK / 4; ++i) {
    const float4 t = q4[i];
    qr[4 * i] = t.x * scale;
    qr[4 * i + 1] = t.y * scale;
    qr[4 * i + 2] = t.z * scale;
    qr[4 * i + 3] = t.w * scale;
  }
#pragma unroll
  for (int d = 0; d < DK; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  int n_text = x_lens[b];
  if (n_text > x_len) n_text = x_len;
  const int total = n_text + (kv_end - x_len);
  for (int i = tid; i < total; i += NT) {
    const int s = i < n_text ? i : x_len + (i - n_text);
    const long long off = (((long long)b * cache_len + s) * H + h) * DK;
    const float4* k4 = reinterpret_cast<const float4*>(kc + off);
    const float4* v4 = reinterpret_cast<const float4*>(vc + off);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < DK / 4; ++j) {
      const float4 t = k4[j];
      dot = fmaf(qr[4 * j], t.x, dot);
      dot = fmaf(qr[4 * j + 1], t.y, dot);
      dot = fmaf(qr[4 * j + 2], t.z, dot);
      dot = fmaf(qr[4 * j + 3], t.w, dot);
    }
    const float m_new = fmaxf(m, dot);
    const float alpha = expf(m - m_new);
    const float p = expf(dot - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int j = 0; j < DK / 4; ++j) {
      const float4 t = v4[j];
      acc[4 * j] = fmaf(acc[4 * j], alpha, p * t.x);
      acc[4 * j + 1] = fmaf(acc[4 * j + 1], alpha, p * t.y);
      acc[4 * j + 2] = fmaf(acc[4 * j + 2], alpha, p * t.z);
      acc[4 * j + 3] = fmaf(acc[4 * j + 3], alpha, p * t.w);
    }
    m = m_new;
  }

  // merge the per-thread softmax states: block max first, then rescaled sums
  __shared__ float s_m[NW];
  __shared__ float s_acc[NW][DK + 1];
  float mw = m;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, off));
  if (lane == 0) s_m[warp] = mw;
  __syncthreads();
  float mb = s_m[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) mb = fmaxf(mb, s_m[w]);
  const float f = m == -INFINITY ? 0.f : expf(m - mb);
  l *= f;
#pragma unroll
  for (int d = 0; d < DK; ++d) acc[d] *= f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int d = 0; d < DK; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < DK; ++d) s_acc[warp][d] = acc[d];
    s_acc[warp][DK] = l;
  }
  __syncthreads();
  if (tid < DK) {
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      num += s_acc[w][tid];
      den += s_acc[w][DK];
    }
    o[((long long)b * H + h) * DK + tid] = den > 0.f ? num / den : 0.f;
  }
}

}  // namespace

extern "C" int ev_decode_attention_f32(
    const void* q, const void* k_cache, const void* v_cache, void* o,
    const void* x_lens, int B, int H, int cache_len, int x_len, int kv_end,
    float scale, void* stream) {
  const dim3 grid(H, B);
  decode_attention_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k_cache, (const float*)v_cache,
      (float*)o, (const int*)x_lens, H, cache_len, x_len, kv_end, scale);
  return (int)cudaGetLastError();
}
