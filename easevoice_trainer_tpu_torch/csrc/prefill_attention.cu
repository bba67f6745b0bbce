// K1: GPT prefill attention over [text; audio prompt] with the hybrid mask
// computed inline from three lengths.
//
// Replaces: the Pallas kernel flash_prefill_attention
// (easevoice_trainer_tpu/ops/pallas/flash_prefill.py `_kernel`, git 0ec4461),
// i.e. TransformerLayer.attention + build_hybrid_mask_bias
// (easevoice_trainer_tpu/models/gpt/t2s.py:118-131, :173-199) as the prefill
// runs them.
//
// Bound on the H100: at T <= ~600 and dk = 32 the work is tiny (B*H*T*T*dk*4
// flops, ~0.1 GFLOP at B=4), so the kernel is bound by latency and by the
// bytes of a dense (B, H, T, T) score/bias tensor that the plain version
// writes and reads several times.  Design: one block per (q-tile, head,
// batch row), one thread per query row; K/V stream through shared memory in
// 64-key tiles with an online softmax, and the mask is evaluated from
// (x_len, x_lens[b], y_lens[b]) per score, so no (T, T) tensor exists.  Key
// tiles past the last row's causal reach are never loaded.
//
// Layout: q/k/v are (B, T, H, 32) fp32 views whose head stride is 32 and
// element stride 1 (the split of the fused qkv projection); the batch and
// time strides are passed in.  o is (B, T, H, 32) with its own strides.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DK = 32;   // head width of the 512/16 GPT
constexpr int BQ = 64;   // query rows per block, one per thread
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int CH = 16;   // keys folded into the running softmax at once

__global__ void __launch_bounds__(BQ) prefill_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, long long o_sb, long long o_st,
    const int* __restrict__ x_lens, const int* __restrict__ y_lens,
    int T, int x_len, float scale) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int row = q0 + tid;
  const int xv = x_lens[b];
  const int yv = y_lens[b];

  __shared__ float sq[BQ][DK + 1];  // +1: row-per-thread reads hit distinct banks
  __shared__ float sk[BK][DK];
  __shared__ float sv[BK][DK];

  const float* qb = q + b * q_sb + h * DK;
  for (int idx = tid; idx < BQ * DK; idx += BQ) {
    const int r = idx / DK, c = idx % DK;
    const int t = q0 + r;
    sq[r][c] = t < T ? qb[(long long)t * q_st + c] : 0.f;
  }
  __syncthreads();

  float qr[DK], acc[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d) {
    qr[d] = sq[tid][d] * scale;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  // text rows see keys < x_len only; audio rows reach their own position
  int kend = q0 + BQ > x_len ? q0 + BQ : x_len;
  if (kend > T) kend = T;

  const float* kb = k + b * k_sb + h * DK;
  const float* vb = v + b * v_sb + h * DK;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    for (int idx = tid; idx < BK * DK; idx += BQ) {
      const int r = idx / DK, c = idx % DK;
      const int t = k0 + r;
      const bool in = t < T;
      sk[r][c] = in ? kb[(long long)t * k_st + c] : 0.f;
      sv[r][c] = in ? vb[(long long)t * v_st + c] : 0.f;
    }
    __syncthreads();

    for (int c0 = 0; c0 < BK && k0 + c0 < kend; c0 += CH) {
      float s[CH];
      float mc = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = k0 + c0 + jj;
        bool visible;
        if (j >= T) {
          visible = false;
        } else if (j < x_len) {
          visible = j < xv;
        } else {
          visible = row >= x_len && j <= row && j - x_len < yv;
        }
        float dot = -INFINITY;
        if (visible) {
          dot = 0.f;
#pragma unroll
          for (int d = 0; d < DK; ++d) dot = fmaf(qr[d], sk[c0 + jj][d], dot);
          mc = fmaxf(mc, dot);
        }
        s[jj] = dot;
      }
      if (mc == -INFINITY) continue;
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DK; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < DK; ++d) acc[d] = fmaf(p, sv[c0 + jj][d], acc[d]);
      }
      m = m_new;
    }
    __syncthreads();
  }

  if (row < T) {
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a row with no visible key emits 0
    float* ob = o + b * o_sb + (long long)row * o_st + h * DK;
#pragma unroll
    for (int d = 0; d < DK; ++d) ob[d] = acc[d] * inv;
  }
}

}  // namespace

extern "C" int ev_prefill_attention_f32(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, long long o_sb, long long o_st,
    const void* x_lens, const void* y_lens, int B, int T, int H, int x_len,
    float scale, void* stream) {
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  prefill_attention_kernel<<<grid, BQ, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, q_sb, q_st,
      k_sb, k_st, v_sb, v_st, o_sb, o_st, (const int*)x_lens,
      (const int*)y_lens, T, x_len, scale);
  return (int)cudaGetLastError();
}
