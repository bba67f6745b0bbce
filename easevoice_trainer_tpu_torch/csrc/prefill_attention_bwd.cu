// K5: the gradient of K1 (GPT attention over [text; audio] under the hybrid
// mask) for the s1 fine-tune.
//
// Replaces: no Pallas kernel.  It is the gradient that jax.value_and_grad
// takes (easevoice_trainer_tpu/train/gpt_step.py:143) of
// TransformerLayer.attention with build_hybrid_mask_bias
// (easevoice_trainer_tpu/models/gpt/t2s.py:118-131, :173-199): dQ, dK and
// dV of O = softmax(Q K^T / sqrt(dk) + mask) V, the mask computed inline
// from x_len, x_lens and y_lens exactly as K1 computes it.
//
// The FlashAttention-2 backward, in three launches a call:
//   1. D = rowsum(dO * O), one thread a (row, head);
//   2. dK, dV: one block a 64-key tile of one (batch, head), walking the
//      64-row query tiles that can see it and recomputing P = exp(S - lse)
//      from K1's row logsumexp; dV += P^T dO, dS = P (dP - D) with
//      dP = dO V^T, dK += dS^T Q;
//   3. dQ: one block a 64-row query tile, walking its visible key tiles:
//      dQ += dS K.
// Every output element is summed by one thread in a fixed order: no float
// atomics, so repeated launches are bit-identical.  Every key and query
// row of the layout is written (zeros where nothing is visible), so the
// outputs need no clearing.
//
// Visibility, as in K1: text rows see the text keys below x_lens[b]; audio
// rows see those and, causally, the audio keys below x_len + y_lens[b].
// Pad rows (text rows at or past x_lens[b], audio rows at or past
// x_len + y_lens[b]) still attend over their visible keys and carry
// gradient (the GPT loss sums over every position, t2s.py:270-294), so no
// query row is skipped.  The tiles skipped are K1's: text keys at or past
// x_lens[b], audio keys at or past x_len + y_lens[b], audio keys for text
// rows, and audio keys past a query tile's causal reach.  A row with no
// visible key (text rows when x_lens[b] = 0: lse = -inf) gets P = 0 and
// finite zero gradients.
//
// Bound on the H100: at the s1 shapes (B = 8, H = 16, dk = 32, T up to
// 1776) the work is five dk-long products per visible (row, key) pair (S,
// dP, dV, dK, dQ; this kernel does S and dP twice, once in each walk): up
// to ~70 GFLOP a call at the long bucket against ~230 MB moved, so
// operations bound it.  This
// first kernel runs fp32 on the CUDA cores (67 TFLOP/s), not the tensor
// cores: a 4 x 4 register tile of (row, key) per thread for S and dP, read
// from d-major shared tiles by 16-byte loads, and 2 x 4 tiles for the
// dK / dV / dQ sums.
//
// Layout: q, k, v are (B, T, H, 32) fp32 views of the fused qkv projection
// sharing batch / time strides (in_sb, in_st; head stride 32, unit stride
// in dk); o and dout are (B, T, H, 32) contiguous; lse and dsum are
// (B, H, T); dq, dk, dv are (B, T, H, 32) views sharing (out_sb, out_st),
// e.g. the three slices of one (B, T, 3 * H * 32) gradient of the fused
// projection.  Strides are multiples of 4 floats and the pointers 16-byte
// aligned (the wrapper checks).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DK = 32;     // head width of the 512/16 GPT
constexpr int BQ = 64;     // query rows a tile
constexpr int BK = 64;     // keys a tile
constexpr int NT = 256;    // threads a block
constexpr int LDT = 68;    // row stride of the d-major and [64][64] tiles
constexpr int LDR = 36;    // row stride of the row-major [64][32] tiles
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// the hybrid mask (t2s.py:173-199) for one (row, key) of batch row b
__device__ __forceinline__ bool visible(int row, int key, int T, int x_len,
                                        int xv, int yv) {
  if (row >= T) return false;
  if (key < x_len) return key < xv;
  return row >= x_len && key <= row && key < x_len + yv;
}

// S = Q K^T and dP = dO V^T for the thread's 4 x 4 (row, key) tile:
// rows tr * 4 + i, keys tc * 4 + j, from the d-major tiles
__device__ __forceinline__ void scores(const float* sQt, const float* sKt,
                                       const float* sdOt, const float* sVt,
                                       int tr, int tc, float (&s)[4][4],
                                       float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DK; ++d) {
    const float4 qa = ld4(sQt + d * LDT + tr * 4);
    const float4 ka = ld4(sKt + d * LDT + tc * 4);
    const float4 ga = ld4(sdOt + d * LDT + tr * 4);
    const float4 va = ld4(sVt + d * LDT + tc * 4);
    const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
    const float kr[4] = {ka.x, ka.y, ka.z, ka.w};
    const float gr[4] = {ga.x, ga.y, ga.z, ga.w};
    const float vr[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
        dp[i][j] = fmaf(gr[i], vr[j], dp[i][j]);
      }
  }
}

// P and dS = P (dP - D) in place of s and dp; P = 0 where the mask hides
// the pair or the key is past kend
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* sLse, const float* sD,
                                      int q0, int k0, int kend, int tr,
                                      int tc, int T, int x_len, int xv,
                                      int yv, float c) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const float m = sLse[r], dsum = sD[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tc * 4 + j;
      const bool vis =
          key < kend && visible(q0 + r, key, T, x_len, xv, yv);
      const float p = vis ? exp2f(s[i][j] * c - m) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dsum);
    }
  }
}

// rows [r0, r0 + 64) of a (B, T, H, 32) tensor into d-major sT[d][row]
// (and row-major sR[row][d] when not null), zeros past `end`
__device__ __forceinline__ void load_tile(const float* base, long long st,
                                          int r0, int end, float* sT,
                                          float* sR, int tid) {
  for (int p = tid; p < 64 * DK / 4; p += NT) {
    const int r = p >> 3, c = (p & 7) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < end) a = ld4(base + (r0 + r) * st + c);
    if (sR != nullptr) st4(sR + r * LDR + c, a);
    sT[(c + 0) * LDT + r] = a.x;
    sT[(c + 1) * LDT + r] = a.y;
    sT[(c + 2) * LDT + r] = a.z;
    sT[(c + 3) * LDT + r] = a.w;
  }
}

__global__ void __launch_bounds__(NT) dsum_kernel(
    const float* __restrict__ o, const float* __restrict__ dout,
    float* __restrict__ dsum, int T, int H) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * NT + threadIdx.x;  // row * H + head
  if (idx >= T * H) return;
  const int row = idx / H, h = idx - row * H;
  const float* op = o + ((long long)b * T * H + idx) * DK;
  const float* gp = dout + ((long long)b * T * H + idx) * DK;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < DK; c += 4) {
    const float4 a = ld4(op + c), g = ld4(gp + c);
    acc = fmaf(a.x, g.x, acc);
    acc = fmaf(a.y, g.y, acc);
    acc = fmaf(a.z, g.z, acc);
    acc = fmaf(a.w, g.w, acc);
  }
  dsum[((long long)b * H + h) * T + row] = acc;
}

// shared memory of dkdv_kernel (floats): K^T, V^T, Q^T, dO^T, Q, dO, P,
// dS, lse, D
constexpr int DKDV_SMEM = 4 * DK * LDT + 2 * BQ * LDR + 2 * BQ * LDT + 2 * BQ;
// of dq_kernel: Q^T, dO^T, K^T, V^T, K, dS^T, lse, D
constexpr int DQ_SMEM = 4 * DK * LDT + BK * LDR + BK * LDT + 2 * BQ;

__global__ void __launch_bounds__(NT) dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dk, float* __restrict__ dv, long long in_sb,
    long long in_st, long long out_sb, long long out_st,
    const int* __restrict__ x_lens, const int* __restrict__ y_lens, int T,
    int H, int x_len, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sKt = smem;
  float* sVt = sKt + DK * LDT;
  float* sQt = sVt + DK * LDT;
  float* sdOt = sQt + DK * LDT;
  float* sQ = sdOt + DK * LDT;
  float* sdO = sQ + BQ * LDR;
  float* sP = sdO + BQ * LDR;
  float* sdS = sP + BQ * LDT;
  float* sLse = sdS + BQ * LDT;
  float* sD = sLse + BQ;

  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int xv = min(max(x_lens[b], 0), x_len);
  const int yv = min(max(y_lens[b], 0), T - x_len);
  const int n_text = (x_len + BK - 1) / BK;
  const bool text = (int)blockIdx.x < n_text;
  const int k0 = text ? blockIdx.x * BK : x_len + (blockIdx.x - n_text) * BK;
  const int k_write = min(k0 + BK, text ? x_len : T);  // keys written
  const int kend = min(k0 + BK, text ? xv : x_len + yv);  // keys seen

  // thread tiles: (row, key) tr, tc for S / dP; (key pair, dim quad) for
  // the dK / dV sums
  const int tr = tid >> 4, tc = tid & 15;
  const int kq = tid >> 3, dq = tid & 7;
  float acc_dv[2][4], acc_dk[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dv[a][e] = acc_dk[a][e] = 0.f;

  if (kend > k0) {
    const long long head = (long long)b * in_sb + h * DK;
    load_tile(k + head, in_st, k0, kend, sKt, nullptr, tid);
    load_tile(v + head, in_st, k0, kend, sVt, nullptr, tid);
    const float c = scale * LOG2E;
    const long long lrow = ((long long)b * H + h) * T;
    const long long orow = (long long)b * T * H * DK + h * DK;
    // text keys: every row sees them; audio keys: rows from k0 on
    for (int q0 = text ? 0 : k0; q0 < T; q0 += BQ) {
      __syncthreads();  // the previous query tile is consumed
      load_tile(q + head, in_st, q0, T, sQt, sQ, tid);
      load_tile(dout + orow, (long long)H * DK, q0, T, sdOt, sdO, tid);
      if (tid < BQ) {
        const int row = q0 + tid;
        sLse[tid] = row < T ? lse[lrow + row] * LOG2E : 0.f;
        sD[tid] = row < T ? dsum[lrow + row] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      scores(sQt, sKt, sdOt, sVt, tr, tc, s, dp);
      probs(s, dp, sLse, sD, q0, k0, kend, tr, tc, T, x_len, xv, yv, c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st4(sP + (tr * 4 + i) * LDT + tc * 4,
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]));
        st4(sdS + (tr * 4 + i) * LDT + tc * 4,
            make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]));
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const float2 p2 = ld2(sP + r * LDT + kq * 2);
        const float2 s2 = ld2(sdS + r * LDT + kq * 2);
        const float4 g = ld4(sdO + r * LDR + dq * 4);
        const float4 x = ld4(sQ + r * LDR + dq * 4);
        const float gr[4] = {g.x, g.y, g.z, g.w};
        const float xr[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc_dv[0][e] = fmaf(p2.x, gr[e], acc_dv[0][e]);
          acc_dv[1][e] = fmaf(p2.y, gr[e], acc_dv[1][e]);
          acc_dk[0][e] = fmaf(s2.x, xr[e], acc_dk[0][e]);
          acc_dk[1][e] = fmaf(s2.y, xr[e], acc_dk[1][e]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int key = k0 + kq * 2 + a;
    if (key >= k_write) continue;
    const long long at =
        (long long)b * out_sb + key * out_st + h * DK + dq * 4;
    st4(dv + at, make_float4(acc_dv[a][0], acc_dv[a][1], acc_dv[a][2],
                             acc_dv[a][3]));
    st4(dk + at, make_float4(acc_dk[a][0] * scale, acc_dk[a][1] * scale,
                             acc_dk[a][2] * scale, acc_dk[a][3] * scale));
  }
}

__global__ void __launch_bounds__(NT) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dq, long long in_sb, long long in_st,
    long long out_sb, long long out_st, const int* __restrict__ x_lens,
    const int* __restrict__ y_lens, int T, int H, int x_len, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;
  float* sdOt = sQt + DK * LDT;
  float* sKt = sdOt + DK * LDT;
  float* sVt = sKt + DK * LDT;
  float* sK = sVt + DK * LDT;
  float* sdSt = sK + BK * LDR;
  float* sLse = sdSt + BK * LDT;
  float* sD = sLse + BQ;

  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int xv = min(max(x_lens[b], 0), x_len);
  const int yv = min(max(y_lens[b], 0), T - x_len);
  // keys the tile's rows see: text [0, xv), audio [x_len, a_end)
  const int q_last = min(q0 + BQ, T) - 1;
  const int a_end = q_last >= x_len ? min(q_last + 1, x_len + yv) : x_len;
  const int n_text = (xv + BK - 1) / BK;
  const int n_tiles = n_text + (a_end - x_len + BK - 1) / BK;

  const long long head = (long long)b * in_sb + h * DK;
  const long long lrow = ((long long)b * H + h) * T;
  load_tile(q + head, in_st, q0, T, sQt, nullptr, tid);
  load_tile(dout + (long long)b * T * H * DK + h * DK, (long long)H * DK, q0,
            T, sdOt, nullptr, tid);
  if (tid < BQ) {
    const int row = q0 + tid;
    sLse[tid] = row < T ? lse[lrow + row] * LOG2E : 0.f;
    sD[tid] = row < T ? dsum[lrow + row] : 0.f;
  }
  const int tr = tid >> 4, tc = tid & 15;
  const int rq = tid >> 3, dq4 = tid & 7;  // rows rq * 2 + a, dims dq4 * 4
  float acc[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
  const float c = scale * LOG2E;

  for (int i = 0; i < n_tiles; ++i) {
    const bool text = i < n_text;
    const int k0 = text ? i * BK : x_len + (i - n_text) * BK;
    const int kend = min(k0 + BK, text ? xv : a_end);
    __syncthreads();  // the previous key tile is consumed
    load_tile(k + head, in_st, k0, kend, sKt, sK, tid);
    load_tile(v + head, in_st, k0, kend, sVt, nullptr, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores(sQt, sKt, sdOt, sVt, tr, tc, s, dp);
    probs(s, dp, sLse, sD, q0, k0, kend, tr, tc, T, x_len, xv, yv, c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st4(sdSt + (tc * 4 + j) * LDT + tr * 4,
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]));
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      const float2 d2 = ld2(sdSt + key * LDT + rq * 2);
      const float4 kk = ld4(sK + key * LDR + dq4 * 4);
      const float kr[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[0][e] = fmaf(d2.x, kr[e], acc[0][e]);
        acc[1][e] = fmaf(d2.y, kr[e], acc[1][e]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = q0 + rq * 2 + a;
    if (row >= T) continue;
    st4(dq + (long long)b * out_sb + row * out_st + h * DK + dq4 * 4,
        make_float4(acc[a][0] * scale, acc[a][1] * scale, acc[a][2] * scale,
                    acc[a][3] * scale));
  }
}

cudaError_t set_smem() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady) {
    done = cudaFuncSetAttribute(dkdv_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                DKDV_SMEM * (int)sizeof(float));
    if (done == cudaSuccess)
      done = cudaFuncSetAttribute(dq_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  DQ_SMEM * (int)sizeof(float));
  }
  return done;
}

}  // namespace

// dq, dk, dv of K1 at (q, k, v, x_len, x_lens, y_lens), given K1's o and
// lse and the output gradient dout; dsum is B * H * T floats of scratch.
// Three launches on `stream`; returns the first CUDA error.
extern "C" int ev_prefill_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, long long in_sb, long long in_st, long long out_sb,
    long long out_st, const void* x_lens, const void* y_lens, int B, int T,
    int H, int x_len, float scale, void* stream) {
  if (B < 1 || T < 1 || H < 1 || x_len < 0 || x_len > T)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem();
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  dsum_kernel<<<dim3((T * H + NT - 1) / NT, B), NT, 0, s>>>(
      (const float*)o, (const float*)dout, (float*)dsum, T, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int key_tiles = (x_len + BK - 1) / BK + (T - x_len + BK - 1) / BK;
  dkdv_kernel<<<dim3(key_tiles, H, B), NT, DKDV_SMEM * sizeof(float), s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)dsum, (float*)dk, (float*)dv, in_sb,
      in_st, out_sb, out_st, (const int*)x_lens, (const int*)y_lens, T, H,
      x_len, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_kernel<<<dim3((T + BQ - 1) / BQ, H, B), NT, DQ_SMEM * sizeof(float),
              s>>>((const float*)q, (const float*)k, (const float*)v,
                   (const float*)dout, (const float*)lse, (const float*)dsum,
                   (float*)dq, in_sb, in_st, out_sb, out_st,
                   (const int*)x_lens, (const int*)y_lens, T, H, x_len,
                   scale);
  return (int)cudaGetLastError();
}
