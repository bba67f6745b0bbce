// K1: GPT prefill attention over [text; audio prompt] with the hybrid mask
// computed inline from three lengths; its instance at head width 64 is the
// encoders' attention (BERT, G2PW's BERT, HuBERT, Whisper's encoder), and
// its dk-32 instance with no audio part is CT-punc's.
//
// Replaces: the Pallas kernel flash_prefill_attention
// (easevoice_trainer_tpu/ops/pallas/flash_prefill.py `_kernel`, git 0ec4461),
// i.e. TransformerLayer.attention + build_hybrid_mask_bias
// (easevoice_trainer_tpu/models/gpt/t2s.py:118-131, :173-199) as the prefill
// runs them; at dk = 64 the BERT self-attention with its key-padding bias
// (easevoice_trainer_tpu/models/bert.py:49-56, :88-91; no Pallas ancestor),
// which is the hybrid mask with x_len = T and no audio part.
//
// Bound on the H100: at T <= ~600 and dk = 32 the bytes (q, k, v, o once:
// 10 MB at the serving shape, 3 us) and the flops (~0.1 GFLOP) are both
// tiny, so what limits it is latency and parallelism.  Design, a flash
// attention on the tensor cores:
//
// - mma.sync m16n8k8 TF32 in 3xTF32 (warp_mma.cuh), so scores and outputs
//   keep fp32 accuracy.  One warp owns 16 query rows; its Q fragments are
//   split into hi/lo once and stay in registers.  Per key tile it computes
//   S = Q K^T, runs the online softmax on the accumulator fragments (row
//   max and sum across the 4 lanes of a row by shuffles), and multiplies P
//   by V straight from the accumulator registers.
// - No shuffles to bring P into A-fragment layout: a k-step's slot t is key
//   2t and slot t+4 key 2t+1 of its 8 keys (c0/c1 of the score tile become
//   a0/a2), and V's B fragment reads its rows in the same order.  The head
//   dimension is permuted the same way on both sides of each product (for
//   Q K^T, k-step s slot t is dim 8t+2s, slot t+4 dim 8t+2s+1; for P V, n8
//   tile n column g is dim 4g+n), so every fragment of K, V and O is two
//   16-byte accesses of one row.  Shared rows are 36 floats (4 mod 32):
//   those 16-byte loads hit distinct banks.
// - Head width 64 (the encoders) is two 32-wide halves, each laid out as
//   above: half f holds dims 32f..32f+31, k-steps 4f..4f+3 of Q K^T and n8
//   tiles 4f..4f+3 of P V.  Shared rows are 68 floats (4 mod 32), so a
//   quarter warp's 16-byte loads again cover 8 distinct bank quads; K is
//   read one half at a time to keep its registers at 32.  This instance
//   writes no lse (no encoder is trained) and its caller passes x_len = T,
//   so every key tile is a text tile and the audio walk is empty.
// - 2 warps (32 query rows) a block: a (10, 16, 4) grid of 640 blocks at
//   the serving shape, one wave.  32-key tiles of K and V come in by
//   cp.async in a 2-stage ring shared by both warps.
// - Tile-level mask: the block walks only the text keys below x_lens[b] and
//   the audio keys up to the causal reach of its last row (and below
//   x_len + y_lens[b]); text pads and keys past the causal reach are never
//   loaded.  A tile wholly visible to a warp runs with no mask test, a tile
//   wholly hidden from it (past its rows' reach, or audio for text rows) is
//   skipped, and only boundary tiles test each score.
//
// Layout: q/k/v are (B, T, H, dk) fp32 views whose head stride is dk and
// element stride 1 (the split of the fused qkv projection); the batch and
// time strides are passed in, multiples of 4 floats, and the pointers are
// 16-byte aligned (the wrapper checks).  o is (B, T, H, dk) contiguous.
// lse, when not null, is (B, H, T) fp32: each row's logsumexp of its
// visible scaled scores in natural-log units, -inf for a row that sees no
// key (its o is 0); the training backward (K5, prefill_attention_bwd.cu)
// recomputes P = exp(S - lse) from it.  The row state it is written from is
// the online softmax's own, so o is the same with or without it.
//
// Dropout (the s1 fine-tune with T2SConfig.dropout > 0; JAX drops the
// probabilities after the softmax, models/gpt/t2s.py:128): the instance
// with DROP draws each visible pair's keep bit M from Philox (philox.cuh)
// right after the exponent and zeroes the dropped P elements before they
// enter P V, ahead of the 3xTF32 split; the row max m, the row sum l and
// the lse stay the undropped softmax's, and 1 / (1 - p) is folded into the
// final 1 / l, so o = (P o M / (1 - p)) V with P normalised by the undropped
// sum.  Lanes t and t ^ 1 share one Philox call of four keys: each draws the
// bits of one of its two rows and they trade them by a shuffle.  K5 draws
// the same bits again.  The instances without DROP are the code above,
// unchanged.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "warp_mma.cuh"

namespace {

using namespace ev;

constexpr int WARPS = 2;
constexpr int NTHREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block
constexpr int BKT = 32;         // keys per staged tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void split2(float v, uint32_t& hi, uint32_t& lo) {
  float h, l;
  split_tf32(v, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
}

// DK: 32 (the 512/16 GPT) or 64 (the encoders: 1024/16, 768/12); DROP:
// the s1 fine-tune's dropout on P (DK 32 only)
template <int DK, bool DROP = false>
__global__ void __launch_bounds__(NTHREADS) prefill_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, long long q_sb, long long q_st, long long k_sb,
    long long k_st, long long v_sb, long long v_st,
    const int* __restrict__ x_lens, const int* __restrict__ y_lens, int T,
    int H, int x_len, float scale, const Dropout drop) {
  static_assert(DK == 32 || DK == 64, "K1 is written for dk 32 and 64");
  static_assert(!DROP || DK == 32, "dropout is the GPT's alone");
  constexpr int LDS = DK + 4;   // shared row stride in floats, 4 mod 32
  constexpr int NS = DK / 8;    // k-steps of Q K^T, n8 tiles of P V
  constexpr int HALVES = DK / 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int r0 = q0 + warp * 16;  // the warp's first row
  const int xv = min(max(x_lens[b], 0), x_len);
  const int yv = min(max(y_lens[b], 0), T - x_len);

  // keys the block walks: text [0, xv), audio [x_len, a_end)
  const int q_last = min(q0 + BQ, T) - 1;
  const int a_end = q_last >= x_len ? min(q_last + 1, x_len + yv) : x_len;
  const int n_text = (xv + BKT - 1) / BKT;
  const int n_tiles = n_text + (a_end - x_len + BKT - 1) / BKT;

  __shared__ __align__(16) float sk[2][BKT][LDS];
  __shared__ __align__(16) float sv[2][BKT][LDS];

  const float* kb = k + b * k_sb + h * DK;
  const float* vb = v + b * v_sb + h * DK;
  auto issue = [&](int i, int slot) {
    if (i < n_tiles) {
      const int k0 = i < n_text ? i * BKT : x_len + (i - n_text) * BKT;
      const int kend = i < n_text ? xv : a_end;
      for (int p = tid; p < BKT * DK / 4; p += NTHREADS) {
        const int r = p >> (DK == 64 ? 4 : 3), c = (p & (DK / 4 - 1)) * 4;
        const int key = k0 + r;
        const bool ok = key < kend;
        cp_async16(&sk[slot][r][c], ok ? kb + key * k_st + c : kb, ok);
        cp_async16(&sv[slot][r][c], ok ? vb + key * v_st + c : vb, ok);
      }
    }
    cp_async_commit();
  };
  issue(0, 0);
  issue(1, 1);

  // Q fragments, split once: k-step s = 4f+u reads dims 32f+8t+2u (slots
  // t) and 32f+8t+2u+1 (slots t+4) of rows g and g+8
  uint32_t qh[NS][4], ql[NS][4];
  {
    float qa[2 * NS], qc[2 * NS];
    const float* qb = q + b * q_sb + h * DK + 8 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + g + 8 * half;
      float* dst = half ? qc : qa;
      float4 lo4[HALVES], hi4[HALVES];
#pragma unroll
      for (int f = 0; f < HALVES; ++f)
        lo4[f] = hi4[f] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < T) {
#pragma unroll
        for (int f = 0; f < HALVES; ++f) {
          lo4[f] = *reinterpret_cast<const float4*>(qb + row * q_st + 32 * f);
          hi4[f] =
              *reinterpret_cast<const float4*>(qb + row * q_st + 32 * f + 4);
        }
      }
#pragma unroll
      for (int f = 0; f < HALVES; ++f) {
        float* d = dst + 8 * f;
        d[0] = lo4[f].x; d[1] = lo4[f].y; d[2] = lo4[f].z; d[3] = lo4[f].w;
        d[4] = hi4[f].x; d[5] = hi4[f].y; d[6] = hi4[f].z; d[7] = hi4[f].w;
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      split2(qa[2 * s], qh[s][0], ql[s][0]);
      split2(qc[2 * s], qh[s][1], ql[s][1]);
      split2(qa[2 * s + 1], qh[s][2], ql[s][2]);
      split2(qc[2 * s + 1], qh[s][3], ql[s][3]);
    }
  }

  // O accumulators: tile n = 4f+u, c0 = row g dim 32f+8t+u, c1 = row g
  // dim 32f+8t+4+u, c2/c3 the same for row g+8
  float oacc[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float c = scale * LOG2E;
  const int rows[2] = {r0 + g, r0 + g + 8};
  const int r_hi = r0 + 15;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();
    __syncthreads();
    const int slot = i & 1;
    const bool text = i < n_text;
    const int k0 = text ? i * BKT : x_len + (i - n_text) * BKT;
    // hidden from every row of the warp: audio keys for text rows, or keys
    // past the last row's causal reach
    const bool hidden = !text && (r_hi < x_len || k0 > r_hi);
    if (!hidden) {
      const bool full = text ? k0 + BKT <= xv
                             : (r0 >= x_len && k0 + BKT - 1 <= r0 &&
                                k0 + BKT <= x_len + yv);
      // S = Q K^T: key tile n holds keys k0 + 8n + g (B column g); K is
      // read one 32-dim half at a time
      float sacc[4][4];
#pragma unroll
      for (int f = 0; f < HALVES; ++f) {
        float kr[4][8];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float* row = &sk[slot][8 * n + g][32 * f + 8 * t];
          const float4 a = *reinterpret_cast<const float4*>(row);
          const float4 d = *reinterpret_cast<const float4*>(row + 4);
          kr[n][0] = a.x; kr[n][1] = a.y; kr[n][2] = a.z; kr[n][3] = a.w;
          kr[n][4] = d.x; kr[n][5] = d.y; kr[n][6] = d.z; kr[n][7] = d.w;
          if (f == 0) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = 4 * f + u;
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            split2(kr[n][2 * u], bh[n][0], bl[n][0]);
            split2(kr[n][2 * u + 1], bh[n][1], bl[n][1]);
          }
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_tf32(sacc[n], ql[s], bh[n][0], bh[n][1]);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_tf32(sacc[n], qh[s], bl[n][0], bl[n][1]);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_tf32(sacc[n], qh[s], bh[n][0], bh[n][1]);
        }
      }
      // scale into log2 units and mask; element e of tile n is row
      // rows[e >> 1], key k0 + 8n + 2t + (e & 1)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sacc[n][e] * c;
          if (!full) {
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            const int row = rows[e >> 1];
            const bool vis = text ? key < xv
                                  : (row >= x_len && key <= row &&
                                     key < x_len + yv);
            s = vis ? s : -INFINITY;
          }
          sacc[n][e] = s;
        }
      // online softmax, rows g (e = 0, 1) and g+8 (e = 2, 3)
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mx = fmaxf(mx, fmaxf(sacc[n][2 * r], sacc[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float base = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2f(m[r] - base);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          sacc[n][2 * r] = exp2f(sacc[n][2 * r] - base);
          sacc[n][2 * r + 1] = exp2f(sacc[n][2 * r + 1] - base);
          sum += sacc[n][2 * r] + sacc[n][2 * r + 1];
        }
        l[r] = l[r] * alpha[r] + sum;  // this lane's part of the row sum
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        oacc[n][0] *= alpha[0];
        oacc[n][1] *= alpha[0];
        oacc[n][2] *= alpha[1];
        oacc[n][3] *= alpha[1];
      }
      if constexpr (DROP) {  // P o M, after the row sums took P
        const int group = (text ? k0 : k0 - x_len) / 4;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint32_t keep =
              keep_rows(drop, b, h, rows, group + 2 * n, !text, t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sacc[n][e] = keep >> e & 1u ? sacc[n][e] : 0.f;
        }
      }
      // O += P V: k-step j is score tile j (slot t = key 8j+2t, slot t+4 =
      // key 8j+2t+1), n8 tile 4f+u column g is dim 32f+4g+u
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t ah[4], al[4];
        split2(sacc[j][0], ah[0], al[0]);
        split2(sacc[j][2], ah[1], al[1]);
        split2(sacc[j][1], ah[2], al[2]);
        split2(sacc[j][3], ah[3], al[3]);
#pragma unroll
        for (int f = 0; f < HALVES; ++f) {
          const float4 v0 = *reinterpret_cast<const float4*>(
              &sv[slot][8 * j + 2 * t][32 * f + 4 * g]);
          const float4 v1 = *reinterpret_cast<const float4*>(
              &sv[slot][8 * j + 2 * t + 1][32 * f + 4 * g]);
          const float va[4] = {v0.x, v0.y, v0.z, v0.w};
          const float vc[4] = {v1.x, v1.y, v1.z, v1.w};
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            split2(va[n], bh[n][0], bl[n][0]);
            split2(vc[n], bh[n][1], bl[n][1]);
          }
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_tf32(oacc[4 * f + n], al, bh[n][0], bh[n][1]);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_tf32(oacc[4 * f + n], ah, bl[n][0], bl[n][1]);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_tf32(oacc[4 * f + n], ah, bh[n][0], bh[n][1]);
        }
      }
    }
    __syncthreads();  // both warps are done with this slot
    issue(i + 2, slot);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= T) continue;
    float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no visible key: 0
    if constexpr (DROP) inv *= drop.inv_keep;
    if constexpr (DK == 32) {
      if (lse != nullptr && t == 0)  // m and l are in log2 units
        lse[((long long)b * H + h) * T + row] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : -INFINITY;
    }
#pragma unroll
    for (int f = 0; f < HALVES; ++f) {
      float* ob =
          o + (((long long)b * T + row) * H + h) * DK + 32 * f + 8 * t;
      *reinterpret_cast<float4*>(ob) =
          make_float4(oacc[4 * f][2 * r] * inv, oacc[4 * f + 1][2 * r] * inv,
                      oacc[4 * f + 2][2 * r] * inv,
                      oacc[4 * f + 3][2 * r] * inv);
      *reinterpret_cast<float4*>(ob + 4) =
          make_float4(oacc[4 * f][2 * r + 1] * inv,
                      oacc[4 * f + 1][2 * r + 1] * inv,
                      oacc[4 * f + 2][2 * r + 1] * inv,
                      oacc[4 * f + 3][2 * r + 1] * inv);
    }
  }
}

}  // namespace

extern "C" int ev_prefill_attention_f32(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, const void* x_lens, const void* y_lens,
    int B, int T, int H, int x_len, float scale, void* stream) {
  if (T <= 0 || x_len < 0 || x_len > T) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  prefill_attention_kernel<32><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, q_sb, q_st, k_sb, k_st, v_sb, v_st, (const int*)x_lens,
      (const int*)y_lens, T, H, x_len, scale, Dropout{});
  return (int)cudaGetLastError();
}

// K1 with dropout on P: the arguments above, then the Philox seed, the
// layer index, the keep threshold (a pair is kept iff its word < thr),
// keep = 1 - p, the global batch row of batch row 0 and the layer's head of
// head 0 (philox.cuh); lse is written as above
extern "C" int ev_prefill_attention_dropout_f32(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, const void* x_lens, const void* y_lens,
    int B, int T, int H, int x_len, float scale, unsigned long long seed,
    int layer, unsigned thr, float keep, int row0, int h0, void* stream) {
  if (T <= 0 || x_len < 0 || x_len > T || layer < 0 || layer >= (1 << 15) ||
      h0 < 0 || H + h0 >= (1 << 15) || !(keep > 0.f) || row0 < 0)
    return (int)cudaErrorInvalidValue;
  const Dropout drop{(uint32_t)seed, (uint32_t)(seed >> 32), thr,
                     (uint32_t)layer, 1.f / keep, (uint32_t)row0,
                     (uint32_t)h0};
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  prefill_attention_kernel<32, true>
      <<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
          (const float*)q, (const float*)k, (const float*)v, (float*)o,
          (float*)lse, q_sb, q_st, k_sb, k_st, v_sb, v_st,
          (const int*)x_lens, (const int*)y_lens, T, H, x_len, scale, drop);
  return (int)cudaGetLastError();
}

// The encoders' attention: K1 with x_len = T, so every row sees the keys
// below valid_lens[b] and nothing else (the y_lens the kernel reads clamp to
// T - x_len = 0).  dk selects the instance: 64 (BERT, G2PW's BERT, HuBERT,
// Whisper's encoder) or 32 (CT-punc's 256/8).  q/k/v (B, T, H, dk) with the
// strides above, o (B, T, H, dk) contiguous; no lse.
extern "C" int ev_encoder_attention_f32(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_st, long long k_sb, long long k_st, long long v_sb,
    long long v_st, const void* valid_lens, int B, int T, int H, int dk,
    float scale, void* stream) {
  if (T <= 0 || (dk != 32 && dk != 64)) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  if (dk == 32)
    prefill_attention_kernel<32><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o,
        nullptr, q_sb, q_st, k_sb, k_st, v_sb, v_st, (const int*)valid_lens,
        (const int*)valid_lens, T, H, T, scale, Dropout{});
  else
    prefill_attention_kernel<64><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o,
        nullptr, q_sb, q_st, k_sb, k_st, v_sb, v_st, (const int*)valid_lens,
        (const int*)valid_lens, T, H, T, scale, Dropout{});
  return (int)cudaGetLastError();
}
