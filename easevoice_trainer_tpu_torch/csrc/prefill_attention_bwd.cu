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
//   1. dsum_kernel: D = rowsum(dO * O), one thread a (row, head);
//   2. dkdv_kernel: one block a 64-key tile of one (batch, head), 4 warps
//      of 16 keys, walking the 64-row query tiles that can see it;
//   3. dq_kernel: one block a 64-row query tile, 4 warps of 16 rows,
//      walking its visible 32-key tiles.
// P = exp2(S log2e / sqrt(dk) - lse log2e) is recomputed from K1's row
// logsumexp, dS = P (dP - D) with dP = dO V^T.
//
// Bound on the H100: at the s1 shapes (B = 8, H = 16, dk = 32, T up to
// 1776) the work is five dk-long products per visible (row, key) pair (S,
// dP, dV, dK, dQ; this kernel does S and dP twice, once in each walk):
// ~49 GFLOP over the two s1 shapes against ~330 MB moved, so operations
// bound it.  Design: both walks are K1's loop (prefill_attention.cu) with
// other operands, on mma.sync m16n8k8 TF32 in 3xTF32 (warp_mma.cuh), so
// every product keeps fp32 accuracy.
//
// - dq_kernel is K1's forward with the online softmax replaced by the
//   backward's elementwise step.  A warp's Q and dO fragments are split
//   hi/lo once and stay in registers, its rows' lse and D are read once.
//   Per key tile (K and V by cp.async in a 2-stage ring) it computes
//   S = Q K^T and dP = dO V^T, turns them into dS in the accumulators, and
//   adds dS K with dS taken straight from the accumulators as A fragments
//   and K, read a second time from the same staged tile, as B.
// - dkdv_kernel is the same loop transposed: a warp's 16 keys are the M
//   rows, its K and V split once into A fragments, the staged query tile
//   (Q, dO, lse, D by cp.async in a 2-stage ring) the N columns.  It runs
//   through a query tile 16 queries (two n8 tiles) at a time: S^T = K Q^T
//   and dP^T = V dO^T in two accumulator tiles each (8 at a time left one
//   12-HMMA dependency chain per product, 9 % slower on the H100), P^T and
//   dS^T with each lane's two query columns' lse and D per tile, then
//   dV += P^T dO and dK += dS^T Q with each tile of P^T and dS^T as the A
//   fragment of one k-step.
// - Both kernels are held to MIN_BLOCKS = 3 blocks (12 warps) an SM by
//   their launch bounds (about 160 registers), and take 2^x from the MUFU
//   unit alone.
// - K1's numbering makes every A fragment an accumulator and every
//   fragment two 16-byte row loads: in a product over keys (or queries),
//   k-step j's slot t is key 8j+2t and slot t+4 key 8j+2t+1, so c0/c1 of
//   an accumulator tile become a0/a2; in a product over head dims, k-step
//   s's slot t is dim 8t+2s and slot t+4 dim 8t+2s+1; an output n8 tile
//   n's column g is dim 4g+n.  Shared rows are 36 floats (4 mod 32).
// - K1's tile classes, per warp: a tile hidden from all of a warp's pairs
//   is skipped, a wholly visible one runs with no mask test, and only
//   boundary tiles test each pair (and set P = 0 before any exp of a
//   hidden pair, so a row with lse = -inf gives zeros, not NaN).
//
// Every output element is one warp's register sum in a fixed order: no
// float atomics, so repeated launches are bit-identical.  Every key and
// query row of the layout is written (zeros where nothing is visible), so
// the outputs need no clearing.
//
// Visibility, as in K1: text rows see the text keys below x_lens[b]; audio
// rows see those and, causally, the audio keys below x_len + y_lens[b].
// Pad rows (text rows at or past x_lens[b], audio rows at or past
// x_len + y_lens[b]) still attend over their visible keys and carry
// gradient (the GPT loss sums over every position, t2s.py:270-294), so no
// query row is skipped.  Query rows past T are read as zeros (dO = 0, so
// they add nothing) and not written.
//
// Layout: q, k, v are (B, T, H, 32) fp32 views of the fused qkv projection
// sharing batch / time strides (in_sb, in_st; head stride 32, unit stride
// in dk); o and dout are (B, T, H, 32) contiguous; lse and dsum are
// (B, H, T); dq, dk, dv are (B, T, H, 32) views sharing (out_sb, out_st),
// e.g. the three slices of one (B, T, 3 * H * 32) gradient of the fused
// projection.  Strides are multiples of 4 floats and the pointers 16-byte
// aligned (the wrapper checks).
//
// The bf16 instance (the s1 fine-tune under is_half) has kernels of its
// own: prefill_attention_bwd_bf16.cu.
//
// Dropout (the s1 fine-tune with T2SConfig.dropout > 0): K1's instance with
// dropout computed O = P~ V with P~ = P o M / keep, P the undropped softmax,
// M the keep bits of philox.cuh and keep = 1 - p, and wrote M as bits
// (philox.cuh's layout, one bit a pair: 1/8 of the bool residual
// jax.value_and_grad keeps).  The dkdv and dq kernels with DROP read those
// bits, draw nothing, and take, with dP~ = dO V^T:
//   dV = P~^T dO = (P o M)^T dO / keep,
//   dS = P o (dP~ o M / keep - D),
//   D  = rowsum(dO o O), unchanged: rowsum(P o dP~ o M / keep)
//      = rowsum(dO o (P~ V)) = rowsum(dO o O),
// so dsum_kernel is the same, dK = dS^T Q / sqrt(dk) and dQ = dS K / sqrt(dk)
// as before.  The dkdv walk stages the query tile's two words a row (the
// block's 64 keys) by 4-byte cp.async beside lse and D, and lane (g, t)
// shifts out the bits of its keys kw + g (+ 8) at queries qc + 2t (+ 1);
// the dq walk stages the block's 64 rows' word of each 32-key tile beside
// K and V.  The arithmetic is that of drawing M, in the same order, so the
// gradients are the drawing instance's bit for bit.  Free of the
// generator's registers, these instances take DROP_MIN_BLOCKS = 3 blocks
// an SM, as the others do (held to 2 while they drew the mask;
// bench/k5_variants.py --dtype fp32 --dropout times the cap undone).  The
// instances without DROP are the code above, unchanged.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "warp_mma.cuh"

namespace {

using namespace ev;

constexpr int DK = 32;          // head width of the 512/16 GPT
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;  // threads of a dkdv / dq block
constexpr int BQ = 16 * WARPS;  // rows of a dq block, of a staged query tile
constexpr int BK = 16 * WARPS;  // keys of a dkdv block
constexpr int BKT = 32;         // keys of a staged dq key tile
constexpr int LDS = DK + 4;     // shared row stride in floats, 4 mod 32
constexpr int DSUM_NT = 256;
constexpr int MIN_BLOCKS = 3;       // blocks an SM asked of the launch bounds
constexpr int DROP_MIN_BLOCKS = 3;  // and of those of the instances with DROP
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void split2(float v, uint32_t& hi, uint32_t& lo) {
  float h, l;
  split_tf32(v, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
}

// 2^x by the MUFU unit alone (exp2f adds a rescue of subnormal results,
// which only flushes P < 2^-126 to 0 here)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows r0 + g and r0 + g + 8 of a view (time stride st, `base` at dim 0 of
// the head) as hi/lo A fragments over the head dims: k-step s reads dims
// 8t+2s (slots t) and 8t+2s+1 (slots t+4).  Rows at or past `end` are 0.
__device__ __forceinline__ void load_a(const float* base, long long st,
                                       int r0, int end, int g, int t,
                                       uint32_t (&hi)[4][4],
                                       uint32_t (&lo)[4][4]) {
  float ra[8], rc[8];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    float* dst = half ? rc : ra;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    if (row < end) {
      a = *reinterpret_cast<const float4*>(base + row * st + 8 * t);
      c = *reinterpret_cast<const float4*>(base + row * st + 8 * t + 4);
    }
    dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
    dst[4] = c.x; dst[5] = c.y; dst[6] = c.z; dst[7] = c.w;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    split2(ra[2 * s], hi[s][0], lo[s][0]);
    split2(rc[2 * s], hi[s][1], lo[s][1]);
    split2(ra[2 * s + 1], hi[s][2], lo[s][2]);
    split2(rc[2 * s + 1], hi[s][3], lo[s][3]);
  }
}

// acc = A X^T over the 32 head dims, in 3xTF32: A the warp's 16 rows (hi/lo
// fragments of load_a), X the N * 8 rows of a shared tile from `x` (n8
// tile n column g is row 8n + g).
template <int N>
__device__ __forceinline__ void mma_dims(float (&acc)[N][4],
                                         const uint32_t (&ah)[4][4],
                                         const uint32_t (&al)[4][4],
                                         const float* x, int g, int t) {
  float xr[N][8];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float* row = x + (8 * n + g) * LDS + 8 * t;
    const float4 a = *reinterpret_cast<const float4*>(row);
    const float4 c = *reinterpret_cast<const float4*>(row + 4);
    xr[n][0] = a.x; xr[n][1] = a.y; xr[n][2] = a.z; xr[n][3] = a.w;
    xr[n][4] = c.x; xr[n][5] = c.y; xr[n][6] = c.z; xr[n][7] = c.w;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t bh[N][2], bl[N][2];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      split2(xr[n][2 * s], bh[n][0], bl[n][0]);
      split2(xr[n][2 * s + 1], bh[n][1], bl[n][1]);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(acc[n], al[s], bh[n][0], bh[n][1]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(acc[n], ah[s], bl[n][0], bl[n][1]);
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(acc[n], ah[s], bh[n][0], bh[n][1]);
  }
}

// acc += W X for one k-step of 8 rows of a shared tile from `x`: W a 16 x 8
// accumulator tile (c0/c1 its columns 2t and 2t+1) taken as the A fragment
// (slot t = column 2t, slot t+4 = column 2t+1), X's rows 2t and 2t+1 as B
// (n8 tile n column g is dim 4g+n), in 3xTF32
__device__ __forceinline__ void mma_rows(float (&acc)[4][4],
                                         const float (&w)[4], const float* x,
                                         int g, int t) {
  uint32_t ah[4], al[4];
  split2(w[0], ah[0], al[0]);
  split2(w[2], ah[1], al[1]);
  split2(w[1], ah[2], al[2]);
  split2(w[3], ah[3], al[3]);
  const float4 x0 = *reinterpret_cast<const float4*>(x + 2 * t * LDS + 4 * g);
  const float4 x1 =
      *reinterpret_cast<const float4*>(x + (2 * t + 1) * LDS + 4 * g);
  const float xa[4] = {x0.x, x0.y, x0.z, x0.w};
  const float xc[4] = {x1.x, x1.y, x1.z, x1.w};
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    split2(xa[n], bh[n][0], bl[n][0]);
    split2(xc[n], bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) mma_tf32(acc[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < 4; ++n) mma_tf32(acc[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < 4; ++n) mma_tf32(acc[n], ah, bh[n][0], bh[n][1]);
}

// a 16 x 32 accumulator of mma_rows (tile n: c0 = row g dim 8t+n, c1 = row
// g dim 8t+4+n, c2 / c3 the same for row g+8) times `mul` into rows r0 + g
// and r0 + g + 8 below `end` of a view (time stride st, `base` at dim 0)
__device__ __forceinline__ void store_rows(float* base, long long st, int r0,
                                           int end, const float (&acc)[4][4],
                                           float mul, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= end) continue;
    float* p = base + row * st + 8 * t;
    *reinterpret_cast<float4*>(p) =
        make_float4(acc[0][2 * r] * mul, acc[1][2 * r] * mul,
                    acc[2][2 * r] * mul, acc[3][2 * r] * mul);
    *reinterpret_cast<float4*>(p + 4) =
        make_float4(acc[0][2 * r + 1] * mul, acc[1][2 * r + 1] * mul,
                    acc[2][2 * r + 1] * mul, acc[3][2 * r + 1] * mul);
  }
}

__global__ void __launch_bounds__(DSUM_NT) dsum_kernel(
    const float* __restrict__ o, const float* __restrict__ dout,
    float* __restrict__ dsum, int T, int H) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * DSUM_NT + threadIdx.x;  // row * H + head
  if (idx >= T * H) return;
  const int row = idx / H, h = idx - row * H;
  const float* op = o + ((long long)b * T * H + idx) * DK;
  const float* gp = dout + ((long long)b * T * H + idx) * DK;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < DK; c += 4) {
    const float4 a = *reinterpret_cast<const float4*>(op + c);
    const float4 g = *reinterpret_cast<const float4*>(gp + c);
    acc = fmaf(a.x, g.x, acc);
    acc = fmaf(a.y, g.y, acc);
    acc = fmaf(a.z, g.z, acc);
    acc = fmaf(a.w, g.w, acc);
  }
  dsum[((long long)b * H + h) * T + row] = acc;
}

template <bool DROP = false>
__global__ void
__launch_bounds__(NT, DROP ? DROP_MIN_BLOCKS : MIN_BLOCKS) dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dk, float* __restrict__ dv, long long in_sb,
    long long in_st, long long out_sb, long long out_st,
    const int* __restrict__ x_lens, const int* __restrict__ y_lens, int T,
    int H, int x_len, float scale, const DropoutBits drop) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int xv = min(max(x_lens[b], 0), x_len);
  const int yv = min(max(y_lens[b], 0), T - x_len);
  const int n_text = (x_len + BK - 1) / BK;
  const bool text = (int)blockIdx.x < n_text;
  const int k0 = text ? blockIdx.x * BK : x_len + (blockIdx.x - n_text) * BK;
  const int k_write = min(k0 + BK, text ? x_len : T);  // keys written
  const int kend = min(k0 + BK, text ? xv : x_len + yv);  // keys seen
  const int kw = k0 + 16 * warp;  // the warp's first key
  // text keys: every row sees them; audio keys: rows from k0 on
  const int q_begin = text ? 0 : k0;
  const int n_tiles = kend > k0 ? (T - q_begin + BQ - 1) / BQ : 0;

  __shared__ __align__(16) float sq[2][BQ][LDS];
  __shared__ __align__(16) float sdo[2][BQ][LDS];
  __shared__ __align__(16) float slse[2][BQ];
  __shared__ __align__(16) float sd[2][BQ];
  // DROP: the staged query rows' words of the block's keys, [slot][word][row]
  __shared__ __align__(16) uint32_t sbits[DROP ? 2 : 1][BK / 32][BQ];

  const long long head = (long long)b * in_sb + h * DK;
  const float* qb = q + head;
  const float* gb = dout + (long long)b * T * H * DK + h * DK;
  const long long lrow = ((long long)b * H + h) * T;
  // DROP: the block's first word of the mask in a row, the end of its
  // segment's words, and this (b, h)'s words
  [[maybe_unused]] const int nw_text = (x_len + 31) / 32;
  [[maybe_unused]] const int W = mask_words(T, x_len);
  [[maybe_unused]] const int w_blk =
      text ? k0 / 32 : nw_text + (k0 - x_len) / 32;
  [[maybe_unused]] const int w_seg = text ? nw_text : W;
  [[maybe_unused]] const uint32_t* bits = drop.bits + lrow * W;
  auto issue = [&](int i, int slot) {
    if (i < n_tiles) {
      const int q0 = q_begin + i * BQ;
      for (int p = tid; p < BQ * DK / 4; p += NT) {
        const int r = p >> 3, c = (p & 7) * 4;
        const int row = q0 + r;
        const bool ok = row < T;
        cp_async16(&sq[slot][r][c], ok ? qb + row * in_st + c : qb, ok);
        cp_async16(&sdo[slot][r][c], ok ? gb + row * (H * DK) + c : gb, ok);
      }
      if (tid < BQ) {
        const int row = q0 + tid;
        const bool ok = row < T;
        cp_async4(&slse[slot][tid], lse + (ok ? lrow + row : 0), ok);
        cp_async4(&sd[slot][tid], dsum + (ok ? lrow + row : 0), ok);
      }
      if constexpr (DROP) {
        for (int p = tid; p < BK / 32 * BQ; p += NT) {
          const int w = p / BQ, r = p % BQ, row = q0 + r;
          const bool ok = row < T && w_blk + w < w_seg;
          cp_async4(&sbits[slot][w][r],
                    bits + (ok ? (long long)row * W + w_blk + w : 0), ok);
        }
      }
    }
    cp_async_commit();
  };
  issue(0, 0);
  issue(1, 1);

  // K and V of the warp's keys kw + g and kw + g + 8 as A fragments; keys
  // at or past kend (text pads, audio pads, past the tile) are 0
  uint32_t kh[4][4], kl[4][4], vh[4][4], vl[4][4];
  load_a(k + head, in_st, kw, kend, g, t, kh, kl);
  load_a(v + head, in_st, kw, kend, g, t, vh, vl);

  float acc_dk[4][4], acc_dv[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;
  const float c = scale * LOG2E;
  const bool live = kw < kend;  // some key of the warp is seen
  const int keys[2] = {kw + g, kw + g + 8};
  const int y_end = x_len + yv;
  // DROP: the warp's keys are bits 16 (warp & 1) + g (+ 8) of word warp / 2
  [[maybe_unused]] const int bit0 = 16 * (warp & 1) + g;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();
    __syncthreads();
    const int slot = i & 1;
    const int q0 = q_begin + i * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      const int qc = q0 + 16 * j;  // the first query of the two n8 tiles
      // hidden from all of the warp's pairs: past T, or audio keys all
      // after the last query
      if (!live || qc >= T || (!text && qc + 15 < kw)) continue;
      const bool full = qc + 16 <= T && (text ? kw + 16 <= xv
                                              : (qc >= kw + 15 &&
                                                 kw + 16 <= y_end));
      // S^T = K Q^T, dP^T = V dO^T: tile n element c0 = (key g, query
      // qc + 8n + 2t), c1 = (key g, query + 1), c2 / c3 key g + 8
      float st[2][4], dpt[2][4];
      [[maybe_unused]] uint32_t mask[2];  // the keep bits, with DROP
      mma_dims<2>(st, kh, kl, &sq[slot][16 * j][0], g, t);
      mma_dims<2>(dpt, vh, vl, &sdo[slot][16 * j][0], g, t);
      float p[2][4], ds[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if constexpr (DROP) {  // dP~ o M / keep
          // bit e: key keys[e >> 1], query qc + 8n + 2t + (e & 1)
          const uint2 w2 = *reinterpret_cast<const uint2*>(
              &sbits[slot][warp >> 1][16 * j + 8 * n + 2 * t]);
          const uint32_t x = w2.x >> bit0, y = w2.y >> bit0;
          const uint32_t keep = (x & 1u) | (y & 1u) << 1 |
                                (x >> 8 & 1u) << 2 | (y >> 8 & 1u) << 3;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[n][e] = keep >> e & 1u ? dpt[n][e] * drop.inv_keep : 0.f;
          mask[n] = keep;
        }
        const float2 l2 = *reinterpret_cast<const float2*>(
            &slse[slot][16 * j + 8 * n + 2 * t]);
        const float2 d2 = *reinterpret_cast<const float2*>(
            &sd[slot][16 * j + 8 * n + 2 * t]);
        const float m[2] = {l2.x * LOG2E, l2.y * LOG2E};
        const float dd[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool vis = full;
          if (!full) {
            const int query = qc + 8 * n + 2 * t + (e & 1);
            const int key = keys[e >> 1];
            vis = query < T &&
                  (text ? key < xv : (query >= key && key < y_end));
          }
          p[n][e] = vis ? ex2(fmaf(st[n][e], c, -m[e & 1])) : 0.f;
          ds[n][e] = p[n][e] * (dpt[n][e] - dd[e & 1]);
          if constexpr (DROP)  // P o M for dV; 1 / keep at the store
            p[n][e] = mask[n] >> e & 1u ? p[n][e] : 0.f;
        }
      }
      // dV += P^T dO, dK += dS^T Q, one k-step of 8 queries per tile n
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mma_rows(acc_dv, p[n], &sdo[slot][16 * j + 8 * n][0], g, t);
        mma_rows(acc_dk, ds[n], &sq[slot][16 * j + 8 * n][0], g, t);
      }
    }
    __syncthreads();  // every warp is done with this slot
    issue(i + 2, slot);
  }

  const long long out = (long long)b * out_sb + h * DK;
  store_rows(dv + out, out_st, kw, k_write, acc_dv,
             DROP ? drop.inv_keep : 1.f, g, t);
  store_rows(dk + out, out_st, kw, k_write, acc_dk, scale, g, t);
}

template <bool DROP = false>
__global__ void
__launch_bounds__(NT, DROP ? DROP_MIN_BLOCKS : MIN_BLOCKS) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dq, long long in_sb, long long in_st,
    long long out_sb, long long out_st, const int* __restrict__ x_lens,
    const int* __restrict__ y_lens, int T, int H, int x_len, float scale,
    const DropoutBits drop) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the last rows, which see the most keys, run first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
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
  // DROP: the block's rows' word of the staged key tile, [slot][row]
  __shared__ __align__(16) uint32_t sbits[DROP ? 2 : 1][BQ];
  static_assert(BKT == 32, "a dq key tile is one word of the mask");

  const long long head = (long long)b * in_sb + h * DK;
  const float* kb = k + head;
  const float* vb = v + head;
  // DROP: this (b, h)'s words of the mask, W a row, text words first
  [[maybe_unused]] const int nw_text = (x_len + 31) / 32;
  [[maybe_unused]] const int W = mask_words(T, x_len);
  [[maybe_unused]] const uint32_t* bits =
      drop.bits + ((long long)b * H + h) * T * W;
  auto issue = [&](int i, int slot) {
    if (i < n_tiles) {
      const int k0 = i < n_text ? i * BKT : x_len + (i - n_text) * BKT;
      const int kend = i < n_text ? xv : a_end;
      for (int p = tid; p < BKT * DK / 4; p += NT) {
        const int r = p >> 3, c = (p & 7) * 4;
        const int key = k0 + r;
        const bool ok = key < kend;
        cp_async16(&sk[slot][r][c], ok ? kb + key * in_st + c : kb, ok);
        cp_async16(&sv[slot][r][c], ok ? vb + key * in_st + c : vb, ok);
      }
      if constexpr (DROP) {  // text tile i is word i, audio tile i - n_text
        const int w = i < n_text ? i : nw_text + i - n_text;
        for (int r = tid; r < BQ; r += NT) {
          const int row = q0 + r;
          const bool ok = row < T;
          cp_async4(&sbits[slot][r],
                    bits + (ok ? (long long)row * W + w : 0), ok);
        }
      }
    }
    cp_async_commit();
  };
  issue(0, 0);
  issue(1, 1);

  // Q and dO of rows r0 + g and r0 + g + 8 as A fragments, split once;
  // their lse (in log2 units) and D
  uint32_t qh[4][4], ql[4][4], gh[4][4], gl[4][4];
  load_a(q + head, in_st, r0, T, g, t, qh, ql);
  load_a(dout + (long long)b * T * H * DK + h * DK, (long long)H * DK, r0,
         T, g, t, gh, gl);
  const int rows[2] = {r0 + g, r0 + g + 8};
  const long long lrow = ((long long)b * H + h) * T;
  float m[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = rows[r] < T ? lse[lrow + rows[r]] * LOG2E : 0.f;
    dd[r] = rows[r] < T ? dsum[lrow + rows[r]] : 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float c = scale * LOG2E;
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
      // S = Q K^T, dP = dO V^T: tile n holds keys k0 + 8n + g (B column
      // g); element e is row rows[e >> 1], key k0 + 8n + 2t + (e & 1)
      float s[4][4], dp[4][4];
      mma_dims<4>(s, qh, ql, &sk[slot][0][0], g, t);
      mma_dims<4>(dp, gh, gl, &sv[slot][0][0], g, t);
      if constexpr (DROP) {  // dP~ o M / keep
        // the rows' words of the tile: bit 8n + 2t + (e & 1) for element e
        // of score tile n
        uint32_t word[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          word[r] = sbits[slot][16 * warp + g + 8 * r] >> 2 * t;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[n][e] = word[e >> 1] >> (8 * n + (e & 1)) & 1u
                           ? dp[n][e] * drop.inv_keep : 0.f;
      }
      // dS = P (dP - D) in place of S
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool vis = full;
          if (!full) {
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            const int row = rows[e >> 1];
            vis = text ? key < xv
                       : (row >= x_len && key <= row && key < x_len + yv);
          }
          const float p = vis ? ex2(fmaf(s[n][e], c, -m[e >> 1])) : 0.f;
          s[n][e] = p * (dp[n][e] - dd[e >> 1]);
        }
      // dQ += dS K: k-step j is score tile j, K's rows 8j + 2t and
      // 8j + 2t + 1 from the same staged tile
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_rows(acc, s[j], &sk[slot][8 * j][0], g, t);
    }
    __syncthreads();  // every warp is done with this slot
    issue(i + 2, slot);
  }

  store_rows(dq + (long long)b * out_sb + h * DK, out_st, r0, T, acc, scale,
             g, t);
}

// The three launches of one call, on `s`; the first CUDA error.
template <bool DROP>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               float* dsum, float* dq, float* dk, float* dv,
               long long in_sb, long long in_st, long long out_sb,
               long long out_st, const int* x_lens, const int* y_lens, int B,
               int T, int H, int x_len, float scale, const DropoutBits& drop,
               cudaStream_t s) {
  if (B < 1 || T < 1 || H < 1 || x_len < 0 || x_len > T)
    return (int)cudaErrorInvalidValue;
  dsum_kernel<<<dim3((T * H + DSUM_NT - 1) / DSUM_NT, B), DSUM_NT, 0, s>>>(
      o, dout, dsum, T, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int key_tiles = (x_len + BK - 1) / BK + (T - x_len + BK - 1) / BK;
  dkdv_kernel<DROP><<<dim3(key_tiles, H, B), NT, 0, s>>>(
      q, k, v, dout, lse, dsum, dk, dv, in_sb, in_st, out_sb, out_st, x_lens,
      y_lens, T, H, x_len, scale, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_kernel<DROP><<<dim3((T + BQ - 1) / BQ, H, B), NT, 0, s>>>(
      q, k, v, dout, lse, dsum, dq, in_sb, in_st, out_sb, out_st, x_lens,
      y_lens, T, H, x_len, scale, drop);
  return (int)cudaGetLastError();
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
  return launch_bwd<false>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, (const float*)lse, (float*)dsum, (float*)dq,
      (float*)dk, (float*)dv, in_sb, in_st, out_sb, out_st,
      (const int*)x_lens, (const int*)y_lens, B, T, H, x_len, scale,
      DropoutBits{}, (cudaStream_t)stream);
}

// The gradient of K1 with dropout: the arguments above, then keep = 1 - p
// and the (B, H, T, W) int32 keep bits that K1's dropout instance wrote
// (philox.cuh), which it reads in both walks.
extern "C" int ev_prefill_attention_bwd_dropout_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, long long in_sb, long long in_st, long long out_sb,
    long long out_st, const void* x_lens, const void* y_lens, int B, int T,
    int H, int x_len, float scale, float keep, const void* bits,
    void* stream) {
  if (!(keep > 0.f) || bits == nullptr) return (int)cudaErrorInvalidValue;
  const DropoutBits drop =
      dropout_bits(0, 0, 0, keep, 0, 0, const_cast<void*>(bits));
  return launch_bwd<true>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, (const float*)lse, (float*)dsum, (float*)dq,
      (float*)dk, (float*)dv, in_sb, in_st, out_sb, out_st,
      (const int*)x_lens, (const int*)y_lens, B, T, H, x_len, scale, drop,
      (cudaStream_t)stream);
}
