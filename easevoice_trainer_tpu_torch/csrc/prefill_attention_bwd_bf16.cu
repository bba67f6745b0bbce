// K5's bf16 instance: the gradient of K1's bf16 instance for the s1
// fine-tune under is_half.
//
// Replaces: no Pallas kernel.  It is the gradient that jax.value_and_grad
// takes (easevoice_trainer_tpu/train/gpt_step.py:143) of
// TransformerLayer.attention with dtype bfloat16
// (easevoice_trainer_tpu/models/gpt/t2s.py:118-131): q, k, v are the bf16
// projection, the scores and the softmax fp32 (the layer input, and so
// x.dtype at :127, is fp32), the products dP = dO V^T, dV = P^T dO,
// dK = dS^T Q and dQ = dS K are taken in fp32 from the bf16 operands and the
// fp32 P and dS, and dq, dk, dv are rounded to bf16.  The walks, the tile
// classes and the mask are the fp32 instance's (prefill_attention_bwd.cu):
//   1. dsum_bf16_kernel: D = rowsum(dO * O), one thread a (row, head), from
//      the bf16 o of K1's bf16 instance (JAX's rowsum(dP * P) is the same
//      sum over the unrounded o: the two differ by o's rounding, 2^-9 |o|);
//   2. dkdv_bf16_kernel: one block a 64-key tile of one (batch, head), 4
//      warps of 16 keys, walking the 64-row query tiles that can see it;
//   3. dq_bf16_kernel: one block a 64-row query tile, 4 warps of 16 rows,
//      walking its visible 32-key tiles.
// P = exp2(S log2e / sqrt(dk) - lse log2e) is recomputed from K1's fp32
// row logsumexp, dS = P (dP - D).
//
// Bound on the H100: five dk-long products per visible (row, key) pair, as
// in fp32, at 989 TFLOP/s in bf16 against half the fp32 bytes: operations
// bound it.  Design, for the tensor cores' bf16 path:
//
// - bf16 tiles in shared memory.  Q and dO (the dkdv walk) or K and V (the
//   dq walk) stay bf16 and land by 16-byte cp.async in a two-stage ring,
//   lse and D by 4-byte cp.async beside them; a tile's copies overlap the
//   math on the tile before it.  A row of 32 dims is 64 bytes, padded to
//   80 (LDS), so the eight 16-byte rows of an ldmatrix fall on distinct
//   banks.  The fused qkv's time stride (3 * H * 32 elements) and the
//   contiguous dO keep every row 16-byte aligned (the wrapper checks).
// - mma.sync.m16n8k16, bf16 x bf16 -> fp32 (warp_mma.cuh), every B
//   fragment one ldmatrix.x4 from the staged tile: non-transposed where the
//   product runs over the head dims (S = Q K^T, dP = dO V^T and their
//   transposes), .trans where it runs over the tile's rows (dV += P^T dO,
//   dK += dS^T Q: dO and Q; dQ += dS K: K).  A warp's own 16 rows (K and V
//   in dkdv, Q and dO in dq) are A fragments loaded once from device
//   memory.
// - S and dP: one product each, both operands exact.  dS and P stay in the
//   fp32 accumulators; the C fragment of two adjacent n8 tiles is the A
//   fragment of one k16 step, so they feed dV, dK and dQ from registers,
//   each split into TERMS bf16 terms (hi + lo: 16 significant bits, far
//   below dq / dk / dv's own bf16 rounding), one product a term.
// - A dkdv step takes QSTEP = 16 queries: two n8 tiles of S^T and dP^T,
//   one k16 step of dV and dK.
// - 4 warps a block, at most 4 blocks an SM by the launch bounds (123
//   registers, no spill); a 64-row staged query tile (QT) and a 32-key
//   staged key tile (BKT: 64 keys spill 8 bytes).  bench/k5_variants.py
//   times each of these choices undone (PERF.md holds the readings).
//
// Every output element is one warp's register sum in a fixed order: no
// float atomics, so repeated launches are bit-identical.  Every key and
// query row of the layout is written (zeros where nothing is visible);
// query rows past T are read as zeros.  A row that sees no key (lse = -inf)
// never takes an exp: P = 0 for every hidden pair, so it gives zeros.
//
// Layout: q, k, v are (B, T, H, 32) bf16 views of the fused qkv projection
// sharing batch / time strides (in_sb, in_st; head stride 32, unit stride
// in dk); o and dout are (B, T, H, 32) bf16 contiguous; lse and dsum are
// (B, H, T) fp32; dq, dk, dv are (B, T, H, 32) bf16 views sharing (out_sb,
// out_st).  Strides are multiples of 8 elements and the pointers 16-byte
// aligned.
//
// Dropout (the s1 fine-tune with T2SConfig.dropout > 0), as in the fp32
// instance (prefill_attention_bwd.cu): K1's bf16 instance with dropout
// computed O = P~ V, P~ = P o M / keep, M the keep bits of philox.cuh,
// keep = 1 - p, and wrote M as bits (philox.cuh's layout, one bit a pair:
// 1/8 of the bool residual jax.value_and_grad keeps).  The dkdv and dq
// kernels with DROP read those bits, and draw nothing, and take
// dV = (P o M)^T dO / keep and dS = P o (dP~ o M / keep - D) with
// dP~ = dO V^T; D = rowsum(dO o O) is unchanged (rowsum(P o dP~ o M / keep)
// = rowsum(dO o (P~ V)) = rowsum(dO o O)), so dsum_bf16_kernel is the same.
// The dkdv walk stages the query tile's two words a row (its 64 keys) by
// 4-byte cp.async beside lse and D, and lane (g, t) shifts out the bits of
// its keys kw + g (+ 8) at queries qc + 2t (+ 1); the dq walk stages the
// block's 64 rows' word of each 32-key tile the same way.  P o M and dS
// enter the hi + lo bf16 split as P and dS did, so the gradients are those
// of drawing M again, bit for bit.  Free of the generator's registers,
// these instances take MIN_BLOCKS blocks an SM as the others do (held to
// 3 while they drew the mask; bench/k5_variants.py --dropout: 3 is slower,
// no cap the same, PERF.md).  The instances without DROP are the code
// above, unchanged.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_bf16.cuh"
#include "philox.cuh"

namespace {

using namespace ev;

constexpr int DK = 32;          // head width of the 512/16 GPT
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;  // threads of a dkdv / dq block
constexpr int BQ = 16 * WARPS;  // rows of a dq block
constexpr int BK = 16 * WARPS;  // keys of a dkdv block
constexpr int QT = 64;          // rows of a staged dkdv query tile
constexpr int BKT = 32;         // keys of a staged dq key tile
constexpr int LDS = DK + 8;     // shared row in bf16: 80 bytes
constexpr int DSUM_NT = 256;
constexpr float LOG2E = 1.4426950408889634f;
// The design choices that bench/k5_variants.py undoes one at a time:
constexpr int TERMS = 2;        // bf16 terms of P and dS in dV, dK, dQ
constexpr int QSTEP = 16;       // queries a dkdv step (8: m16n8k8 steps)
constexpr bool ASYNC = true;    // tiles by cp.async (false: plain loads)
constexpr int MIN_BLOCKS = 4;   // blocks an SM asked of the launch bounds

static_assert(QSTEP == 8 || QSTEP == 16, "a dkdv step is one k8 or k16");

// 4 bytes (lse, D, a word of the mask) global -> shared, zeros where !ok
template <class X>
__device__ __forceinline__ void stage4(X* dst, const X* src, bool ok) {
  if constexpr (ASYNC) {
    cp_async4(dst, src, ok);
  } else {
    *dst = ok ? *src : X(0);
  }
}

// acc += W X over the rows of one k16 step: W's TERMS A fragments, X's
// rows x0..x0+15 of a staged tile (acc n8 tile m: dims 8m..8m+7)
__device__ __forceinline__ void mma_rows(float (&acc)[4][4],
                                         const uint32_t (&w)[TERMS][4],
                                         const bf16* x, int x0, int lane) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    uint32_t b[4];
    ldsm_rows<LDS>(b, x, x0, m, lane);
#pragma unroll
    for (int i = TERMS - 1; i >= 0; --i) {
      mma_bf16(acc[2 * m], w[i], b[0], b[1]);
      mma_bf16(acc[2 * m + 1], w[i], b[2], b[3]);
    }
  }
}

// the same over the NQ n8 tiles of queries of a dkdv step, rows x0.. of a
// staged tile: NQ = 2 is one k16 step; NQ = 1 one m16n8k8 step, whose B
// fragments for the four dim tiles are one ldmatrix.x4.trans
template <int NQ>
__device__ __forceinline__ void mma_step(float (&acc)[4][4],
                                         const uint32_t (&w)[TERMS][2 * NQ],
                                         const bf16* x, int x0, int lane) {
  if constexpr (NQ == 2) {
    mma_rows(acc, w, x, x0, lane);
  } else {
    uint32_t b[4];
    ldsm_dims<LDS, true>(b, x, x0, lane);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int i = TERMS - 1; i >= 0; --i) mma_bf16_k8(acc[m], w[i], b[m]);
  }
}

// a 16 x 32 accumulator (n8 tile m: c0 = row g dim 8m+2t, c1 dim 8m+2t+1,
// c2 / c3 row g+8) times `mul`, rounded to bf16, into rows r0 + g and
// r0 + g + 8 below `end` of a view (time stride st, `base` at dim 0)
__device__ __forceinline__ void store_rows(bf16* base, long long st, int r0,
                                           int end, const float (&acc)[4][4],
                                           float mul, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= end) continue;
    uint32_t* p = reinterpret_cast<uint32_t*>(base + row * st);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      p[4 * m + t] = narrow2(acc[m][2 * r] * mul, acc[m][2 * r + 1] * mul);
  }
}

__global__ void __launch_bounds__(DSUM_NT) dsum_bf16_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    float* __restrict__ dsum, int T, int H) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * DSUM_NT + threadIdx.x;  // row * H + head
  if (idx >= T * H) return;
  const int row = idx / H, h = idx - row * H;
  const bf16* op = o + ((long long)b * T * H + idx) * DK;
  const bf16* gp = dout + ((long long)b * T * H + idx) * DK;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < DK; c += 8) {
    float a[8], g[8];
    widen8(op + c, a);
    widen8(gp + c, g);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(a[e], g[e], acc);
  }
  dsum[((long long)b * H + h) * T + row] = acc;
}

template <bool DROP = false>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) dkdv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    bf16* __restrict__ dk, bf16* __restrict__ dv, long long in_sb,
    long long in_st, long long out_sb, long long out_st,
    const int* __restrict__ x_lens, const int* __restrict__ y_lens, int T,
    int H, int x_len, float scale, const DropoutBits drop) {
  constexpr int NQ = QSTEP / 8;  // n8 query tiles a step
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
  const int n_tiles = kend > k0 ? (T - q_begin + QT - 1) / QT : 0;

  __shared__ __align__(16) bf16 sq[2][QT][LDS];
  __shared__ __align__(16) bf16 sdo[2][QT][LDS];
  __shared__ __align__(16) float slse[2][QT];
  __shared__ __align__(16) float sd[2][QT];
  // DROP: the staged query rows' words of the block's keys, [slot][word][row]
  __shared__ __align__(16) uint32_t sbits[DROP ? 2 : 1][BK / 32][QT];

  const long long head = (long long)b * in_sb + h * DK;
  const bf16* qb = q + head;
  const bf16* gb = dout + (long long)b * T * H * DK + h * DK;
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
      const int q0 = q_begin + i * QT;
      for (int p = tid; p < QT * DK / 8; p += NT) {
        const int r = p >> 2, c = (p & 3) * 8;
        const int row = q0 + r;
        const bool ok = row < T;
        stage16<ASYNC>(&sq[slot][r][c], ok ? qb + row * in_st + c : qb, ok);
        stage16<ASYNC>(&sdo[slot][r][c], ok ? gb + row * (H * DK) + c : gb,
                       ok);
      }
      for (int r = tid; r < QT; r += NT) {
        const int row = q0 + r;
        const bool ok = row < T;
        stage4(&slse[slot][r], lse + (ok ? lrow + row : 0), ok);
        stage4(&sd[slot][r], dsum + (ok ? lrow + row : 0), ok);
      }
      if constexpr (DROP) {
        for (int p = tid; p < BK / 32 * QT; p += NT) {
          const int w = p / QT, r = p % QT, row = q0 + r;
          const bool ok = row < T && w_blk + w < w_seg;
          stage4(&sbits[slot][w][r],
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
  uint32_t ka[2][4], va[2][4];
  load_a(k + head, in_st, kw, kend, g, t, ka);
  load_a(v + head, in_st, kw, kend, g, t, va);

  float acc_dk[4][4] = {}, acc_dv[4][4] = {};
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
    const int q0 = q_begin + i * QT;
    const bf16* tq = &sq[slot][0][0];
    const bf16* tg = &sdo[slot][0][0];
#pragma unroll
    for (int j = 0; j < QT / QSTEP; ++j) {
      const int qc = q0 + QSTEP * j;  // the step's first query
      // hidden from all of the warp's pairs: past T, or audio keys all
      // after the last query
      if (!live || qc >= T || (!text && qc + QSTEP - 1 < kw)) continue;
      const bool full = qc + QSTEP <= T && (text ? kw + 16 <= xv
                                                 : (qc >= kw + 15 &&
                                                    kw + 16 <= y_end));
      // S^T = K Q^T, dP^T = V dO^T: tile n element c0 = (key g, query
      // qc + 8n + 2t), c1 = (key g, query + 1), c2 / c3 key g + 8
      float st[NQ][4] = {}, dpt[NQ][4] = {};
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        uint32_t bq[4], bg[4];
        ldsm_dims<LDS>(bq, tq, QSTEP * j + 8 * n, lane);
        ldsm_dims<LDS>(bg, tg, QSTEP * j + 8 * n, lane);
        mma_bf16(st[n], ka[0], bq[0], bq[1]);
        mma_bf16(st[n], ka[1], bq[2], bq[3]);
        mma_bf16(dpt[n], va[0], bg[0], bg[1]);
        mma_bf16(dpt[n], va[1], bg[2], bg[3]);
      }
      // P^T and dS^T in place, each lane's two query columns' lse and D a
      // tile; then as the A fragments of the k-step over these queries
      // (a0 / a1 from tile 0's c0c1 / c2c3, a2 / a3 from tile 1's)
      uint32_t pa[TERMS][2 * NQ], da[TERMS][2 * NQ];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int col = QSTEP * j + 8 * n + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(&slse[slot][col]);
        const float2 d2 = *reinterpret_cast<const float2*>(&sd[slot][col]);
        const float m[2] = {l2.x * LOG2E, l2.y * LOG2E};
        const float dd[2] = {d2.x, d2.y};
        [[maybe_unused]] uint32_t keep;  // the keep bits, with DROP
        if constexpr (DROP) {  // bit e: key keys[e >> 1], query + (e & 1)
          const uint2 w2 =
              *reinterpret_cast<const uint2*>(&sbits[slot][warp >> 1][col]);
          const uint32_t x = w2.x >> bit0, y = w2.y >> bit0;
          keep = (x & 1u) | (y & 1u) << 1 | (x >> 8 & 1u) << 2 |
                 (y >> 8 & 1u) << 3;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool vis = full;
          if (!full) {
            const int query = qc + 8 * n + 2 * t + (e & 1);
            const int key = keys[e >> 1];
            vis = query < T &&
                  (text ? key < xv : (query >= key && key < y_end));
          }
          const float p = vis ? ex2(fmaf(st[n][e], c, -m[e & 1])) : 0.f;
          if constexpr (DROP) {  // P o M for dV (1 / keep at the store),
            const bool kept = keep >> e & 1u;  // dP~ o M / keep for dS
            st[n][e] = kept ? p : 0.f;
            dpt[n][e] = p * ((kept ? dpt[n][e] * drop.inv_keep : 0.f) -
                             dd[e & 1]);
          } else {
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - dd[e & 1]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t tp[TERMS], td[TERMS];
          split(st[n][2 * r], st[n][2 * r + 1], tp);
          split(dpt[n][2 * r], dpt[n][2 * r + 1], td);
#pragma unroll
          for (int x = 0; x < TERMS; ++x) {
            pa[x][2 * n + r] = tp[x];
            da[x][2 * n + r] = td[x];
          }
        }
      }
      // dV += P^T dO, dK += dS^T Q over these queries
      mma_step<NQ>(acc_dv, pa, tg, QSTEP * j, lane);
      mma_step<NQ>(acc_dk, da, tq, QSTEP * j, lane);
    }
    __syncthreads();  // every warp is done with this slot
    issue(i + 2, slot);
  }
  cp_async_wait<0>();  // only empty groups are left

  const long long out = (long long)b * out_sb + h * DK;
  store_rows(dv + out, out_st, kw, k_write, acc_dv,
             DROP ? drop.inv_keep : 1.f, g, t);
  store_rows(dk + out, out_st, kw, k_write, acc_dk, scale, g, t);
}

template <bool DROP = false>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    bf16* __restrict__ dq, long long in_sb, long long in_st,
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

  __shared__ __align__(16) bf16 sk[2][BKT][LDS];
  __shared__ __align__(16) bf16 sv[2][BKT][LDS];
  // DROP: the block's rows' word of the staged key tile, [slot][row]
  __shared__ __align__(16) uint32_t sbits[DROP ? 2 : 1][BQ];
  static_assert(BKT == 32, "a dq key tile is one word of the mask");

  const long long head = (long long)b * in_sb + h * DK;
  const bf16* kb = k + head;
  const bf16* vb = v + head;
  // DROP: this (b, h)'s words of the mask, W a row, text words first
  [[maybe_unused]] const int nw_text = (x_len + 31) / 32;
  [[maybe_unused]] const int W = mask_words(T, x_len);
  [[maybe_unused]] const uint32_t* bits =
      drop.bits + ((long long)b * H + h) * T * W;
  auto issue = [&](int i, int slot) {
    if (i < n_tiles) {
      const int k0 = i < n_text ? i * BKT : x_len + (i - n_text) * BKT;
      const int kend = i < n_text ? xv : a_end;
      for (int p = tid; p < BKT * DK / 8; p += NT) {
        const int r = p >> 2, c = (p & 3) * 8;
        const int key = k0 + r;
        const bool ok = key < kend;
        stage16<ASYNC>(&sk[slot][r][c], ok ? kb + key * in_st + c : kb, ok);
        stage16<ASYNC>(&sv[slot][r][c], ok ? vb + key * in_st + c : vb, ok);
      }
      if constexpr (DROP) {  // text tile i is word i, audio tile i - n_text
        const int w = i < n_text ? i : nw_text + i - n_text;
        for (int r = tid; r < BQ; r += NT) {
          const int row = q0 + r;
          const bool ok = row < T;
          stage4(&sbits[slot][r], bits + (ok ? (long long)row * W + w : 0),
                 ok);
        }
      }
    }
    cp_async_commit();
  };
  issue(0, 0);
  issue(1, 1);

  // Q and dO of rows r0 + g and r0 + g + 8 as A fragments; their lse (in
  // log2 units) and D
  uint32_t qa[2][4], ga[2][4];
  load_a(q + head, in_st, r0, T, g, t, qa);
  load_a(dout + (long long)b * T * H * DK + h * DK, (long long)H * DK, r0,
         T, g, t, ga);
  const int rows[2] = {r0 + g, r0 + g + 8};
  const long long lrow = ((long long)b * H + h) * T;
  float m[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = rows[r] < T ? lse[lrow + rows[r]] * LOG2E : 0.f;
    dd[r] = rows[r] < T ? dsum[lrow + rows[r]] : 0.f;
  }

  float acc[4][4] = {};
  const float c = scale * LOG2E;
  const int r_hi = r0 + 15;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();
    __syncthreads();
    const int slot = i & 1;
    const bool text = i < n_text;
    const int k0 = text ? i * BKT : x_len + (i - n_text) * BKT;
    const bf16* tk = &sk[slot][0][0];
    const bf16* tv = &sv[slot][0][0];
    // hidden from every row of the warp: audio keys for text rows, or keys
    // past the last row's causal reach
    const bool hidden = !text && (r_hi < x_len || k0 > r_hi);
    if (!hidden) {
      const bool full = text ? k0 + BKT <= xv
                             : (r0 >= x_len && k0 + BKT - 1 <= r0 &&
                                k0 + BKT <= x_len + yv);
      // S = Q K^T, dP = dO V^T: tile n holds keys k0 + 8n + (B column g);
      // element e is row rows[e >> 1], key k0 + 8n + 2t + (e & 1)
      // DROP: the rows' words of the tile, bit 2t + 8n + (e & 1) for
      // element e of score tile n
      [[maybe_unused]] uint32_t word[2];
      if constexpr (DROP)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          word[r] = sbits[slot][16 * warp + g + 8 * r] >> 2 * t;
      float s[BKT / 8][4] = {}, dp[BKT / 8][4] = {};
#pragma unroll
      for (int n = 0; n < BKT / 8; ++n) {
        uint32_t bk[4], bv[4];
        ldsm_dims<LDS>(bk, tk, 8 * n, lane);
        ldsm_dims<LDS>(bv, tv, 8 * n, lane);
        mma_bf16(s[n], qa[0], bk[0], bk[1]);
        mma_bf16(s[n], qa[1], bk[2], bk[3]);
        mma_bf16(dp[n], ga[0], bv[0], bv[1]);
        mma_bf16(dp[n], ga[1], bv[2], bv[3]);
      }
      // dS = P (dP - D), then dQ += dS K: k16 step j is score tiles 2j
      // and 2j + 1 (A fragment a0 / a1 tile 2j's c0c1 / c2c3, a2 / a3 tile
      // 2j + 1's), K's rows 16j.. from the same staged tile
#pragma unroll
      for (int j = 0; j < BKT / 16; ++j) {
        uint32_t da[TERMS][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int n = 2 * j + h2;
          if constexpr (DROP)  // dP~ o M / keep
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[n][e] = word[e >> 1] >> (8 * n + (e & 1)) & 1u
                             ? dp[n][e] * drop.inv_keep : 0.f;
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
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            uint32_t td[TERMS];
            split(s[n][2 * r], s[n][2 * r + 1], td);
#pragma unroll
            for (int x = 0; x < TERMS; ++x) da[x][2 * h2 + r] = td[x];
          }
        }
        mma_rows(acc, da, tk, 16 * j, lane);
      }
    }
    __syncthreads();  // every warp is done with this slot
    issue(i + 2, slot);
  }
  cp_async_wait<0>();

  store_rows(dq + (long long)b * out_sb + h * DK, out_st, r0, T, acc, scale,
             g, t);
}

}  // namespace

namespace {

// The three launches of one call, on `stream`; the first CUDA error.
template <bool DROP>
int launch_bwd_bf16(
    const void* q_, const void* k_, const void* v_, const void* o_,
    const void* dout_, const void* lse_, void* dsum_, void* dq_, void* dk_,
    void* dv_, long long in_sb, long long in_st, long long out_sb,
    long long out_st, const void* x_lens_, const void* y_lens_, int B, int T,
    int H, int x_len, float scale, const DropoutBits& drop, void* stream) {
  const bf16 *q = (const bf16*)q_, *k = (const bf16*)k_, *v = (const bf16*)v_;
  const bf16 *o = (const bf16*)o_, *dout = (const bf16*)dout_;
  const float* lse = (const float*)lse_;
  float* dsum = (float*)dsum_;
  bf16 *dq = (bf16*)dq_, *dk = (bf16*)dk_, *dv = (bf16*)dv_;
  const int *x_lens = (const int*)x_lens_, *y_lens = (const int*)y_lens_;
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || T < 1 || H < 1 || x_len < 0 || x_len > T)
    return (int)cudaErrorInvalidValue;
  dsum_bf16_kernel<<<dim3((T * H + DSUM_NT - 1) / DSUM_NT, B), DSUM_NT, 0,
                     s>>>(o, dout, dsum, T, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int key_tiles = (x_len + BK - 1) / BK + (T - x_len + BK - 1) / BK;
  dkdv_bf16_kernel<DROP><<<dim3(key_tiles, H, B), NT, 0, s>>>(
      q, k, v, dout, lse, dsum, dk, dv, in_sb, in_st, out_sb, out_st, x_lens,
      y_lens, T, H, x_len, scale, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_bf16_kernel<DROP><<<dim3((T + BQ - 1) / BQ, H, B), NT, 0, s>>>(
      q, k, v, dout, lse, dsum, dq, in_sb, in_st, out_sb, out_st, x_lens,
      y_lens, T, H, x_len, scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 instance of K5 (see prefill_attention_bwd.cu for the fp32 one):
// q, k, v, o, dout, dq, dk, dv bf16 (strides multiples of 8 elements,
// pointers 16-byte aligned), lse and dsum (B * H * T floats of scratch)
// fp32.  Three launches on `stream`; returns the first CUDA error.
extern "C" int ev_prefill_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, long long in_sb, long long in_st, long long out_sb,
    long long out_st, const void* x_lens, const void* y_lens, int B, int T,
    int H, int x_len, float scale, void* stream) {
  return launch_bwd_bf16<false>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                                in_sb, in_st, out_sb, out_st, x_lens, y_lens,
                                B, T, H, x_len, scale, DropoutBits{},
                                stream);
}

// The gradient of K1's bf16 instance with dropout: the arguments above,
// then keep = 1 - p and the (B, H, T, W) int32 keep bits that K1's bf16
// instance wrote (philox.cuh), which it reads in both walks.
extern "C" int ev_prefill_attention_bwd_dropout_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, long long in_sb, long long in_st, long long out_sb,
    long long out_st, const void* x_lens, const void* y_lens, int B, int T,
    int H, int x_len, float scale, float keep, const void* bits,
    void* stream) {
  if (!(keep > 0.f) || bits == nullptr) return (int)cudaErrorInvalidValue;
  const DropoutBits drop =
      dropout_bits(0, 0, 0, keep, 0, 0, const_cast<void*>(bits));
  return launch_bwd_bf16<true>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                               in_sb, in_st, out_sb, out_st, x_lens, y_lens,
                               B, T, H, x_len, scale, drop, stream);
}
