// K1's bf16 instance: the s1 fine-tune's prefill attention with its row
// logsumexp under is_half.
//
// Replaces: the Pallas kernel flash_prefill_attention
// (easevoice_trainer_tpu/ops/pallas/flash_prefill.py:35 `_kernel`, git
// 0ec4461) as the JAX package's TransformerLayer.attention computes it with
// dtype bfloat16 (easevoice_trainer_tpu/models/gpt/t2s.py:118-131): q, k, v
// are the bf16 projection, the scores fp32 from bf16 q and k, scaled by
// 1/sqrt(32), plus the hybrid mask bias (t2s.py:173-199); the softmax fp32
// (the layer input, and so x.dtype at :127, is fp32); o = P V in fp32 from
// the fp32 P and bf16 v, rounded to bf16 (the out projection's cast).  The
// walk, the tile classes and the mask are the fp32 instance's
// (prefill_attention.cu); the row logsumexp is what K5's bf16 instance
// (prefill_attention_bwd_bf16.cu) recomputes P from.
//
// Bound on the H100: two dk-long products per visible (row, key) pair at
// 989 TFLOP/s in bf16 against q, k, v, o once in bf16 and lse in fp32: at
// the s1 shapes the bytes bound it (PERF.md §6).  What limits this design
// is the tensor pipe: its time grows with the count of mma.sync it issues
// (bench/k1_variants.py: a third term of P costs a third more).  Design, a
// flash attention on the tensor cores' bf16 path (attention_bf16.cuh,
// warp_mma.cuh):
//
// - Q stays bf16: each warp owns MT tiles of 16 query rows and loads them
//   once from device memory as the A fragments of the two k16 steps over
//   dk 32; every K and V fragment a warp reads serves its MT row tiles.
// - K and V tiles of BKT keys stay bf16 in shared memory.  They arrive by
//   16-byte cp.async in a ring of STAGES tiles: tile i + STAGES - 1 is
//   issued into the slot that tile i - 1 left, right after the one
//   __syncthreads of step i, so its copies overlap the math on the tiles
//   before it.  A row of 32 dims is 64 bytes, padded to 80 (LDS), so the
//   eight 16-byte rows of an ldmatrix fall on distinct banks; the fused
//   qkv's time stride (3 * H * 32 elements) keeps rows 16-byte aligned (the
//   wrapper checks).
// - S = Q K^T: K's B fragments by ldmatrix.x4, one bf16 product
//   (mma.sync.m16n8k16, fp32 accumulators): both operands are exact, so S
//   is JAX's fp32 score up to the order of the sum.
// - The online softmax runs in fp32 on the accumulator fragments, in log2
//   units with the scale folded into the exponent's FFMA, the row max and
//   sum across the 4 lanes of a row by shuffles.
// - O += P V: the C fragment of two adjacent n8 score tiles is the A
//   fragment of one k16 step, so P feeds the product from registers, split
//   into TERMS bf16 terms (hi + lo: 16 significant bits, far below o's own
//   bf16 rounding), one product a term; V's B fragments by
//   ldmatrix.x4.trans.
// - WARPS warps (16 * MT * WARPS query rows) a block share each staged
//   tile.  With LONGEST_FIRST the last query tiles, the audio rows that see
//   the most keys, run first, so the grid does not end on its longest
//   blocks.
// - o is normalised by the row sum, rounded to bf16 and written through
//   shared memory in 16-byte stores; lse in fp32.
//
// The block walks only the text keys below x_lens[b] and the audio keys up
// to the causal reach of its last row (and below x_len + y_lens[b]); a tile
// wholly visible to a warp runs with no mask test, a tile wholly hidden
// from it (audio keys for text rows, or keys past its last row) is
// skipped, and only boundary tiles test each score.  Every output is one
// warp's register sum in a fixed order, with no atomics: repeated launches
// are bit-identical.  A row that sees no key gets o = 0 and lse = -inf.
//
// Layout: q, k, v are (B, T, H, 32) bf16 views with head stride 32 and unit
// stride in dk, batch and time strides passed in, multiples of 8 elements,
// the pointers 16-byte aligned (the split of the fused qkv projection); o
// is (B, T, H, 32) bf16 contiguous; lse, when not null, (B, H, T) fp32 in
// natural-log units.
//
// Dropout (the s1 fine-tune with T2SConfig.dropout > 0; JAX drops the fp32
// probabilities after the softmax, models/gpt/t2s.py:128): the instance
// with DROP draws each visible pair's keep bit M from Philox (philox.cuh)
// after the exponent and zeroes the dropped P elements before the hi + lo
// bf16 split; m, the row sum and the lse stay the undropped softmax's, and
// 1 / (1 - p) is folded into the final 1 / sum, so o = (P o M / (1 - p)) V.
// Lanes t and t ^ 1 share one Philox call of four keys, each drawing the
// bits of one row of the pair and trading them by a shuffle.  K5's bf16
// instance draws the same bits again.  The instance without DROP is the
// code above, unchanged.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bf16.cuh"
#include "philox.cuh"

namespace {

using namespace ev;

constexpr int DK = 32;       // head width of the 512/16 GPT
constexpr int LDS = DK + 8;  // shared row in bf16: 80 bytes
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// The design choices that bench/k1_variants.py undoes one at a time:
constexpr int WARPS = 4;              // warps a block
constexpr int MT = 2;                 // 16-row MMA tiles of queries a warp
constexpr int BKT = 64;               // keys a staged K / V tile
constexpr int TERMS = 2;              // bf16 terms of P in P V
constexpr bool ASYNC = true;          // tiles by cp.async (false: plain)
constexpr int STAGES = 3;             // tiles in the ring
constexpr bool LONGEST_FIRST = true;  // the last query tiles launch first

constexpr int NT = 32 * WARPS;
constexpr int WR = 16 * MT;     // query rows a warp
constexpr int BQ = WR * WARPS;  // query rows a block
constexpr int NS = BKT / 8;     // n8 score tiles of a staged tile

static_assert(BKT % 16 == 0, "a staged tile is whole k16 steps of P V");
static_assert(STAGES >= 2, "the ring overlaps a tile's copies with math");
static_assert(2 * STAGES * BKT >= BQ, "o goes out through the ring");

template <bool DROP = false>
__global__ void __launch_bounds__(NT) prefill_attention_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, long long q_sb, long long q_st, long long k_sb,
    long long k_st, long long v_sb, long long v_st,
    const int* __restrict__ x_lens, const int* __restrict__ y_lens, int T,
    int H, int x_len, float scale, const Dropout drop) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 =
      (LONGEST_FIRST ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int r0 = q0 + warp * WR;  // the warp's first row
  const int r_hi = r0 + WR - 1;   // and its last
  const int xv = min(max(x_lens[b], 0), x_len);
  const int yv = min(max(y_lens[b], 0), T - x_len);

  // keys the block walks: text [0, xv), audio [x_len, a_end)
  const int q_last = min(q0 + BQ, T) - 1;
  const int a_end = q_last >= x_len ? min(q_last + 1, x_len + yv) : x_len;
  const int n_text = (xv + BKT - 1) / BKT;
  const int n_tiles = n_text + (a_end - x_len + BKT - 1) / BKT;

  // slot s of the ring: K in kv[s][0], V in kv[s][1]
  __shared__ __align__(16) bf16 kv[STAGES][2][BKT][LDS];

  const bf16* kb = k + b * k_sb + h * DK;
  const bf16* vb = v + b * v_sb + h * DK;
  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int slot = i % STAGES;
      const int k0 = i < n_text ? i * BKT : x_len + (i - n_text) * BKT;
      const int kend = i < n_text ? xv : a_end;
      for (int p = tid; p < BKT * DK / 8; p += NT) {
        const int r = p >> 2, c = (p & 3) * 8;
        const int key = k0 + r;
        const bool ok = key < kend;
        stage16<ASYNC>(&kv[slot][0][r][c], ok ? kb + key * k_st + c : kb,
                       ok);
        stage16<ASYNC>(&kv[slot][1][r][c], ok ? vb + key * v_st + c : vb,
                       ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  // row tile u of the warp: rows r0 + 16u + g (accumulator elements 0, 1)
  // and r0 + 16u + g + 8 (elements 2, 3)
  uint32_t qa[MT][2][4];
#pragma unroll
  for (int u = 0; u < MT; ++u)
    load_a(q + b * q_sb + h * DK, q_st, r0 + 16 * u, T, g, t, qa[u]);

  // O accumulators: n8 tile d, c0 = row g dim 8d+2t, c1 dim 8d+2t+1, c2 /
  // c3 the same for row g+8; the row max (log2 units) and this lane's part
  // of the row sum
  float acc[MT][4][4] = {};
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[u][r] = -INFINITY;
      l[u][r] = 0.f;
    }
  const float c = scale * LOG2E;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's have, and every warp is done with i - 1
    issue(i + STAGES - 1);        // into the slot tile i - 1 left
    const bf16* tk = &kv[i % STAGES][0][0][0];
    const bf16* tv = &kv[i % STAGES][1][0][0];
    const bool text = i < n_text;
    const int k0 = text ? i * BKT : x_len + (i - n_text) * BKT;
    // hidden from every row of the warp: audio keys for text rows, or keys
    // past the last row's causal reach
    if (!text && (r_hi < x_len || k0 > r_hi)) continue;
    const bool full = text ? k0 + BKT <= xv
                           : (r0 >= x_len && k0 + BKT - 1 <= r0 &&
                              k0 + BKT <= x_len + yv);
    // S = Q K^T: tile n holds keys k0 + 8n + (B column g); element e of
    // row tile u is row r0 + 16u + g + 8 (e >> 1), key k0 + 8n + 2t + (e & 1)
    float s[MT][NS][4] = {};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      uint32_t bk[4];
      ldsm_dims<LDS>(bk, tk, 8 * n, lane);
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        mma_bf16(s[u][n], qa[u][0], bk[0], bk[1]);
        mma_bf16(s[u][n], qa[u][1], bk[2], bk[3]);
      }
    }
    if (!full) {
#pragma unroll
      for (int u = 0; u < MT; ++u)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            const int row = r0 + 16 * u + g + 8 * (e >> 1);
            const bool vis = text ? key < xv
                                  : (row >= x_len && key <= row &&
                                     key < x_len + yv);
            s[u][n][e] = vis ? s[u][n][e] : -INFINITY;
          }
    }
    // online softmax in log2 units, the scale folded into the exponent
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mx = fmaxf(mx, fmaxf(s[u][n][2 * r], s[u][n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[u][r], mx * c);
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = ex2(m[u][r] - base);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[u][n][e] = ex2(fmaf(s[u][n][e], c, -base));
            sum += s[u][n][e];
          }
        l[u][r] = l[u][r] * alpha + sum;
        m[u][r] = m_new;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          acc[u][d][2 * r] *= alpha;
          acc[u][d][2 * r + 1] *= alpha;
        }
      }
    if constexpr (DROP) {  // P o M, after the row sums took P
      const int group = (text ? k0 : k0 - x_len) / 4;
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        const int rows[2] = {r0 + 16 * u + g, r0 + 16 * u + g + 8};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const uint32_t keep =
              keep_rows(drop, b, h, rows, group + 2 * n, !text, t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[u][n][e] = keep >> e & 1u ? s[u][n][e] : 0.f;
        }
      }
    }
    // O += P V: k16 step j is score tiles 2j and 2j + 1 (A fragment a0 /
    // a1 tile 2j's c0c1 / c2c3, a2 / a3 tile 2j + 1's), V's rows 16j..,
    // whose B fragments serve every row tile
#pragma unroll
    for (int j = 0; j < BKT / 16; ++j) {
      uint32_t pa[MT][TERMS][4];
#pragma unroll
      for (int u = 0; u < MT; ++u)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            uint32_t tp[TERMS];
            split(s[u][2 * j + h2][2 * r], s[u][2 * j + h2][2 * r + 1], tp);
#pragma unroll
            for (int x = 0; x < TERMS; ++x) pa[u][x][2 * h2 + r] = tp[x];
          }
#pragma unroll
      for (int d2 = 0; d2 < 2; ++d2) {
        uint32_t bv[4];
        ldsm_rows<LDS>(bv, tv, 16 * j, d2, lane);
#pragma unroll
        for (int u = 0; u < MT; ++u)
#pragma unroll
          for (int x = TERMS - 1; x >= 0; --x) {
            mma_bf16(acc[u][2 * d2], pa[u][x], bv[0], bv[1]);
            mma_bf16(acc[u][2 * d2 + 1], pa[u][x], bv[2], bv[3]);
          }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left
  __syncthreads();     // every warp is done with the ring: o goes through it

  // the warp's WR x 32 tile of o, normalised and rounded, into rows of the
  // ring; then out in 16-byte pieces, four a row
  bf16* so = &kv[0][0][0][0] + warp * WR * LDS;
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[u][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      float inv = sum > 0.f ? 1.f / sum : 0.f;  // no visible key: 0
      if constexpr (DROP) inv *= drop.inv_keep;
      const int rl = 16 * u + g + 8 * r, row = r0 + rl;
      uint32_t* p = reinterpret_cast<uint32_t*>(so + rl * LDS);
#pragma unroll
      for (int d = 0; d < 4; ++d)
        p[4 * d + t] = narrow2(acc[u][d][2 * r] * inv,
                               acc[u][d][2 * r + 1] * inv);
      if (lse != nullptr && t == 0 && row < T)  // m, sum in log2 units
        lse[((long long)b * H + h) * T + row] =
            sum > 0.f ? (m[u][r] + log2f(sum)) * LN2 : -INFINITY;
    }
  __syncwarp();
#pragma unroll
  for (int rr = 0; rr < 2 * MT; ++rr) {
    const int rl = g + 8 * rr, row = r0 + rl;
    if (row < T)
      *reinterpret_cast<uint4*>(
          o + (((long long)b * T + row) * H + h) * DK + 8 * t) =
          *reinterpret_cast<const uint4*>(so + rl * LDS + 8 * t);
  }
}

}  // namespace

// q/k/v (B, T, H, 32) bf16 views whose batch and time strides are multiples
// of 8 elements, the pointers 16-byte aligned; o (B, T, H, 32) bf16
// contiguous; lse (B, H, T) fp32 or null (no lse written)
extern "C" int ev_prefill_attention_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long q_sb, long long q_st, long long k_sb, long long k_st,
    long long v_sb, long long v_st, const void* x_lens, const void* y_lens,
    int B, int T, int H, int x_len, float scale, void* stream) {
  if (T <= 0 || x_len < 0 || x_len > T) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  prefill_attention_bf16_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      q_sb, q_st, k_sb, k_st, v_sb, v_st, (const int*)x_lens,
      (const int*)y_lens, T, H, x_len, scale, Dropout{});
  return (int)cudaGetLastError();
}

// K1's bf16 instance with dropout on P: the arguments above, then the
// Philox seed, the layer index, the keep threshold, keep = 1 - p, the
// global batch row of batch row 0 and the layer's head of head 0
// (philox.cuh)
extern "C" int ev_prefill_attention_dropout_bf16(
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
  prefill_attention_bf16_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      q_sb, q_st, k_sb, k_st, v_sb, v_st, (const int*)x_lens,
      (const int*)y_lens, T, H, x_len, scale, drop);
  return (int)cudaGetLastError();
}
