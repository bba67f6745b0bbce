// The bf16 loop under K3's and K4-dx's bf16 instances (mrf_conv_bf16.cu,
// mrf_conv_bwd_bf16.cu), the s2 fine-tune's under is_half, on (B, C, T)
// bf16 with T contiguous:
//
//   BWD = false (K3):  y[b,co,t] = bias[co] + sum_ci sum_j w[co,ci,j]
//                          * lrelu(x[b,ci,t+j*dil-pad])  (+ res[b,co,t])
//   BWD = true (K4):   dx[b,co,t] = lrelu'(res[b,co,t]) * sum_ci sum_j
//                          w[ci,co,K-1-j] * dy[b,ci,t+j*dil-pad]
//                      (x = dy, res = the forward's saved input; Cin / Cout
//                      are the channels read and written, i.e. the
//                      forward's Cout / Cin)
//
// with the JAX Generator's bf16 roundings (generator.py:31-44, nn/layers.py
// WNConv1d): the leaky relu rounded to bf16 (x * bf16(0.1)), the conv taken
// in fp32 from bf16 operands and rounded to bf16, then + bias and
// + residual in bf16, each add rounded; the gradient's transposed conv
// rounded to bf16, then the leaky relu's derivative (da * bf16(0.1),
// rounded).  The caller passes slope = bf16(0.1).
//
// The fp32 loop (mrf_conv_tile.cuh) carries over what it does right: an
// implicit GEMM with M = output channels, N = time and the reduction over
// (input channel, tap); one staged x tile with its (k-1)*d halo reused by
// every tap and every row; the tile choice by Cout and blocks per SM; the
// deterministic in-cluster channel split through distributed shared
// memory.  What is new, against the four things that held the first bf16
// instance (that loop with bf16 widened into its fp32 stages) back:
//
// 1. Staging.  x (or dy) and the weights are copied asynchronously
//    (cp.async: 16-byte copies of 8 samples where T % 8 == 0 and the
//    pointer is 16-byte aligned, 4-byte copies where T is even, plain loads
//    otherwise), into two or three raw stages: three where that still
//    keeps two blocks on an SM.  A chunk's copies overlap the MMAs of the
//    one or two chunks before it.  The halo's first staged sample is
//    aligned to 8; the copies' zero fill gives the "same" padding and the
//    channel edges.
// 2. Shared memory holds bf16: 2 bytes a value in the raw stages and 2 in
//    the converted tiles, against 4 + 4 (+ an unused lo plane) before.
// 3. The instruction is mma.sync.m16n8k16 in bf16 with fp32 accumulators
//    (a product of two bf16 values is exact in fp32, so the result differs
//    from the twin's only in summation order), k = 16 a product where the
//    TF32 m16n8k8 took 8; every fragment is one ldmatrix.x4 (A: one m-tile
//    of one tap; B: two n-tiles of one tap).
// 4. BK = 16 input channels a chunk: one barrier pair and one convert pass
//    per 16 channels, not per 8.
//
// The convert pass, once per chunk and block, writes the two converted
// tiles the MMAs read, both in 32-byte rows of 16 channels whose 16-byte
// halves swap every 4 rows (swz), so that the 8 rows of any ldmatrix hit
// distinct banks:
//   - x time-major, [sample][16 channels], by ldmatrix.trans from the raw
//     channel-major rows and stmatrix (K3 applies its leaky relu to the
//     registers in between, rounded to bf16 as JAX rounds it: an fma.bf16x2
//     and a max.bf16x2).  Tap j's B operand then starts j*d rows further
//     down, and ldmatrix (non-transposed) needs each 16-byte row aligned
//     only: its fragment is m16n8k16's col B operand (row = sample, pairs
//     of adjacent channels).
//   - the weights, [tap][output channel][16 channels] (K4: [tap][forward
//     input channel][16 forward output channels], taps flipped), so that
//     the A fragment of (m-tile, tap) is one ldmatrix.x4.  In device memory
//     (Cout, Cin, k) puts channel ci of tap j at ci*k + j: pairs of
//     channels lie k apart.  A thread takes one row and channel pair,
//     reads all its taps from the raw stage as 32-bit words and packs each
//     tap's word with one byte permute (K4, whose row of a tap count of
//     halfwords may start odd, picks its half with a select); the words
//     are copied as the weight rows lie, with no transpose in the wrapper.
//
// mma.sync rather than wgmma: tap j starts the B operand j*d rows into the
// staged tile, an offset that is not a multiple of the 8-row core matrices
// that wgmma's shared-memory descriptors address; a wgmma form would
// restage the tile per tap (or per tap residue).
//
// Epilogue: the accumulators, rounded as JAX rounds them (K3 also adds the
// bias), are parked as bf16 in shared memory and written with 16-byte
// loads of the residual (or saved x) and 16-byte stores, a warp's stores
// contiguous along T (element by element where T % 8 != 0).
//
// Shared memory of a block (bytes) at k = 11, d = 5, the largest halo and
// weight slice of the s2 step; a block takes three raw stages where they
// keep two blocks on an SM (113 KB), else two:
//   64 x 256 (8 warps of 64 x 32): raw x 16 x 328 x 2 = 10,496, raw w
//     64 x 176 x 2 = 22,528, converted x 320 x 32 = 10,240, converted w
//     11 x 64 x 32 = 22,528: 2 x 33,024 + 32,768 = 98,816 (two stages;
//     three would take 131,840);
//   32 x 256 (8 warps of 32 x 32): 3 x (10,496 + 11,264) + 10,240 +
//     11,264 = 86,784 (three; K4, whose raw weight rows are padded to 360
//     elements, 87,552);
//   16 x 256: 3 x (10,496 + 5,632) + 10,240 + 5,632 = 64,256 (three).
// At k = 7 every tile takes three stages.  The channel split parks 64
// floats a thread (64 KB) and the epilogue BM x (BN + 8) bf16 (33 KB at
// 64 x 256) in the same memory.
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "warp_mma.cuh"

namespace mrf_bf16 {

using ev::cp_async16;
using ev::cp_async4;
using ev::cp_async_commit;
using ev::cp_async_wait;
using ev::ldsm4;
using ev::ldsm4_trans;
using ev::mma_bf16;
using ev::smem_addr;
using u16 = unsigned short;

constexpr int NTHREADS = 256;  // 8 warps
constexpr int BK = 16;         // input channels per chunk: one k16 step
constexpr int SMS = 132;       // SMs of an H100 SXM
// the most dynamic shared memory a block may take with two blocks on an
// SM (228 KB an SM, 1 KB of it reserved per block)
constexpr int TWO_BLOCKS_SMEM = 113 * 1024;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int MAX_STAGES = 3;  // raw cp.async stages, at most

// tile-relative byte offset in a tile of 32-byte rows: the 16-byte halves
// of a row swap every 4 rows
__host__ __device__ __forceinline__ uint32_t swz(uint32_t o) {
  return o ^ ((o >> 3) & 16u);
}

// shared-memory geometry of one launch (elements, and bytes where named)
struct Geom {
  int halo, pad, rx, ldr, ldw, xraw, wraw, stage, xcvt, wcvt;
  __host__ __device__ Geom(int bm, int bn, int k, int dil, bool bwd) {
    halo = (k - 1) * dil;
    pad = halo / 2;
    rx = (bn + halo + 7 + 15) & ~15;  // staged samples: 8-aligned start
    ldr = rx + 8;  // raw x row: an odd count of 16-byte pieces
    // K3: [out channel][16 channels x k taps]; K4: [in channel][bm x k],
    // padded to 8 words mod 32 (rows 2p of the convert's lanes apart) and
    // past one more halfword, which its word reads may touch
    ldw = bwd ? bm * k + 1 + (8 - (bm * k + 1) % 32 + 32) % 32 : BK * k;
    xraw = 2 * BK * ldr;
    wraw = 2 * (bwd ? BK : bm) * ldw;
    stage = xraw + wraw;
    xcvt = 32 * rx;
    wcvt = 32 * k * bm;
  }
  __host__ __device__ int bytes(int stages) const {
    return stages * stage + xcvt + wcvt;
  }
};

__device__ __forceinline__ void stsm4(uint32_t addr,
                                      const uint32_t (&d)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n" ::"r"(
          addr),
      "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3])
      : "memory");
}

// leaky relu of two bf16: max(v, v * slope rounded once), which is JAX's
// where(v >= 0, v, v * slope) in bf16 for 0 < slope < 1 (-0 stays -0)
__device__ __forceinline__ uint32_t lrelu2(uint32_t v, uint32_t slope2) {
  uint32_t p, r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(p)
      : "r"(v), "r"(slope2), "r"(0x80008000u));
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(v), "r"(p));
  return r;
}

__device__ __forceinline__ float widen(u16 v) {
  return __uint_as_float((uint32_t)v << 16);
}

// fp32 -> bf16 bits, to nearest even
__device__ __forceinline__ u16 narrow(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float round_bf16(float v) {
  return widen(narrow(v));
}

// Block = WARPS_M x (8 / WARPS_M) warps; a warp owns MT m16 x NT n8 tiles.
// KT > 0 fixes the tap count at compile time; KT = 0 reads it from ksize.
// xvec: 8 (16-byte x copies), 2 (4-byte) or 1 (plain loads); wvec: weight
// rows in 16-byte copies; yvec: 16-byte epilogue; split: blocks per cluster
// along z (grid z = batch x split), each summing its share of the chunks;
// stages: raw stages (2 or 3).
template <int WARPS_M, int MT, int NT, int KT, bool BWD>
__global__ void __launch_bounds__(NTHREADS, 2) conv_bf16_kernel(
    const u16* __restrict__ x, const u16* __restrict__ w,
    const u16* __restrict__ bias, const u16* __restrict__ res,
    u16* __restrict__ y, int Cin, int Cout, int T, int ksize, int dil,
    float slope, int xvec, int wvec, int yvec, int split, int stages) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int BM = WARPS_M * MT * 16;
  constexpr int BN = WARPS_N * NT * 8;
  constexpr int LDE = BN + 8;  // epilogue row: 4 banks further each row
  static_assert(NT % 2 == 0, "B fragments are loaded two n-tiles at once");
  const int K = KT > 0 ? KT : ksize;
  const Geom g(BM, BN, K, dil, BWD);

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* xc = smem + stages * g.stage;  // [rx][16] swizzled
  unsigned char* wc = xc + g.xcvt;              // [K][BM][16] swizzled

  const int b = blockIdx.z / split;
  const int rank = blockIdx.z % split;  // the block's rank in its cluster
  const int co0 = blockIdx.y * BM;
  const int t0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int gid = lane >> 2, tig = lane & 3;
  const int start = t0 - g.pad;
  const int u0 = start & ~7;  // first staged sample, 16-byte aligned
  const int shift = start - u0;
  const u16* xb = x + (long long)b * Cin * T;
  const int nchunks = (Cin + BK - 1) / BK;
  const int cbegin = rank * nchunks / split;
  const int nloc = (rank + 1) * nchunks / split - cbegin;
  const uint32_t sb = (uint32_t)__float_as_uint(slope) >> 16;
  const uint32_t slope2 = sb | (sb << 16);

  auto issue = [&](int i) {
    if (i < nloc) {
      const int ci0 = (cbegin + i) * BK;
      unsigned char* st = smem + (i % stages) * g.stage;
      u16* xr = reinterpret_cast<u16*>(st);
      const int per = g.rx / xvec;
      for (int p = tid; p < BK * per; p += NTHREADS) {
        const int c = p / per, q = (p - c * per) * xvec;
        const int ci = ci0 + c, t = u0 + q;
        // pieces do not straddle T: T % xvec == 0 and t % xvec == 0
        const bool ok = ci < Cin && t >= 0 && t < T;
        const u16* src = ok ? xb + (long long)ci * T + t : x;
        if (xvec == 8)
          cp_async16(xr + c * g.ldr + q, src, ok);
        else if (xvec == 2)
          cp_async4(xr + c * g.ldr + q, src, ok);
        else
          xr[c * g.ldr + q] = ok ? *src : (u16)0;
      }
      // weight row r: K3 the 16 channels x K taps of output channel co0 + r,
      // K4 the BM channels x K taps of input channel ci0 + r, contiguous
      u16* wr = reinterpret_cast<u16*>(st + g.xraw);
      const int rows = BWD ? BK : BM;
      const int span = BWD ? Cout - co0 : Cin - ci0;  // channels left
      const int width = BWD ? BM : BK;                 // channels a row
      const int valid = K * (span < width ? span : width);
      const int step = wvec ? 8 : 1;
      const int wper = g.ldw / step;
      for (int p = tid; p < rows * wper; p += NTHREADS) {
        const int r = p / wper, q = (p - r * wper) * step;
        const bool ok = (BWD ? ci0 + r < Cin : co0 + r < Cout) && q < valid;
        const u16* src =
            ok ? (BWD ? w + ((long long)(ci0 + r) * Cout + co0) * K + q
                      : w + ((long long)(co0 + r) * Cin + ci0) * K + q)
               : w;
        if (wvec)
          cp_async16(wr + r * g.ldw + q, src, ok);
        else
          wr[r * g.ldw + q] = ok ? *src : (u16)0;
      }
    }
    cp_async_commit();
  };

  // raw stage -> converted tiles
  auto convert = [&](int i) {
    const unsigned char* st = smem + (i % stages) * g.stage;
    // x: 16 channels x 16 samples a warp step; matrix q of the load is
    // channels 8 (q & 1) + 0..7 at samples 8 (q >> 1) + 0..7, which the
    // store puts at samples 8 (q >> 1) + 0..7, channel half q & 1
    const int q = lane >> 3, r = lane & 7;
    const uint32_t ld0 = smem_addr(st) +
                         2 * ((8 * (q & 1) + r) * g.ldr + 8 * (q >> 1));
    const uint32_t xc0 = smem_addr(xc);
    for (int blk = warp; blk < g.rx / 16; blk += NTHREADS / 32) {
      uint32_t v[4];
      ldsm4_trans(v, ld0 + 32 * blk);
      if (!BWD) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = lrelu2(v[e], slope2);
      }
      const int s = 16 * blk + 8 * (q >> 1) + r;
      stsm4(xc0 + swz((s << 5) + ((q & 1) << 4)), v);
    }
    // weights: the word of (tap j, row m, channel pair p) packs channel 2p
    // and 2p+1.  With the tap count fixed, a thread takes one (m, p) and
    // reads its taps as 32-bit words: K3 the 2K halfwords raw[m][2p K ..]
    // (channel 2p's taps, then 2p+1's), whose words put lanes p, m at banks
    // K (8 m + p) + i; K4 the K + 1 halfwords from the even one at or
    // before raw[2p][m K] and raw[2p+1][m K], taps flipped, the odd start
    // of odd m K chosen by a select.  Lanes p, m store one 128-byte span.
    const u16* wr = reinterpret_cast<const u16*>(st + g.xraw);
    if constexpr (KT > 0) {
      for (int it = tid; it < BM * 8; it += NTHREADS) {
        const int p = it & 7, m = it >> 3;
        unsigned char* dst = wc + swz((m << 5) + (p << 2));  // tap 0
        if constexpr (!BWD) {
          const uint32_t* src =
              reinterpret_cast<const uint32_t*>(wr + m * g.ldw + 2 * p * KT);
          uint32_t h[KT];
#pragma unroll
          for (int i = 0; i < KT; ++i) h[i] = src[i];
#pragma unroll
          for (int j = 0; j < KT; ++j)
            *reinterpret_cast<uint32_t*>(dst + 32 * BM * j) = __byte_perm(
                h[j >> 1], h[(KT + j) >> 1], (j & 1) ? 0x5432 : 0x7610);
        } else {
          constexpr int NW = (KT + 1) / 2;
          const int e0 = m * KT, par = e0 & 1;
          const uint32_t* r0 = reinterpret_cast<const uint32_t*>(
              wr + 2 * p * g.ldw + e0 - par);
          const uint32_t* r1 = reinterpret_cast<const uint32_t*>(
              reinterpret_cast<const u16*>(r0) + g.ldw);
          uint32_t a[NW], c[NW];
#pragma unroll
          for (int i = 0; i < NW; ++i) {
            a[i] = r0[i];
            c[i] = r1[i];
          }
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            const int e = KT - 1 - j;  // the flipped tap's halfword
            const uint32_t even = __byte_perm(a[e >> 1], c[e >> 1],
                                              (e & 1) ? 0x7632 : 0x5410);
            const uint32_t odd =
                __byte_perm(a[(e + 1) >> 1], c[(e + 1) >> 1],
                            ((e + 1) & 1) ? 0x7632 : 0x5410);
            *reinterpret_cast<uint32_t*>(dst + 32 * BM * j) =
                par ? odd : even;
          }
        }
      }
    } else {
      // any tap count: two 16-bit reads a word (K3 raw[m][2p K + j] and
      // the next channel K further, K4 raw[2p][m K + K-1-j] and the next
      // row)
      for (int it = tid; it < K * BM * 8; it += NTHREADS) {
        const int p = it & 7, m = (it >> 3) % BM, j = it / (8 * BM);
        const int o = BWD ? 2 * p * g.ldw + m * K + (K - 1 - j)
                          : m * g.ldw + 2 * p * K + j;
        const uint32_t lo = wr[o], hi = wr[o + (BWD ? g.ldw : K)];
        *reinterpret_cast<uint32_t*>(
            wc + swz(((j * BM + m) << 5) + (p << 2))) = lo | (hi << 16);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // ldmatrix row addresses.  A, matrix q = lane / 8: rows 8 (q & 1) + 0..7
  // of the m-tile, channel half q >> 1 (a0..a3); B: samples 8 (q >> 1) +
  // 0..7 of an n-tile pair, channel half q & 1 (b0, b1 of each n-tile).
  // Offsets of 16 rows (512 bytes) leave the swizzle as it is.
  const uint32_t a_base =
      smem_addr(wc) + swz(((wm * MT * 16 + 8 * ((lane >> 3) & 1) +
                            (lane & 7)) << 5) + ((lane >> 4) << 4));
  const int b_row = shift + wn * NT * 8 + 8 * (lane >> 4) + (lane & 7);
  const uint32_t b_half = ((lane >> 3) & 1) << 4;
  const uint32_t xc_base = smem_addr(xc);

  auto compute = [&]() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      uint32_t a[MT][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm4(a[mt], a_base + 32 * (j * BM + 16 * mt));
      const uint32_t b_addr =
          xc_base + swz(((b_row + j * dil) << 5) + b_half);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t v[4];
        ldsm4(v, b_addr + 512 * np);
        bf[2 * np][0] = v[0];
        bf[2 * np][1] = v[1];
        bf[2 * np + 1][0] = v[2];
        bf[2 * np + 1][1] = v[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], a[mt], bf[nt][0], bf[nt][1]);
    }
  };

  // one converted buffer: a barrier before the convert (raw chunk i
  // landed, the MMAs of chunk i-1 done) and one after it; chunk
  // i + stages - 1 is issued into the stage chunk i-1 left
  for (int s = 0; s < stages - 1; ++s) issue(s);
  for (int i = 0; i < nloc; ++i) {
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    issue(i + stages - 1);
    convert(i);
    __syncthreads();
    compute();
  }
  cp_async_wait<0>();  // only empty groups are left
  __syncthreads();     // the converted tiles are read: shared memory is free

  if (split > 1) {
    // each block parks its sums thread-major; the first adds the others'
    // in rank order
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float* part = reinterpret_cast<float*>(smem);
    if (rank > 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            part[((mt * NT + nt) * 4 + e) * NTHREADS + tid] = acc[mt][nt][e];
    }
    cluster.sync();
    if (rank == 0) {
      for (int qr = 1; qr < split; ++qr) {
        const float* rp = cluster.map_shared_rank(part, qr);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][nt][e] += rp[((mt * NT + nt) * 4 + e) * NTHREADS + tid];
      }
    }
    cluster.sync();  // the others' shared memory lives until it is read
    if (rank > 0) return;
  }

  // the first roundings into shared memory: K3 bf16(bf16(conv) + bias),
  // K4 bf16(transposed conv)
  u16* ep = reinterpret_cast<u16*>(smem);  // [BM][LDE]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (wm * MT + mt) * 16 + gid + 8 * half;
      const int co = co0 + m;
      const float bv = (!BWD && bias && co < Cout) ? widen(bias[co]) : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = round_bf16(acc[mt][nt][2 * half + e]);
          if (!BWD) v[e] = v[e] + bv;
        }
        *reinterpret_cast<uint32_t*>(ep + m * LDE + (wn * NT + nt) * 8 +
                                     2 * tig) =
            (uint32_t)narrow(v[0]) | ((uint32_t)narrow(v[1]) << 16);
      }
    }
  }
  __syncthreads();

  // then the residual add (K3) or the leaky relu's derivative (K4), rounded
  auto finish = [&](u16 v, const u16* r) {
    const float a = widen(v);
    if (BWD) return widen(*r) >= 0.f ? v : narrow(a * slope);
    return res ? narrow(a + widen(*r)) : v;
  };
  if (yvec) {
    constexpr int PER = BN / 8;
    for (int p = tid; p < BM * PER; p += NTHREADS) {
      const int m = p / PER, n = (p - m * PER) * 8;
      const int co = co0 + m, t = t0 + n;
      if (co >= Cout || t >= T) continue;
      const long long off = ((long long)b * Cout + co) * T + t;
      uint4 v = *reinterpret_cast<const uint4*>(ep + m * LDE + n);
      if (BWD || res) {
        const uint4 rv = *reinterpret_cast<const uint4*>(res + off);
        const u16* rs = reinterpret_cast<const u16*>(&rv);
        u16* vs = reinterpret_cast<u16*>(&v);
#pragma unroll
        for (int e = 0; e < 8; ++e) vs[e] = finish(vs[e], rs + e);
      }
      *reinterpret_cast<uint4*>(y + off) = v;
    }
  } else {
    for (int p = tid; p < BM * BN; p += NTHREADS) {
      const int m = p / BN, n = p - m * BN;
      const int co = co0 + m, t = t0 + n;
      if (co >= Cout || t >= T) continue;
      const long long off = ((long long)b * Cout + co) * T + t;
      const u16 v = ep[m * LDE + n];
      y[off] = (BWD || res) ? finish(v, res + off) : v;
    }
  }
}

// input-channel split of a grid short of four blocks per SM: two blocks a
// cluster where each keeps at least four chunks
inline int channel_split(long long blocks, int Cin) {
  const int nchunks = (Cin + BK - 1) / BK;
  int split = 1;
  while (split < 2 && blocks * split < 4 * SMS && nchunks >= 8 * split)
    split *= 2;
  return split;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int WARPS_M, int MT, int NT, int KT, bool BWD>
int launch(const u16* x, const u16* w, const u16* bias, const u16* res,
           u16* y, int B, int Cin, int Cout, int T, int k, int dil,
           float slope, cudaStream_t stream) {
  constexpr int BM = WARPS_M * MT * 16;
  constexpr int BN = (8 / WARPS_M) * NT * 8;
  const Geom g(BM, BN, k, dil, BWD);
  const dim3 grid((T + BN - 1) / BN, (Cout + BM - 1) / BM, B);
  const int split = channel_split((long long)grid.x * grid.y * grid.z, Cin);
  // the raw stages and converted tiles; the parked partial sums and the
  // epilogue's tile reuse them
  auto need = [&](int stages) {
    int bytes = std::max(g.bytes(stages), 2 * BM * (BN + 8));
    if (split > 1) bytes = std::max(bytes, 4 * MT * NT * 4 * NTHREADS);
    return bytes;
  };
  const int stages = need(MAX_STAGES) <= TWO_BLOCKS_SMEM ? MAX_STAGES : 2;
  const int smem = need(stages);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = conv_bf16_kernel<WARPS_M, MT, NT, KT, BWD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  // x rows start at multiples of T samples; weight rows at multiples of the
  // channels they span (Cin in K3, Cout in K4) x k, and end at a channel
  // edge that is a multiple of 8 elements when those channels are
  const int xvec = (T % 8 == 0 && aligned(x, 16)) ? 8
                   : (T % 2 == 0 && aligned(x, 4)) ? 2
                                                   : 1;
  const int wvec = (BWD ? Cout : Cin) % 8 == 0 && aligned(w, 16);
  const int yvec = T % 8 == 0 && aligned(y, 16) && (!res || aligned(res, 16));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid.x, grid.y, grid.z * split);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, x, w, bias, res, y,
                                           Cin, Cout, T, k, dil, slope, xvec,
                                           wvec, yvec, split, stages);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int WARPS_M, int MT, int NT, bool BWD>
int dispatch_k(const u16* x, const u16* w, const u16* bias, const u16* res,
               u16* y, int B, int Cin, int Cout, int T, int k, int dil,
               float slope, cudaStream_t s) {
  switch (k) {
    case 3: return launch<WARPS_M, MT, NT, 3, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
    case 7: return launch<WARPS_M, MT, NT, 7, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
    case 11: return launch<WARPS_M, MT, NT, 11, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
    default: return launch<WARPS_M, MT, NT, 0, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
  }
}

// Cin / Cout are the channels of the tensor read and of the tensor written.
// 64 x 256 where that gives a block per SM; else, and for the narrow
// stages, 32 x 256 (16 x 256 at Cout <= 16).  On the s2 step's first stage
// (T = 320, 64 x 256 would give 64 blocks) 32 x 256 with two blocks a
// cluster measured faster than 64 x 128 (bench/mrf_bf16_variants.py);
// launch splits a grid short of four blocks per SM along the channels.
template <bool BWD>
int conv_tile(const void* x, const void* w, const void* bias,
              const void* res, void* y, int B, int Cin, int Cout, int T,
              int k, int dil, float slope, cudaStream_t s) {
  if (k < 1 || k % 2 == 0 || dil < 1) return (int)cudaErrorInvalidValue;
  const u16 *xp = (const u16*)x, *wp = (const u16*)w, *bp = (const u16*)bias,
            *rp = (const u16*)res;
  u16* yp = (u16*)y;
  auto blocks = [&](int bm, int bn) {
    return (long long)((T + bn - 1) / bn) * ((Cout + bm - 1) / bm) * B;
  };
  if (Cout >= 64 && blocks(64, 256) >= SMS)
    return dispatch_k<1, 4, 4, BWD>(xp, wp, bp, rp, yp, B, Cin, Cout, T, k, dil, slope, s);
  if (Cout >= 32)
    return dispatch_k<1, 2, 4, BWD>(xp, wp, bp, rp, yp, B, Cin, Cout, T, k, dil, slope, s);
  return dispatch_k<1, 1, 4, BWD>(xp, wp, bp, rp, yp, B, Cin, Cout, T, k, dil, slope, s);
}

}  // namespace mrf_bf16
