// The tiled dilated 1-D convolution under K3 (mrf_conv.cu) and the data
// gradient of K4 (mrf_conv_bwd.cu), on (B, C, T) fp32, T contiguous.
//
//   BWD = false (K3):  y[b,co,t] = bias[co] + sum_ci sum_j w[co,ci,j]
//                          * lrelu(x[b,ci,t+j*dil-pad])  (+ res[b,co,t])
//   BWD = true (K4):   the same loop over dy with the weight transposed and
//                      flipped, w[ci,co,K-1-j], no activation on the load, and
//                      the leaky-relu derivative of the forward's saved input
//                      (passed as `res`) applied in the epilogue:
//                      dx[b,co,t] = lrelu'(res[b,co,t]) * sum_ci sum_j
//                          w[ci,co,K-1-j] * dy[b,ci,t+j*dil-pad]
//                      (pad = (K-1)*dil/2, so t - (K-1-j)*dil + pad is
//                      t + j*dil - pad).  lrelu'(0) is 1, as JAX's
//                      where(x >= 0, ...) takes the first branch there.
//
// An implicit GEMM on the tensor cores: M = output channels, N = time, and a
// reduction over (input channel, tap).  A block owns BM output channels x BN
// samples of one batch row and walks the input channels BK = 8 at a time
// (one m16n8k8 k-step).  Per chunk it stages the x tile with its (k-1)*d
// halo ONCE and reuses it for all k taps and all BM rows: tap j reads the
// same tile shifted by j*d columns, which is what a direct convolution has
// over im2col.  The weight slice of every tap is staged next to it.
//
// fp32 accuracy from TF32 tensor cores in 3xTF32 (warp_mma.cuh: split_tf32,
// mma_tf32, shared with K1).  x, the operand every tap re-reads, is split
// (and in K3 leaky-relu'd) once per staged element, when a chunk moves from
// its raw cp.async stage into the hi/lo planes the MMAs read.  A weight is
// read once per tap by each warp along N, so it stays fp32 in shared memory
// and is split as its A fragment is loaded.  Row strides are chosen so that
// every fragment load hits 32 different banks: 8 mod 32 words for the x
// planes (4 rows x 8 columns per warp), and for the weights 4 mod 32 (K3:
// rows are output channels, k odd spreads the 4 input channels) or 8 mod 32
// (K4: rows are input channels).
//
// Pipeline: two raw stages (x and weights) filled by cp.async, 16-byte
// copies where rows are 16-byte aligned and 4-byte copies otherwise; the
// copies' zero fill gives the "same" padding (lrelu(0) = 0) and the ragged
// channel edges.  Two hi/lo x buffers.  While chunk i multiplies, chunk i+1
// is in flight; then each thread converts the x pieces of chunk i+1 it
// copied itself (so the raw x needs no barrier of its own), one
// __syncthreads per chunk guards the rest, and chunk i+2 is issued into
// chunk i's stage.  Two stages, not three, keep two blocks on an SM at k=7.
//
// Tiles (8 warps a block): 64 x 256 (Cout >= 64) with 64 x 32 warp tiles,
// so that a B fragment feeds 12 MMAs; 64 x 64 when that gives fewer than
// two blocks per SM (the s2 step's short rows); 32 x 256 and 16 x 256 for
// the narrow stages.  A grid of fewer than four blocks per SM is split
// along the input channels: a cluster of 2 or 4 blocks shares one
// output tile, each block sums its share of the chunks, and the first block
// adds the others' partial sums from their shared memory (distributed
// shared memory, in rank order, so the result does not vary between runs)
// before the epilogue.  No scratch in device memory and no atomics.
//
// mma.sync rather than wgmma: tap j starts the B operand j*d rows into the
// staged tile, an offset that is not a multiple of the 8-row core matrices
// that wgmma's swizzled shared-memory descriptors address.  A wgmma form
// would restage the tile per tap (or per tap residue); that is left for a
// later change.
//
// The bf16 instances (the s2 fine-tune under is_half) have a loop of their
// own, on bf16 m16n8k16 tiles: mrf_conv_tile_bf16.cuh.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "warp_mma.cuh"

namespace mrf {

using namespace ev;

constexpr int NTHREADS = 256;  // 8 warps
constexpr int BK = 8;          // input channels per chunk: one k-step
constexpr int STAGES = 2;      // raw cp.async stages
constexpr int SMS = 132;       // SMs of an H100 SXM

__host__ __device__ constexpr int pad_to(int n, int residue) {
  return n + ((residue - n % 32) % 32 + 32) % 32;  // >= n, = residue mod 32
}

// shared-memory geometry of one launch (floats)
struct Geom {
  int halo, pad, rx, ldx, ldw, wstage;
  __host__ __device__ Geom(int bm, int bn, int k, int dil, bool bwd) {
    halo = (k - 1) * dil;
    pad = halo / 2;
    rx = (bn + halo + 3 + 3) & ~3;  // staged samples per row, x4
    ldx = pad_to(rx, 8);
    // K3: [out channel][8 channels x k taps]; K4: [in channel][bm x k]
    ldw = bwd ? pad_to(bm * k, 8) : pad_to(BK * k, 4);
    wstage = bwd ? BK * ldw : bm * ldw;
  }
  // STAGES x (raw x + raw w) + 2 x (hi x + lo x)
  __host__ __device__ size_t floats() const {
    return (size_t)STAGES * ((size_t)BK * ldx + wstage) + 4 * (size_t)BK * ldx;
  }
};

// Block = WARPS_M x (8 / WARPS_M) warps; a warp owns MT m16 x NT n8 tiles.
// KT > 0 fixes the tap count at compile time; KT = 0 reads it from ksize.
// vec: x rows 16-byte aligned (T % 4 == 0); vecw: weight rows too.
// split: blocks per cluster along z (grid z = batch x split), each summing
// its share of the input-channel chunks.
template <int WARPS_M, int MT, int NT, int KT, bool BWD>
__global__ void __launch_bounds__(NTHREADS) conv_mma_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ res,
    float* __restrict__ y, int Cin, int Cout, int T, int ksize, int dil,
    float slope, int vec, int vecw, int split) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int BM = WARPS_M * MT * 16;
  constexpr int BN = WARPS_N * NT * 8;
  const int K = KT > 0 ? KT : ksize;
  const Geom g(BM, BN, K, dil, BWD);
  const int ldx = g.ldx, rx = g.rx, ldw = g.ldw;
  const int xstage = BK * ldx, stage = xstage + g.wstage;

  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                  // [STAGES][raw x | raw w]
  float* cx = smem + STAGES * stage;  // [2][hi, lo][BK][ldx]

  const int b = blockIdx.z / split;
  const int rank = blockIdx.z % split;  // the block's rank in its cluster
  const int co0 = blockIdx.y * BM;
  const int t0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int gid = lane >> 2, tig = lane & 3;
  const int start = t0 - g.pad;
  const int u0 = start & ~3;  // first staged sample, 16-byte aligned
  const int shift = start - u0;
  const float* xb = x + (long long)b * Cin * T;
  const int nchunks = (Cin + BK - 1) / BK;
  const int cbegin = rank * nchunks / split;
  const int nloc = (rank + 1) * nchunks / split - cbegin;
  // a weight row of a chunk: K3 reads 8 channels x K taps of one output
  // channel, K4 bm output channels x K taps of one input channel, both
  // contiguous in w
  const int wrows = BWD ? BK : BM, wlen = BWD ? BM * K : BK * K;

  auto issue = [&](int i, int slot) {
    if (i < nloc) {
      const int ci0 = (cbegin + i) * BK;
      float* rxs = raw + slot * stage;
      if (vec) {
        const int per_row = rx / 4;
        for (int p = tid; p < BK * per_row; p += NTHREADS) {
          const int c = p / per_row, q = (p - c * per_row) * 4;
          const int ci = ci0 + c, t = u0 + q;
          const bool ok = ci < Cin && t >= 0 && t < T;
          cp_async16(rxs + c * ldx + q, ok ? xb + (long long)ci * T + t : x,
                     ok);
        }
      } else {
        for (int p = tid; p < BK * rx; p += NTHREADS) {
          const int c = p / rx, q = p - c * rx;
          const int ci = ci0 + c, t = u0 + q;
          const bool ok = ci < Cin && t >= 0 && t < T;
          cp_async4(rxs + c * ldx + q, ok ? xb + (long long)ci * T + t : x,
                    ok);
        }
      }
      // element q of weight row r: K3 (co0 + r, ci0 + q / K, q % K),
      // K4 (ci0 + r, co0 + q / K, q % K); vecw keeps 4-element pieces
      // inside one channel and one row
      float* rws = rxs + xstage;
      const int step = vecw ? 4 : 1;
      const int per_row = wlen / step;
      for (int p = tid; p < wrows * per_row; p += NTHREADS) {
        const int r = p / per_row, q = (p - r * per_row) * step;
        const int inner = q / K;
        const bool ok = BWD ? (ci0 + r < Cin && co0 + inner < Cout)
                            : (co0 + r < Cout && ci0 + inner < Cin);
        const float* src =
            BWD ? w + ((long long)(ci0 + r) * Cout + co0) * K + q
                : w + ((long long)(co0 + r) * Cin + ci0) * K + q;
        if (vecw)
          cp_async16(rws + r * ldw + q, ok ? src : w, ok);
        else
          cp_async4(rws + r * ldw + q, ok ? src : w, ok);
      }
    }
    cp_async_commit();
  };

  // raw x stage -> hi/lo planes (leaky relu first in K3); each thread walks
  // the pieces it copied itself
  auto convert = [&](int i, int slot, int buf) {
    if (i >= nloc) return;
    const float* rxs = raw + slot * stage;
    float* hx = cx + buf * 2 * xstage;
    float* lx = hx + xstage;
    if (vec) {
      const int per_row = rx / 4;
      for (int p = tid; p < BK * per_row; p += NTHREADS) {
        const int c = p / per_row, o = c * ldx + (p - c * per_row) * 4;
        float4 v = *reinterpret_cast<const float4*>(rxs + o);
        if (!BWD) {
          v.x = v.x >= 0.f ? v.x : v.x * slope;
          v.y = v.y >= 0.f ? v.y : v.y * slope;
          v.z = v.z >= 0.f ? v.z : v.z * slope;
          v.w = v.w >= 0.f ? v.w : v.w * slope;
        }
        float4 h, l;
        split_tf32(v.x, h.x, l.x);
        split_tf32(v.y, h.y, l.y);
        split_tf32(v.z, h.z, l.z);
        split_tf32(v.w, h.w, l.w);
        *reinterpret_cast<float4*>(hx + o) = h;
        *reinterpret_cast<float4*>(lx + o) = l;
      }
    } else {
      for (int p = tid; p < BK * rx; p += NTHREADS) {
        const int c = p / rx, o = c * ldx + (p - c * rx);
        float v = rxs[o];
        if (!BWD) v = v >= 0.f ? v : v * slope;
        split_tf32(v, hx[o], lx[o]);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  // A fragment of m16n8k8.tf32: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
  // a3 (g+8, t+4) for row g = lane / 4, column t = lane % 4; B fragment:
  // b0 (k = t, n = g), b1 (k = t+4, n = g)
  const int m0 = wm * MT * 16 + gid;
  const int abase = BWD ? tig * ldw + m0 * K + (K - 1) : m0 * ldw + tig * K;
  const int jstep = BWD ? -1 : 1;
  const int a_m8 = BWD ? 8 * K : 8 * ldw;  // 8 rows further
  const int a_k4 = BWD ? 4 * ldw : 4 * K;  // 4 channels further
  auto compute = [&](int buf, int slot) {
    const float* hx = cx + buf * 2 * xstage;
    const float* lx = hx + xstage;
    const float* ws = raw + slot * stage + xstage;
    const int col0 = shift + wn * NT * 8 + gid;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* wa = ws + abase + mt * 16 * (BWD ? K : ldw) + j * jstep;
        float hi, lo;
        split_tf32(wa[0], hi, lo);
        ah[mt][0] = __float_as_uint(hi); al[mt][0] = __float_as_uint(lo);
        split_tf32(wa[a_m8], hi, lo);
        ah[mt][1] = __float_as_uint(hi); al[mt][1] = __float_as_uint(lo);
        split_tf32(wa[a_k4], hi, lo);
        ah[mt][2] = __float_as_uint(hi); al[mt][2] = __float_as_uint(lo);
        split_tf32(wa[a_m8 + a_k4], hi, lo);
        ah[mt][3] = __float_as_uint(hi); al[mt][3] = __float_as_uint(lo);
      }
      const int o0 = tig * ldx + col0 + j * dil;
      const int o1 = o0 + 4 * ldx;
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        bh[nt][0] = __float_as_uint(hx[o0 + nt * 8]);
        bh[nt][1] = __float_as_uint(hx[o1 + nt * 8]);
        bl[nt][0] = __float_as_uint(lx[o0 + nt * 8]);
        bl[nt][1] = __float_as_uint(lx[o1 + nt * 8]);
      }
      // the small terms first, each pass over independent accumulators
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_tf32(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_tf32(acc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_tf32(acc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
    }
  };

  issue(0, 0);
  issue(1, 1);
  cp_async_wait<1>();  // this thread's pieces of chunk 0
  convert(0, 0, 0);
  __syncthreads();
  for (int i = 0; i < nloc; ++i) {
    compute(i & 1, i & 1);
    cp_async_wait<0>();  // this thread's pieces of chunk i+1
    convert(i + 1, (i + 1) & 1, (i + 1) & 1);
    __syncthreads();
    issue(i + 2, i & 1);
  }

  if (split > 1) {
    // the stages are free after the last barrier (only empty cp.async
    // groups are left): each block parks its sums there, thread-major
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    float* part = smem;
    if (rank > 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            part[((mt * NT + nt) * 4 + r) * NTHREADS + tid] = acc[mt][nt][r];
    }
    cluster.sync();
    if (rank == 0) {
      for (int q = 1; q < split; ++q) {
        const float* rp = cluster.map_shared_rank(part, q);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              acc[mt][nt][r] += rp[((mt * NT + nt) * 4 + r) * NTHREADS + tid];
      }
    }
    cluster.sync();  // the others' shared memory lives until it is read
    if (rank > 0) return;
  }

  // C fragment: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co0 + (wm * MT + mt) * 16 + gid + 8 * half;
      if (co >= Cout) continue;
      const float bv = (!BWD && bias) ? bias[co] : 0.f;
      const long long row = ((long long)b * Cout + co) * T;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + (wn * NT + nt) * 8 + 2 * tig + e;
          if (t >= T) continue;
          const float a = acc[mt][nt][2 * half + e];
          float out;
          if (BWD) {
            out = res[row + t] >= 0.f ? a : a * slope;
          } else {
            out = a + bv;
            if (res) out += res[row + t];
          }
          y[row + t] = out;
        }
      }
    }
  }
}

// input-channel split that brings the grid to four blocks per SM, keeping
// at least four chunks a block
inline int channel_split(long long blocks, int Cin) {
  const int nchunks = (Cin + BK - 1) / BK;
  int split = 1;
  while (split < 4 && blocks * split < 4 * SMS && nchunks >= 8 * split)
    split *= 2;
  return split;
}

template <int WARPS_M, int MT, int NT, int KT, bool BWD>
int launch_mma(const float* x, const float* w, const float* bias,
               const float* res, float* y, int B, int Cin, int Cout, int T,
               int k, int dil, float slope, cudaStream_t stream) {
  constexpr int BM = WARPS_M * MT * 16;
  constexpr int BN = (8 / WARPS_M) * NT * 8;
  const Geom g(BM, BN, k, dil, BWD);
  const dim3 grid((T + BN - 1) / BN, (Cout + BM - 1) / BM, B);
  const int split =
      channel_split((long long)grid.x * grid.y * grid.z, Cin);
  size_t smem = sizeof(float) * g.floats();
  if (split > 1)  // the partial sums reuse the stages
    smem = std::max(smem, sizeof(float) * MT * NT * 4 * NTHREADS);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kern = conv_mma_kernel<WARPS_M, MT, NT, KT, BWD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // 16-byte copies need 16-byte aligned rows: x rows of T samples, weight
  // rows that start at a multiple of 4 floats and whose channel edge does
  // too (Cin % 4 == 0 in K3, Cout % 4 == 0 in K4: the dim spanned by a row)
  const int vec = (T % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int vecw = ((BWD ? Cout : Cin) % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % 16 == 0);
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
                                           Cin, Cout, T, k, dil, slope, vec,
                                           vecw, split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int WARPS_M, int MT, int NT, bool BWD>
int dispatch_k(const float* x, const float* w, const float* bias,
               const float* res, float* y, int B, int Cin, int Cout, int T,
               int k, int dil, float slope, cudaStream_t s) {
  switch (k) {
    case 3: return launch_mma<WARPS_M, MT, NT, 3, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
    case 7: return launch_mma<WARPS_M, MT, NT, 7, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
    case 11: return launch_mma<WARPS_M, MT, NT, 11, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
    default: return launch_mma<WARPS_M, MT, NT, 0, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
  }
}

// Cin / Cout are the channels of the tensor read and of the tensor written.
// The largest block that still gives two blocks per SM; launch_mma then
// splits a grid short of four per SM along the channels.
template <bool BWD>
int conv_tile(const float* x, const float* w, const float* bias,
              const float* res, float* y, int B, int Cin, int Cout, int T,
              int k, int dil, float slope, cudaStream_t s) {
  if (k < 1 || k % 2 == 0 || dil < 1) return (int)cudaErrorInvalidValue;
  auto blocks = [&](int bm, int bn) {
    return (long long)((T + bn - 1) / bn) * ((Cout + bm - 1) / bm) * B;
  };
  if (Cout >= 64 && blocks(64, 256) >= 2 * SMS)
    return dispatch_k<1, 4, 4, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
  if (Cout >= 64)
    return dispatch_k<2, 2, 2, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
  if (Cout >= 32)
    return dispatch_k<1, 2, 4, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
  return dispatch_k<1, 1, 4, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
}

}  // namespace mrf
