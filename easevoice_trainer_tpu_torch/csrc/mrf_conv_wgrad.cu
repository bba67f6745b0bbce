// K4's weight gradient: the dW and db of one MRF ResBlock conv
// (y = conv1d(leaky_relu(x), w, dilation, same padding) + b), on (B, C, T)
// fp32, T contiguous:
//
//   dw[o,i,q] = sum_{b,t} dy[b,o,t] * lrelu(x)[b,i,t+q*d-p]  (0 outside [0,T))
//   db[o]     = sum_{b,t} dy[b,o,t]
//
// Replaces: the dW / db half of the backward of the Pallas kernel mrf_stage
// (easevoice_trainer_tpu/ops/fused_mrf.py `_bwd_kernel`, git 42ecfe8), which
// summed dW over the batch in VMEM as its sequential grid walked the rows.
// The data gradient is mrf_conv_bwd.cu.
//
// Bound on the H100: one GEMM per tap, M = Cin by N = Cout over a reduction
// of B*T samples.  Over the 45 s2 shapes chip_smoke times (B = 8, (C, T) =
// (256, 320) ... (16, 20480), k in {3, 7, 11}, d in {1, 3, 5}) that is 100.4
// GFLOP: 0.61 ms in 3xTF32 on the tensor cores (3 * 100.4 / 495 TFLOP/s);
// C <= 32 is nearly bound by its bytes (dy and x read once, 21 MB a shape at
// C = 16).  The whole sum is 0.643 ms.
//
// fp32 accuracy from TF32 tensor cores in 3xTF32 (warp_mma.cuh): every
// product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with fp32 accumulators.
//
// Route 1, wgmma (Cin >= 64 and Cout >= 64): a block of three warpgroups
// owns 64 input channels x BN output channels (64 or 128; a wider N gave
// fewer, longer blocks and was slower at C = 256) x one tap a warpgroup,
// for one range of samples.  The tap shift goes through registers, not
// descriptors: a wgmma shared-memory descriptor cannot start an arbitrary
// q*d floats into a K-major tile, so the shifted activation is the register
// operand A (M = input channels): each lane reads its fragment from the raw
// x tile at t + q*d - p, applies the leaky relu and splits hi/lo in
// registers.  dy is operand B (N = output channels, time as K): it lands by cp.async straight
// in the 8 x 16-byte core-matrix layout of a K-major descriptor without
// swizzle (a 16-byte copy is four samples of one channel, one core-matrix
// row), is split once in place into hi and lo planes, and is read by every
// tap's wgmma.  The accumulator is dW^T of one tap, 64 x BN in registers.
// Two stages of dy and x are in flight (cp.async, 16-byte copies when
// T % 4 == 0, 4-byte ones otherwise); the next stage's hi/lo split runs
// while this stage's wgmmas do.
//
// Route 2, mma.sync (Cin < 64 or Cout < 64, the C = 32 / 16 stages): a
// 64-row wgmma tile would be three-quarters empty there, so M is formed from
// (tap, input channel) pairs, up to 32 channels x k taps, and N is 16 or 32
// output channels, on mma.sync.m16n8k8 (ev::mma_tf32), both operands split
// in registers.  The eight warps split the pair rows into groups and the
// k-steps of each 128-sample stage among themselves, so that every warp
// has work at C = 16, k = 3.  These shapes are read once from HBM by a grid
// of two blocks per SM.
//
// The B*T sum is split per shape (ops/mrf.py wgrad_plan): the time tiles of
// all batch rows are cut into S = cluster x clusters contiguous ranges, S
// chosen so that the grid fills the SMs once.  The partial sums are added in
// a fixed order with no float atomics: inside a cluster of up to 8 blocks
// through distributed shared memory, each rank summing its slice of the
// tile over the ranks in rank order; across clusters (when the shape needs
// more than one) through a scratch of clusters x tile floats, after a
// grid-wide barrier of a cooperative launch, in cluster order.  One launch a
// call, and the result repeats bit for bit.  db is summed from the staged dy
// tiles in the same pass, by the blocks of the first input-channel tile (and
// first tap group).
//
// Measured (chip_smoke.py check_k4, NVIDIA H100 80GB HBM3, 700 W): 2.7 ms
// over the 45 shapes, 4.2x the bound, against 6.1 ms for the chunked SIMT
// kernel it replaced and 8.2 ms for cuDNN's wgrad; PERF.md has the calls.
//
// The bf16 instance (ev_mrf_conv_bwd_weight_bf16), the s2 fine-tune's under
// is_half: dy and x bf16, dW and db written as bf16, as jax.vjp of the bf16
// Generator rounds the conv's weight gradient (generator.py:31-44; the
// transpose of the fp32 -> bf16 weight cast then hands the fp32 parameters
// those bf16 values).  The leaky relu is rounded to bf16 as JAX rounds it
// (x * bf16(0.1)), so both operands are exact bf16 and every product is
// exact in fp32; the partial sums stay fp32 and are rounded once, as they
// are written.
//
// Route 3, bf16 wgmma (Cin >= 64 and Cout >= 64; wgrad_wgmma_bf16_kernel):
// the block of route 1 (three warpgroups, a tap each, 64 input channels x
// BN output channels, the same Share of the time tiles and the same fixed
// order of partial sums), with both operands read by descriptor from bf16
// tiles in shared memory, one wgmma.m64nBNk16.f32.bf16.bf16 per 16 samples
// and tap (wgmma_bf16.cuh), no hi/lo split.  dy is operand B, K-major: 8
// samples of one channel make a 16-byte core-matrix row.  lrelu(x) is
// operand A, M-major: one 16-byte row is 8 input channels at one sample, so
// the tap shift of q*d samples is q*d whole rows and each tap's operand is
// the same tile with the descriptor's start moved by q*d*16 bytes.  One
// thread copies a 128-sample stage of dy and the raw x window by two TMA
// boxes whose tensor maps (tile_map) land them as [8-sample chunk][channel]
// [8 samples], dy directly in the K-major core-matrix layout, counted on an
// mbarrier, zeros past the edges of T and of the channels; the warps then
// transpose the raw x window (ldmatrix.trans into stmatrix), applying the
// bf16 leaky relu on the way, once per element.  Stage i + 2 is copied and
// stage i + 1 transposed while the wgmmas of stage i run (three dy stages,
// two of x).  Rows that are not 16-byte aligned (T % 8 != 0) are copied by
// plain loads instead.  Below 64 channels the bf16 instance takes route 2,
// dy and x widened from bf16 into its fp32 stages by plain loads, one TF32
// mma a product.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_io.cuh"
#include "warp_mma.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace ev;
namespace cg = cooperative_groups;

constexpr int NTH = 256;    // threads an mma.sync block: eight warps
constexpr int MAX_K = 15;   // taps: the mma route holds 32 x k pair rows
constexpr int BM = 64;      // input channels a wgmma tile (the M of wgmma)
constexpr int MTS = 128;    // samples a stage on the mma route
constexpr int LDY = MTS + 4;  // = 4 mod 32

constexpr int NWG = 3;            // warpgroups of a wgmma block, a tap each
constexpr int WG_THREADS = 128 * NWG;
constexpr int TS = 64;            // samples a stage on the wgmma route

// >= n and = 4 mod 32: the rows a warp's fragment loads touch (8 rows x 4
// columns) fall in 32 different banks
__host__ __device__ constexpr int pad_rows(int n) {
  return n + ((4 - n % 32) % 32 + 32) % 32;
}

// the staged x window of a stage of ts samples: [u0, u0 + rx) with u0 the
// 16-byte aligned sample at or before t0 - pad
struct Window {
  int pad, rx, ldx;
  __host__ __device__ Window(int ts, int k, int dil) {
    const int halo = (k - 1) * dil;
    pad = halo / 2;
    rx = (ts + halo + 3 + 3) & ~3;
    ldx = pad_rows(rx);
  }
};

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// The output tile of an mma.sync block, and the order of its partial sums
// in shared memory and scratch: element e = (o_l * ti + i_l) * tq + q_l of
// the dW tile, then `to` db values.
struct OutTile {
  int o0, i0, to, ti, tq;
  bool db;
  __device__ int floats() const { return to * ti * tq + to; }
  template <typename O>
  __device__ void put(int e, float v, O* dw, O* db_out, int Cin,
                      int Cout, int K) const {
    const int body = to * ti * tq;
    if (e < body) {
      const int ol = e / (ti * tq), rem = e - ol * ti * tq;
      const int il = rem / tq, ql = rem - il * tq;
      const int o = o0 + ol, i = i0 + il;
      if (o < Cout && i < Cin) ev::put(dw + ((long long)o * Cin + i) * K + ql, v);
    } else if (db) {
      const int o = o0 + e - body;
      if (o < Cout) ev::put(db_out + o, v);
    }
  }
};

// sum of p[0], p[stride], ... p[(n-1)*stride] in that order; the loads of
// eight terms are issued before their adds
__device__ __forceinline__ float ordered_sum(const float* p, long long stride,
                                             int n) {
  float v = 0.f;
  for (int c0 = 0; c0 < n; c0 += 8) {
    float t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) t[u] = c0 + u < n ? p[(c0 + u) * stride] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c0 + u < n) v += t[u];
  }
  return v;
}

// The output tile of a wgmma block: its partial sums stay in the order of
// the accumulator registers, thread-major (element r * THREADS + tid is
// acc[r] of thread tid, warpgroup tid / 128 holding tap q0 + tid / 128),
// so that parking them is conflict-free and finding an element's (o, i, q)
// takes shifts; then BN db values.
template <int BN>
struct WgTile {
  static constexpr int THREADS = WG_THREADS;
  static constexpr int BODY = (BN / 2) * THREADS;
  int o0, i0, q0, taps;
  bool db;
  __device__ int floats() const { return BODY + BN; }
  template <typename O>
  __device__ void put(int e, float v, O* dw, O* db_out, int Cin, int Cout,
                      int K) const {
    if (e < BODY) {
      const int t = e % THREADS, r = e / THREADS;
      const int ql = t / 128, lane = t % 32;
      const int il = (t / 32 % 4) * 16 + lane / 4 + 8 * ((r >> 1) & 1);
      const int ol = (r >> 2) * 8 + 2 * (lane % 4) + (r & 1);
      const int o = o0 + ol, i = i0 + il, q = q0 + ql;
      if (ql < taps && o < Cout && i < Cin && q < K)
        ev::put(dw + ((long long)o * Cin + i) * K + q, v);
    } else if (db) {
      const int o = o0 + e - BODY;
      if (o < Cout) ev::put(db_out + o, v);
    }
  }
};

// The block's partial sums are in `part` (out.floats() floats).  Adds them
// over the blocks of the cluster (blockIdx.x / cs) in rank order, then over
// the clusters in cluster order, and writes dW and db.
template <class Tile, typename O>
__device__ void reduce_partials(const float* part, const Tile& out,
                                O* dw, O* db, float* scratch, int Cin,
                                int Cout, int K, int cs, int nc) {
  const int L = out.floats();
  const int tid = threadIdx.x, nth = blockDim.x;
  const int s = blockIdx.x, S = gridDim.x;
  const long long slot = ((long long)(s / cs) * gridDim.y + blockIdx.y) * L;
  auto keep = [&](int e, float v) {
    if (nc == 1)
      out.put(e, v, dw, db, Cin, Cout, K);
    else
      scratch[slot + e] = v;
  };
  if (cs > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = (int)cluster.block_rank();
    const float* remote[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      remote[r] = cluster.map_shared_rank(const_cast<float*>(part),
                                          r < cs ? r : 0);
    for (int e = rank * L / cs + tid; e < (rank + 1) * L / cs; e += nth) {
      float t[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) t[r] = r < cs ? remote[r][e] : 0.f;
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < cs) v += t[r];
      keep(e, v);
    }
    cluster.sync();  // the others' shared memory lives until it is read
  } else {
    __syncthreads();
    for (int e = tid; e < L; e += nth) keep(e, part[e]);
  }
  if (nc > 1) {
    __threadfence();
    cg::this_grid().sync();
    const long long stride = (long long)gridDim.y * L;
    const float* base = scratch + (long long)blockIdx.y * L;
    for (int e = s * L / S + tid; e < (s + 1) * L / S; e += nth)
      out.put(e, ordered_sum(base + e, stride, nc), dw, db, Cin, Cout, K);
  }
}

// reduce_partials four floats at a time, for the bf16 wgmma route (the
// fp32 routes keep reduce_partials, so their code stays as it was): the
// same sums in the same order, with 16-byte loads and stores.  The tile's
// floats() and the scratch slots are multiples of 4.
template <class Tile, typename O>
__device__ void reduce_partials4(const float* part, const Tile& out, O* dw,
                                 O* db, float* scratch, int Cin, int Cout,
                                 int K, int cs, int nc) {
  const int L = out.floats(), L4 = L / 4;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int s = blockIdx.x, S = gridDim.x;
  const long long slot = ((long long)(s / cs) * gridDim.y + blockIdx.y) * L;
  auto keep = [&](int e4, const float4& v) {
    if (nc == 1) {
      out.put(4 * e4, v.x, dw, db, Cin, Cout, K);
      out.put(4 * e4 + 1, v.y, dw, db, Cin, Cout, K);
      out.put(4 * e4 + 2, v.z, dw, db, Cin, Cout, K);
      out.put(4 * e4 + 3, v.w, dw, db, Cin, Cout, K);
    } else {
      reinterpret_cast<float4*>(scratch + slot)[e4] = v;
    }
  };
  if (cs > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = (int)cluster.block_rank();
    const float4* remote[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      remote[r] = reinterpret_cast<const float4*>(cluster.map_shared_rank(
          const_cast<float*>(part), r < cs ? r : 0));
    for (int e4 = rank * L4 / cs + tid; e4 < (rank + 1) * L4 / cs;
         e4 += nth) {
      float4 t[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        t[r] = r < cs ? remote[r][e4] : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < cs) {
          v.x += t[r].x;
          v.y += t[r].y;
          v.z += t[r].z;
          v.w += t[r].w;
        }
      keep(e4, v);
    }
    cluster.sync();  // the others' shared memory lives until it is read
  } else {
    __syncthreads();
    for (int e4 = tid; e4 < L4; e4 += nth)
      keep(e4, reinterpret_cast<const float4*>(part)[e4]);
  }
  if (nc > 1) {
    __threadfence();
    cg::this_grid().sync();
    const long long stride = (long long)gridDim.y * L / 4;
    const float4* base =
        reinterpret_cast<const float4*>(scratch + (long long)blockIdx.y * L);
    for (int e4 = s * L4 / S + tid; e4 < (s + 1) * L4 / S; e4 += nth) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c0 = 0; c0 < nc; c0 += 8) {
        float4 t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          t[u] = c0 + u < nc ? base[e4 + (c0 + u) * stride]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (c0 + u < nc) {
            v.x += t[u].x;
            v.y += t[u].y;
            v.z += t[u].z;
            v.w += t[u].w;
          }
      }
      out.put(4 * e4, v.x, dw, db, Cin, Cout, K);
      out.put(4 * e4 + 1, v.y, dw, db, Cin, Cout, K);
      out.put(4 * e4 + 2, v.z, dw, db, Cin, Cout, K);
      out.put(4 * e4 + 3, v.w, dw, db, Cin, Cout, K);
    }
  }
}

// this block's share of the B * ceil(T/ts) time tiles: [first, first + n)
struct Share {
  int first, n, per_row;
  __device__ Share(int B, int T, int ts) {
    per_row = (T + ts - 1) / ts;
    const long long total = (long long)B * per_row;
    first = (int)(blockIdx.x * total / gridDim.x);
    n = (int)((blockIdx.x + 1) * total / gridDim.x) - first;
  }
};

// ---------------------------------------------------------------- wgmma --

// offset (floats) of dy[o][u] in a K-major core-matrix plane of bn rows
__device__ __forceinline__ int plane_at(int o, int u, int bn) {
  return (u >> 2) * (4 * bn) + (o >> 3) * 32 + (o & 7) * 4 + (u & 3);
}

// grid: (S, m tiles x n tiles x tap groups); taps: taps a block (<= NWG)
template <int BN>
__global__ void __launch_bounds__(WG_THREADS, 1) wgrad_wgmma_kernel(
    const float* __restrict__ dy, const float* __restrict__ x,
    float* __restrict__ dw, float* __restrict__ db,
    float* __restrict__ scratch, int B, int Cin, int Cout, int T, int K,
    int dil, float slope, int taps, int cs, int nc, int vec) {
  if (B == 0) return;  // a probe launch (ev_mrf_conv_bwd_weight_max_clusters)
  constexpr int PLANE = BN * TS;  // floats of a dy plane
  constexpr int NTHR = WG_THREADS;
  constexpr int XT = NTHR / BM;   // threads an x row
  const Window win(TS, K, dil);
  const int ldx = win.ldx, rx = win.rx;
  const int stage = 2 * PLANE + BM * ldx;
  extern __shared__ __align__(128) float smem[];

  const int groups = (K + taps - 1) / taps;
  const int ntiles = (Cout + BN - 1) / BN;
  const int g = blockIdx.y % groups;
  const int n0 = (blockIdx.y / groups % ntiles) * BN;
  const int m0 = blockIdx.y / groups / ntiles * BM;
  const WgTile<BN> out{n0, m0, g * taps, taps, m0 == 0 && g == 0};

  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup index, read from lane 0 so that the compiler sees it is
  // the same across the warp: the branches on it around wgmma are uniform
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wq = (tid >> 5) & 3, gid = lane >> 2, tig = lane & 3;
  const Share share(B, T, TS);

  auto tile_t0 = [&](int i, int& b) {
    const int tt = share.first + i;
    b = tt / share.per_row;
    return (tt - b * share.per_row) * TS;
  };

  const int dyo = tid % BN, xr = tid / XT;
  const bool dy_ok = n0 + dyo < Cout, x_ok = m0 + xr < Cin;
  auto issue = [&](int i, int slot) {
    if (i < share.n) {
      int b;
      const int t0 = tile_t0(i, b);
      const int u0 = (t0 - win.pad) & ~3;
      float* hi = smem + slot * stage;
      float* xs = hi + 2 * PLANE;
      const float* dyb = dy + (long long)b * Cout * T;
      const float* xb = x + (long long)b * Cin * T;
      // thread tid copies dy row dyo (a fixed output channel) and x row
      // xr, every NTHR / BN-th and XT-th piece of them
      const float* dyr = dyb + (long long)(n0 + dyo) * T;
      const float* xrow = xb + (long long)(m0 + xr) * T;
      if (vec) {
        for (int c = tid / BN; c < TS / 4; c += NTHR / BN) {
          const int t = t0 + 4 * c;
          const bool ok = dy_ok && t < T;
          cp_async16(hi + plane_at(dyo, 4 * c, BN), ok ? dyr + t : dy, ok);
        }
        for (int c = tid % XT; c < rx / 4; c += XT) {
          const int t = u0 + 4 * c;
          const bool ok = x_ok && t >= 0 && t < T;
          cp_async16(xs + xr * ldx + 4 * c, ok ? xrow + t : x, ok);
        }
      } else {
        for (int u = tid / BN; u < TS; u += NTHR / BN) {
          const int t = t0 + u;
          const bool ok = dy_ok && t < T;
          cp_async4(hi + plane_at(dyo, u, BN), ok ? dyr + t : dy, ok);
        }
        for (int c = tid % XT; c < rx; c += XT) {
          const int t = u0 + c;
          const bool ok = x_ok && t >= 0 && t < T;
          cp_async4(xs + xr * ldx + c, ok ? xrow + t : x, ok);
        }
      }
    }
    cp_async_commit();
  };

  // raw dy (in the hi plane) -> hi and lo planes; each thread splits the
  // pieces it copied itself, all of output channel tid % BN, and adds them to
  // its share of db
  float db_acc = 0.f;
  auto convert = [&](int i, int slot) {
    if (i >= share.n) return;
    float* hi = smem + slot * stage;
    float* lo = hi + PLANE;
    if (vec) {
      for (int c = tid / BN; c < TS / 4; c += NTHR / BN) {
        const int off = plane_at(dyo, 4 * c, BN);
        const float4 v = *reinterpret_cast<const float4*>(hi + off);
        db_acc += v.x;
        db_acc += v.y;
        db_acc += v.z;
        db_acc += v.w;
        float4 h, l;
        split_tf32(v.x, h.x, l.x);
        split_tf32(v.y, h.y, l.y);
        split_tf32(v.z, h.z, l.z);
        split_tf32(v.w, h.w, l.w);
        *reinterpret_cast<float4*>(hi + off) = h;
        *reinterpret_cast<float4*>(lo + off) = l;
      }
    } else {
      for (int u = tid / BN; u < TS; u += NTHR / BN) {
        const int off = plane_at(dyo, u, BN);
        float h, l;
        db_acc += hi[off];
        split_tf32(hi[off], h, l);
        hi[off] = h;
        lo[off] = l;
      }
    }
  };

  // warpgroup wgi holds tap q0 + wgi of the block
  float acc[BN / 2];
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
  const bool live = wgi < taps && out.q0 + wgi < K;
  const int xcol = (out.q0 + wgi) * dil + tig;
  const int xr0 = (wq * 16 + gid) * ldx, xr1 = xr0 + 8 * ldx;

  issue(0, 0);
  issue(1, 1);
  cp_async_wait<1>();
  convert(0, 0);
  fence_proxy_async();
  __syncthreads();
  for (int i = 0; i < share.n; ++i) {
    const int slot = i & 1;
    const float* hi = smem + slot * stage;
    const float* lo = hi + PLANE;
    const float* xs = hi + 2 * PLANE;
    int b;
    const int start = tile_t0(i, b) - win.pad;
    const int shift = start - (start & ~3);
    const uint64_t dh = interleave_desc(hi, BN * 16, 128);
    const uint64_t dl = interleave_desc(lo, BN * 16, 128);
    // two k-steps an iteration: their A fragments are two register sets,
    // one loaded while the other's wgmmas run
#pragma unroll 2
    for (int ks = 0; ks < TS / 8; ++ks) {
      if (!live) break;
      uint32_t ah[4], al[4];
      const int c = shift + xcol + 8 * ks;
      const float v[4] = {xs[xr0 + c], xs[xr1 + c], xs[xr0 + c + 4],
                          xs[xr1 + c + 4]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float h, l;
        split_tf32(lrelu(v[e], slope), h, l);
        ah[e] = __float_as_uint(h);
        al[e] = __float_as_uint(l);
      }
      wgmma_fence();
      // 8 samples further along K: two core matrices of 4 * BN floats
      const uint64_t step = (uint64_t)(2 * BN * ks);
      Wgmma<BN>::mma(acc, al, dh + step);
      Wgmma<BN>::mma(acc, ah, dl + step);
      Wgmma<BN>::mma(acc, ah, dh + step);
      wgmma_commit();
      wgmma_wait<1>();
    }
    cp_async_wait<0>();  // this thread's pieces of tile i + 1
    convert(i + 1, slot ^ 1);
    fence_proxy_async();
    wgmma_wait<0>();
    __syncthreads();
    issue(i + 2, slot);
  }

  // the stages are free (only empty cp.async groups are left): park the
  // partial sums there in the WgTile order; db's shares go after them and
  // are added over the threads of each channel in thread order
  float* part = smem;
  const int body = WgTile<BN>::BODY;
  part[body + BN + tid] = db_acc;
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) part[r * NTHR + tid] = acc[r];
  __syncthreads();
  if (tid < BN) {
    float v = 0.f;
    for (int r = tid; r < NTHR; r += BN) v += part[body + BN + r];
    part[body + tid] = v;
  }
  reduce_partials(part, out, dw, db, scratch, Cin, Cout, K, cs, nc);
}

// ----------------------------------------------------------- bf16 wgmma --

constexpr int TSB = 128;     // samples a stage on the bf16 wgmma route
constexpr int DY_SLOTS = 3;  // dy stages: in the wgmmas, landed, in flight
constexpr int X_SLOTS = 2;   // lrelu(x) stages, and raw x tiles

// The bf16 route's x window of a stage: samples [u0, u0 + rx) with u0 the
// 8-sample aligned one at or before t0 - pad; rx a multiple of 32 (a warp
// transposes 8 channels x 32 samples at a time).
struct WindowBf16 {
  int pad, rx;
  __host__ __device__ WindowBf16(int k, int dil) {
    const int halo = (k - 1) * dil;
    pad = halo / 2;
    rx = (TSB + halo + 7 + 31) & ~31;
  }
};

// lrelu of two bf16 as JAX's bf16 leaky relu: max(v, bf16(v * slope)), the
// same as v >= 0 ? v : bf16(v * slope) for slope < 1
__device__ __forceinline__ uint32_t lrelu_bf16x2(uint32_t v, uint32_t s2) {
  uint32_t m, r;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(m) : "r"(v), "r"(s2));
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(v), "r"(m));
  return r;
}

// the 8 samples t .. t + 7 of a bf16 row into 16 bytes of shared memory by
// plain loads, zero outside [0, T) or where !ok (the path for rows that are
// not 16-byte aligned, which a tensor map cannot describe)
__device__ __forceinline__ void copy8_narrow(bf16* dst, const bf16* row,
                                             int t, bool ok, int T) {
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int a = t + 2 * e, b = a + 1;
    const uint32_t lo = ok && a >= 0 && a < T ? r[a] : 0u;
    const uint32_t hi = ok && b >= 0 && b < T ? r[b] : 0u;
    w[e] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// grid: (S, m tiles x n tiles x tap groups), as wgrad_wgmma_kernel.  Shared
// memory: DY_SLOTS dy stages and X_SLOTS raw x tiles, both laid out
// [8-sample chunk][channel][8 samples] (for dy, the K-major core-matrix
// columns of BN rows), and X_SLOTS lrelu(x) stages (8 planes of rx rows x
// 16 bytes, 8 channels a row).  With `tma`, one thread copies a tile's dy
// and raw x with two TMA boxes (map_dy, map_x: tile_map) counted against
// the tile's mbarrier; else every thread copies pieces by plain loads.
// Tile i + 2 is copied while the wgmmas of tile i run and tile i + 1 is
// transposed.
template <int BN>
__global__ void __launch_bounds__(WG_THREADS, 1) wgrad_wgmma_bf16_kernel(
    const bf16* __restrict__ dy, const bf16* __restrict__ x,
    bf16* __restrict__ dw, bf16* __restrict__ db,
    float* __restrict__ scratch, int B, int Cin, int Cout, int T, int K,
    int dil, float slope, int taps, int cs, int nc, int tma,
    const __grid_constant__ CUtensorMap map_dy,
    const __grid_constant__ CUtensorMap map_x) {
  if (B == 0) return;  // a probe launch (ev_mrf_conv_bwd_weight_max_clusters)
  constexpr int NTHR = WG_THREADS;
  constexpr int NWARP = NTHR / 32;
  constexpr int DYS = BN * TSB;  // bf16 of a dy stage
  const WindowBf16 win(K, dil);
  const int rx = win.rx, xsize = BM * rx;  // bf16 of an x stage or tile
  const int x_units = 8 * (rx / 32);  // 8-channel x 32-sample pieces
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bars[DY_SLOTS];
  bf16* const dys = reinterpret_cast<bf16*>(smem);
  bf16* const xss = dys + DY_SLOTS * DYS;
  bf16* const raws = xss + X_SLOTS * xsize;

  const int groups = (K + taps - 1) / taps;
  const int ntiles = (Cout + BN - 1) / BN;
  const int g = blockIdx.y % groups;
  const int n0 = (blockIdx.y / groups % ntiles) * BN;
  const int m0 = blockIdx.y / groups / ntiles * BM;
  const WgTile<BN> out{n0, m0, g * taps, taps, m0 == 0 && g == 0};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warpgroup index, read from lane 0 so that the compiler sees it is
  // the same across the warp: the branches on it around wgmma are uniform
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const Share share(B, T, TSB);
  const uint32_t slope2 = narrow2(slope, slope);

  auto tile_t0 = [&](int i, int& b) {
    const int tt = share.first + i;
    b = tt / share.per_row;
    return (tt - b * share.per_row) * TSB;
  };

  if (tma && tid == 0) {
    for (int s = 0; s < DY_SLOTS; ++s) mbar_init(&bars[s], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // dy of tile i into its dy slot, its raw x window into its raw slot
  auto issue = [&](int i) {
    if (i >= share.n) return;
    int b;
    const int t0 = tile_t0(i, b);
    const int u0 = (t0 - win.pad) & ~7;
    bf16* ys = dys + i % DY_SLOTS * DYS;
    bf16* raw = raws + i % X_SLOTS * xsize;
    if (tma) {
      if (tid == 0) {
        uint64_t* bar = &bars[i % DY_SLOTS];
        mbar_expect(bar, 2 * (DYS + xsize));
        tma_load_4d(ys, &map_dy, bar, 0, n0, t0 / 8, b);
        tma_load_4d(raw, &map_x, bar, 0, m0, u0 / 8, b);
      }
      return;
    }
    const bf16* dyb = dy + (long long)b * Cout * T;
    for (int p = tid; p < BN * (TSB / 8); p += NTHR) {
      const int o = p % BN, c = p / BN;
      copy8_narrow(ys + (c * BN + o) * 8, dyb + (long long)(n0 + o) * T,
                   t0 + 8 * c, n0 + o < Cout, T);
    }
    const bf16* xb = x + (long long)b * Cin * T;
    for (int p = tid; p < BM * (rx / 8); p += NTHR) {
      const int r = p % BM, c = p / BM;
      copy8_narrow(raw + (c * BM + r) * 8, xb + (long long)(m0 + r) * T,
                   u0 + 8 * c, m0 + r < Cin, T);
    }
  };

  // raw x of tile i -> lrelu(x), M-major: matrix j of a warp's piece is 8
  // channels x the samples of chunk 4 (piece / 8) + j, transposed by
  // ldmatrix.trans into stmatrix, the bf16 leaky relu applied on the way
  auto convert = [&](int i) {
    const bf16* raw = raws + i % X_SLOTS * xsize;
    bf16* xs = xss + i % X_SLOTS * xsize;
    for (int un = warp; un < x_units; un += NWARP) {
      const int cg = un & 7, c = (un >> 3) * 4 + (lane >> 3);
      uint32_t v[4];
      ldsm4_trans(v, smem_addr(raw + (c * BM + cg * 8 + (lane & 7)) * 8));
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = lrelu_bf16x2(v[j], slope2);
      stsm4(smem_addr(xs + (cg * rx + 8 * c + (lane & 7)) * 8), v);
    }
  };
  auto landed = [&](int i) {  // tile i's copies: a TMA's, or every thread's
    if (tma)
      mbar_wait(&bars[i % DY_SLOTS], (i / DY_SLOTS) & 1);
    else if (i == 0)  // later tiles' plain loads precede a loop barrier
      __syncthreads();
  };

  // warpgroup wgi holds tap q0 + wgi of the block; thread tid < BN sums db
  // of output channel n0 + tid over the staged dy, when this block writes db
  float acc[BN / 2];
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
  float db_acc = 0.f;
  const bool live = wgi < taps && out.q0 + wgi < K;
  const int qrow = (out.q0 + wgi) * dil;  // the tap's shift, in x rows

  issue(0);
  issue(1);
  if (share.n > 0) {
    landed(0);
    convert(0);
  }
  fence_proxy_async();
  __syncthreads();
  for (int i = 0; i < share.n; ++i) {
    const bf16* ys = dys + i % DY_SLOTS * DYS;
    const bf16* xs = xss + i % X_SLOTS * xsize;
    int b;
    const int start = tile_t0(i, b) - win.pad;
    const int shift = start - (start & ~7);
    if (live) {
      // A: rows shift + q*d + 16 ks .. of every plane (LBO: the next 8
      // rows; SBO: the next plane); B: the 2 ks-th and (2 ks + 1)-th
      // core-matrix columns (LBO: one column; SBO: the next 8 channels)
      const uint64_t da = interleave_desc(xs + (shift + qrow) * 8, 128,
                                          rx * 16);
      const uint64_t dd = interleave_desc(ys, BN * 16, 128);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < TSB / 16; ++ks)
        WgmmaBf16<BN>::mma(acc, da + (uint64_t)(16 * ks),
                           dd + (uint64_t)(2 * BN * ks));
      wgmma_commit();
    }
    // into the slots of tile i - 1 (whose wgmmas, db and transpose ended
    // at the last barrier) and the raw slot of tile i (transposed)
    issue(i + 2);
    if (out.db && tid < BN) {
#pragma unroll 4
      for (int c = 0; c < TSB / 8; ++c) {
        float f[8];
        widen8(ys + (c * BN + tid) * 8, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) db_acc += f[e];
      }
    }
    if (i + 1 < share.n) {
      landed(i + 1);
      convert(i + 1);
    }
    fence_proxy_async();
    wgmma_wait<0>();
    __syncthreads();
  }

  // the stages are free: park the partial sums there in the WgTile order,
  // then db
  float* part = smem;
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) part[r * NTHR + tid] = acc[r];
  if (tid < BN) part[WgTile<BN>::BODY + tid] = db_acc;
  reduce_partials4(part, out, dw, db, scratch, Cin, Cout, K, cs, nc);
}

// -------------------------------------------------------------- mma.sync --

// grid: (S, input-channel tiles of ci x output-channel tiles of 8 NT).  A
// warp holds MT m16 tiles of (tap, input channel) pair rows by NT n8 tiles
// of output channels; the pair rows are cut into pair groups of MT tiles
// and the eight warps into (pair group, sample group): warp w takes pair
// group w % pgp and the k-steps w / pgp, w / pgp + 8 / pgp, ... of a stage.
// E: the element type of dy, x, dw and db in device memory.
template <int MT, int NT, typename E>
__global__ void __launch_bounds__(NTH, 2) wgrad_mma_kernel(
    const E* __restrict__ dy, const E* __restrict__ x,
    E* __restrict__ dw, E* __restrict__ db,
    float* __restrict__ scratch, int B, int Cin, int Cout, int T, int K,
    int dil, float slope, int ci, int cs, int nc, int vec) {
  constexpr bool LOW = !std::is_same<E, float>::value;  // bf16 operands
  if (B == 0) return;  // a probe launch (ev_mrf_conv_bwd_weight_max_clusters)
  constexpr int MO = 8 * NT;     // output channels a tile
  constexpr int DYT = NTH / MO;  // threads a dy row
  const Window win(MTS, K, dil);
  const int ldx = win.ldx, rx = win.rx;
  const int stage = MO * LDY + ci * ldx;
  extern __shared__ __align__(128) float smem[];

  const int cotiles = (Cout + MO - 1) / MO;
  const int o0 = blockIdx.y % cotiles * MO, i0 = blockIdx.y / cotiles * ci;
  const OutTile out{o0, i0, MO, ci, K, i0 == 0};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const Share share(B, T, MTS);
  const int pairs = ci * K;
  const int groups = ((pairs + 15) / 16 + MT - 1) / MT;  // <= 8
  const int pgp = groups <= 1 ? 1 : groups <= 2 ? 2 : groups <= 4 ? 4 : 8;
  const int pg = warp % pgp, sg = warp / pgp, sgn = 8 / pgp;
  const bool busy = pg < groups;
  // pair row p is (tap p / ci, input channel p % ci); ci is 16 or 32
  const int ci_log2 = ci == 16 ? 4 : 5;
  auto x_at = [&](int p) {
    return p < pairs ? (p & (ci - 1)) * ldx + (p >> ci_log2) * dil + tig : 0;
  };
  const int nlive = min(NT, (min(MO, Cout - o0) + 7) / 8);

  auto tile_t0 = [&](int i, int& b) {
    const int tt = share.first + i;
    b = tt / share.per_row;
    return (tt - b * share.per_row) * MTS;
  };

  // thread tid copies every DYT-th piece of dy row dyo and every
  // (NTH / ci)-th piece of x row xr
  const int dyo = tid / DYT, xt = NTH / ci, xr = tid / xt;
  const bool dy_ok = o0 + dyo < Cout, x_ok = i0 + xr < Cin;
  auto issue = [&](int i, int slot) {
    if (i < share.n) {
      int b;
      const int t0 = tile_t0(i, b);
      const int u0 = (t0 - win.pad) & ~3;
      float* ys = smem + slot * stage;
      float* xs = ys + MO * LDY;
      const E* dyr = dy + ((long long)b * Cout + o0 + dyo) * T;
      const E* xrow = x + ((long long)b * Cin + i0 + xr) * T;
      if constexpr (LOW) {
        // the same pieces, widened into the fp32 stages by plain loads
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        if (vec) {
          for (int c = tid % DYT; c < MTS / 4; c += DYT) {
            const int t = t0 + 4 * c;
            const bool ok = dy_ok && t < T;
            *reinterpret_cast<float4*>(ys + dyo * LDY + 4 * c) =
                ok ? widen4(dyr + t) : zero;
          }
          for (int c = tid % xt; c < rx / 4; c += xt) {
            const int t = u0 + 4 * c;
            const bool ok = x_ok && t >= 0 && t < T;
            *reinterpret_cast<float4*>(xs + xr * ldx + 4 * c) =
                ok ? widen4(xrow + t) : zero;
          }
        } else {
          for (int u = tid % DYT; u < MTS; u += DYT) {
            const int t = t0 + u;
            ys[dyo * LDY + u] = dy_ok && t < T ? widen(dyr[t]) : 0.f;
          }
          for (int c = tid % xt; c < rx; c += xt) {
            const int t = u0 + c;
            xs[xr * ldx + c] =
                x_ok && t >= 0 && t < T ? widen(xrow[t]) : 0.f;
          }
        }
      } else if (vec) {
        for (int c = tid % DYT; c < MTS / 4; c += DYT) {
          const int t = t0 + 4 * c;
          const bool ok = dy_ok && t < T;
          cp_async16(ys + dyo * LDY + 4 * c, ok ? dyr + t : dy, ok);
        }
        for (int c = tid % xt; c < rx / 4; c += xt) {
          const int t = u0 + 4 * c;
          const bool ok = x_ok && t >= 0 && t < T;
          cp_async16(xs + xr * ldx + 4 * c, ok ? xrow + t : x, ok);
        }
      } else {
        for (int u = tid % DYT; u < MTS; u += DYT) {
          const int t = t0 + u;
          const bool ok = dy_ok && t < T;
          cp_async4(ys + dyo * LDY + u, ok ? dyr + t : dy, ok);
        }
        for (int c = tid % xt; c < rx; c += xt) {
          const int t = u0 + c;
          const bool ok = x_ok && t >= 0 && t < T;
          cp_async4(xs + xr * ldx + c, ok ? xrow + t : x, ok);
        }
      }
    }
    cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][nt][r] = 0.f;
  float db_acc = 0.f;

  issue(0, 0);
  issue(1, 1);
  for (int i = 0; i < share.n; ++i) {
    const int slot = i & 1;
    cp_async_wait<1>();  // this thread's pieces of tile i
    __syncthreads();
    const float* ys = smem + slot * stage;
    const float* xs = ys + MO * LDY;
    int b;
    const int start = tile_t0(i, b) - win.pad;
    const int shift = start - (start & ~3);
    for (int ks = busy ? sg : MTS / 8; ks < MTS / 8; ks += sgn) {
      // B fragment: b0 (k = t, n = g), b1 (k = t+4, n = g)
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= nlive) continue;
        const float* yr = ys + (nt * 8 + gid) * LDY + 8 * ks + tig;
        if constexpr (LOW) {  // bf16 dy: exact in TF32
          bh[nt][0] = __float_as_uint(yr[0]);
          bh[nt][1] = __float_as_uint(yr[4]);
        } else {
        float h, l;
        split_tf32(yr[0], h, l);
        bh[nt][0] = __float_as_uint(h);
        bl[nt][0] = __float_as_uint(l);
        split_tf32(yr[4], h, l);
        bh[nt][1] = __float_as_uint(h);
        bl[nt][1] = __float_as_uint(l);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int base = (pg * MT + mi) * 16;
        if (base >= pairs) continue;
        const int c = shift + 8 * ks;
        const int r0 = x_at(base + gid) + c, r1 = x_at(base + gid + 8) + c;
        const float v[4] = {xs[r0], xs[r1], xs[r0 + 4], xs[r1 + 4]};
        uint32_t ah[4], al[4];
        if constexpr (LOW) {
          // JAX's bf16 leaky relu: x * bf16(0.1) rounded to bf16
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ah[e] = __float_as_uint(v[e] >= 0.f ? v[e]
                                                : round_bf16(v[e] * slope));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt >= nlive) continue;
            mma_tf32(acc[mi][nt], ah, bh[nt][0], bh[nt][1]);
          }
        } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float h, l;
          split_tf32(lrelu(v[e], slope), h, l);
          ah[e] = __float_as_uint(h);
          al[e] = __float_as_uint(l);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= nlive) continue;
          mma_tf32(acc[mi][nt], al, bh[nt][0], bh[nt][1]);
          mma_tf32(acc[mi][nt], ah, bl[nt][0], bl[nt][1]);
          mma_tf32(acc[mi][nt], ah, bh[nt][0], bh[nt][1]);
        }
        }
      }
    }
    // db: thread tid adds its piece of channel dyo, MTS / DYT samples
    const float* yd = ys + dyo * LDY + (tid % DYT) * (MTS / DYT);
#pragma unroll
    for (int u = 0; u < MTS / DYT; ++u) db_acc += yd[u];
    __syncthreads();
    issue(i + 2, slot);
  }
  cp_async_wait<0>();
  __syncthreads();

  // C fragment: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1);
  // rows are pairs, columns output channels.  The sample groups add their
  // sums into the OutTile order one after another, in group order.
  float* part = smem;
  for (int g = 0; g < sgn; ++g) {
    if (sg == g && busy) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = (pg * MT + mi) * 16 + gid + 8 * (r >> 1);
          if (p >= pairs) continue;
          const int q = p / ci, il = p - q * ci;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int ol = nt * 8 + 2 * tig + (r & 1);
            float* dst = part + (ol * ci + il) * K + q;
            *dst = g == 0 ? acc[mi][nt][r] : *dst + acc[mi][nt][r];
          }
        }
      }
    }
    __syncthreads();
  }
  // the DYT shares of a channel are neighbouring lanes: a fixed tree
#pragma unroll
  for (int m = DYT / 2; m >= 1; m /= 2)
    db_acc += __shfl_xor_sync(0xffffffffu, db_acc, m);
  if (tid % DYT == 0) part[MO * ci * K + dyo] = db_acc;
  reduce_partials(part, out, dw, db, scratch, Cin, Cout, K, cs, nc);
}

// ------------------------------------------------------------------ host --

// shared memory of a launch (bytes): the stages (and the bf16 route's raw x
// tiles), or the parked partial sums (ops/mrf.py wgrad_plan computes the
// same, and the scratch from the same partial-sum sizes); `low`: the bf16
// instance
size_t smem_bytes(int bn, int bi, int taps, int k, int dil, bool low) {
  size_t stages, part;
  if (bn <= 32) {
    const Window win(MTS, k, dil);
    stages = sizeof(float) * 2 * ((size_t)bn * LDY + (size_t)bi * win.ldx);
    part = (size_t)bn * bi * k + bn;
  } else if (low) {
    const WindowBf16 win(k, dil);
    stages = sizeof(bf16) * (DY_SLOTS * (size_t)bn * TSB +
                             2 * X_SLOTS * (size_t)BM * win.rx);
    part = (size_t)bn / 2 * WG_THREADS + bn;
  } else {
    const Window win(TS, k, dil);
    stages = sizeof(float) * 2 * (2 * (size_t)bn * TS + (size_t)BM * win.ldx);
    part = (size_t)bn / 2 * WG_THREADS + bn + WG_THREADS;
  }
  part *= sizeof(float);
  return stages > part ? stages : part;
}

template <typename E>
using KernelT = void (*)(const E*, const E*, E*, E*, float*, int, int, int,
                         int, int, int, float, int, int, int, int);
typedef KernelT<float> Kernel;
// route 3 takes the tensor maps of dy and x besides
typedef void (*KernelB)(const bf16*, const bf16*, bf16*, bf16*, float*, int,
                        int, int, int, int, int, float, int, int, int, int,
                        CUtensorMap, CUtensorMap);

Kernel kernel_for(int bn) {
  switch (bn) {
    case 16: return wgrad_mma_kernel<8, 2, float>;
    case 32: return wgrad_mma_kernel<4, 4, float>;
    case 64: return wgrad_wgmma_kernel<64>;
    case 128: return wgrad_wgmma_kernel<128>;
    default: return nullptr;
  }
}

// the bf16 instance: route 2 (mma.sync) ...
KernelT<bf16> kernel_for_bf16(int bn) {
  switch (bn) {
    case 16: return wgrad_mma_kernel<8, 2, bf16>;
    case 32: return wgrad_mma_kernel<4, 4, bf16>;
    default: return nullptr;
  }
}

// ... and route 3 (bf16 wgmma)
KernelB kernel_for_bf16_wgmma(int bn) {
  switch (bn) {
    case 64: return wgrad_wgmma_bf16_kernel<64>;
    case 128: return wgrad_wgmma_bf16_kernel<128>;
    default: return nullptr;
  }
}

template <typename E>
KernelT<E> kernel_of(int bn) {
  if constexpr (std::is_same<E, float>::value)
    return kernel_for(bn);
  else
    return kernel_for_bf16(bn);
}

// the route's tile sizes: bn = 16 / 32 (mma.sync, bi in {16, 32} input
// channels and all k taps a tile) or 64 / 128 (wgmma, in fp32 or bf16: bi =
// 64, taps <= its three warpgroups)
bool valid(int bn, int bi, int taps, int k) {
  if (k < 1 || k > MAX_K || k % 2 == 0) return false;
  if (bn <= 32) return (bn == 16 || bn == 32) && (bi == 16 || bi == 32) &&
                       taps == k;
  return kernel_for(bn) != nullptr && bi == BM && taps >= 1 && taps <= NWG;
}

int threads_for(int bn) {
  return bn > 32 ? WG_THREADS : NTH;
}

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
}

// One launch of `kern` on a grid of (cluster * clusters, tiles) blocks, in
// clusters of `cluster` along x, cooperative when clusters > 1 (the
// grid-wide barrier before the cross-cluster sum), with `args`.
template <typename Kern, typename... Args>
cudaError_t launch(Kern kern, int bn, size_t smem, int cluster, int clusters,
                   int tiles, bool cooperative, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * clusters, tiles);
  cfg.blockDim = dim3(threads_for(bn));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  int na = 0;
  if (cluster > 1) {
    attr[na].id = cudaLaunchAttributeClusterDimension;
    attr[na].val.clusterDim.x = cluster;
    attr[na].val.clusterDim.y = 1;
    attr[na].val.clusterDim.z = 1;
    ++na;
  }
  if (cooperative) {
    attr[na].id = cudaLaunchAttributeCooperative;
    attr[na].val.cooperative = 1;
    ++na;
  }
  cfg.attrs = attr;
  cfg.numAttrs = na;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

// The largest n <= `n` for which a cooperative launch of n clusters of
// `cluster` blocks is accepted: the kernel is launched with B = 0 (and
// `extra`, route 3's tensor maps, after the common arguments), so every
// block returns at once, and n is stepped down while the runtime refuses
// the launch as too large (the occupancy query can promise more clusters
// than a cooperative launch takes).  A negative CUDA error code on any
// other error.
template <typename E, typename Kern, typename... Extra>
int accepted_clusters(Kern kern, int bn, size_t smem, int cluster, int n,
                      Extra... extra) {
  for (; n > 0; --n) {
    const cudaError_t e = launch(
        kern, bn, smem, cluster, n, 1, true, (cudaStream_t)0,
        (const E*)nullptr, (const E*)nullptr, (E*)nullptr, (E*)nullptr,
        (float*)nullptr, 0, 1, 1, 1, 1, 1, 0.f, 1, cluster, n, 0, extra...);
    if (e == cudaSuccess) return n;
    (void)cudaGetLastError();
    if (e != cudaErrorCooperativeLaunchTooLarge) return -(int)e;
  }
  return 0;
}

// The most clusters of `cluster` blocks of `kern` that the card holds at
// once (a negative CUDA error code on failure): the occupancy query's
// answer, or with `probe` the largest count of them that a cooperative
// launch accepts (accepted_clusters).
template <typename E, typename Kern, typename... Extra>
int clusters_held(Kern kern, int bn, size_t smem, int cluster, int probe,
                  Extra... extra) {
  if (kern == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return -(int)e;
  if (cluster == 1) {
    int per_sm = 0, dev = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, threads_for(bn), smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return -(int)e;
    return probe ? accepted_clusters<E>(kern, bn, smem, 1, per_sm * sms,
                                        extra...)
                 : per_sm * sms;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads_for(bn));
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)kern, &cfg);
  if (e != cudaSuccess) return -(int)e;
  return probe ? accepted_clusters<E>(kern, bn, smem, cluster, n, extra...)
               : n;
}

// The most clusters of `cluster` blocks of this route that the card holds
// at once.  The planner sizes the grid to the probed count, since a
// cooperative launch must be co-resident.
template <typename E>
int max_clusters(int bn, int bi, int taps, int k, int dil, int cluster,
                 int probe) {
  constexpr bool LOW = !std::is_same<E, float>::value;
  if (!valid(bn, bi, taps, k) || dil < 1 || cluster < 1 || cluster > 8)
    return -(int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(bn, bi, taps, k, dil, LOW);
  if constexpr (LOW) {
    if (bn > 32)
      return clusters_held<E>(kernel_for_bf16_wgmma(bn), bn, smem, cluster,
                              probe, CUtensorMap{}, CUtensorMap{});
  }
  return clusters_held<E>(kernel_of<E>(bn), bn, smem, cluster, probe);
}

// The tensor map of a (B, C, T) bf16 tensor (T % 8 == 0, 16-byte aligned)
// whose box is `rows` channels x `chunks` 8-sample chunks of one batch row,
// laid out [chunk][channel][8 samples] in shared memory: dimensions (8
// samples, C channels T * 2 bytes apart, T / 8 chunks 16 bytes apart, B
// rows C * T * 2 bytes apart).  The box may start before sample 0 or end
// past the last sample or channel: those elements are zero.
cudaError_t tile_map(CUtensorMap* map, const bf16* p, int C, int T, int B,
                     int rows, int chunks) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", (void**)&encode, cudaEnableDefault, &found);
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return e != cudaSuccess ? e : cudaErrorNotSupported;
    }
  }
  const cuuint64_t dims[4] = {8, (cuuint64_t)C, (cuuint64_t)T / 8,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)T * 2, 16,
                                 (cuuint64_t)C * T * 2};
  const cuuint32_t box[4] = {8, (cuuint32_t)rows, (cuuint32_t)chunks, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(p), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// dy: (B, Cout, T), x: (B, Cin, T) -> dw: (Cout, Cin, k), db: (Cout,).
// The plan (ops/mrf.py wgrad_plan): route and tile (bn, bi, taps), the
// B*T split into `clusters` clusters of `cluster` blocks; scratch holds
// clusters x tiles x (bn * bi * taps + bn) floats when clusters > 1.
template <typename E>
int wgrad(const E* dy, const E* x, E* dw, E* db, float* scratch, int B,
          int Cin, int Cout, int T, int k, int dil, float slope, int bn,
          int bi, int taps, int cluster, int clusters, cudaStream_t stream) {
  constexpr bool LOW = !std::is_same<E, float>::value;
  if (!valid(bn, bi, taps, k) || dil < 1 || cluster < 1 || cluster > 8 ||
      clusters < 1 || B < 1 || T < 1 || Cin < 1 || Cout < 1 ||
      (clusters > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(bn, bi, taps, k, dil, LOW);
  int tiles;
  if (bn <= 32)
    tiles = ((Cin + bi - 1) / bi) * ((Cout + bn - 1) / bn);
  else
    tiles = ((Cin + BM - 1) / BM) * ((Cout + bn - 1) / bn) *
            ((k + taps - 1) / taps);
  // 16-byte copies (8-byte loads on route 2 of the bf16 instance, tensor
  // maps on route 3) need aligned rows of T samples
  const int per = LOW && bn > 32 ? 8 : 4;  // samples a copy
  const int vec = T % per == 0 &&
                  reinterpret_cast<uintptr_t>(dy) % (per * sizeof(E)) == 0 &&
                  reinterpret_cast<uintptr_t>(x) % (per * sizeof(E)) == 0;
  cudaError_t e;
  if constexpr (LOW) {
    if (bn > 32) {
      const KernelB kern = kernel_for_bf16_wgmma(bn);
      e = prepare(kern, smem);
      CUtensorMap map_dy = {}, map_x = {};
      if (e == cudaSuccess && vec)
        e = tile_map(&map_dy, dy, Cout, T, B, bn, TSB / 8);
      if (e == cudaSuccess && vec)
        e = tile_map(&map_x, x, Cin, T, B, BM, WindowBf16(k, dil).rx / 8);
      if (e == cudaSuccess)
        e = launch(kern, bn, smem, cluster, clusters, tiles, clusters > 1,
                   stream, dy, x, dw, db, scratch, B, Cin, Cout, T, k, dil,
                   slope, taps, cluster, clusters, vec, map_dy, map_x);
      if (e != cudaSuccess) return (int)e;
      return (int)cudaGetLastError();
    }
  }
  const KernelT<E> kern = kernel_of<E>(bn);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int tile_arg = bn <= 32 ? bi : taps;
  e = launch(kern, bn, smem, cluster, clusters, tiles, clusters > 1, stream,
             dy, x, dw, db, scratch, B, Cin, Cout, T, k, dil, slope,
             tile_arg, cluster, clusters, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ev_mrf_conv_bwd_weight_max_clusters(int bn, int bi, int taps,
                                                   int k, int dil,
                                                   int cluster, int probe) {
  return max_clusters<float>(bn, bi, taps, k, dil, cluster, probe);
}

// the bf16 instance's clusters (route 2: bn 16 or 32; route 3: 64 or 128)
extern "C" int ev_mrf_conv_bwd_weight_max_clusters_bf16(
    int bn, int bi, int taps, int k, int dil, int cluster, int probe) {
  return max_clusters<bf16>(bn, bi, taps, k, dil, cluster, probe);
}

extern "C" int ev_mrf_conv_bwd_weight_f32(const void* dy, const void* x,
                                          void* dw, void* db, void* scratch,
                                          int B, int Cin, int Cout, int T,
                                          int k, int dil, float slope, int bn,
                                          int bi, int taps, int cluster,
                                          int clusters, void* stream) {
  return wgrad<float>((const float*)dy, (const float*)x, (float*)dw,
                      (float*)db, (float*)scratch, B, Cin, Cout, T, k, dil,
                      slope, bn, bi, taps, cluster, clusters,
                      (cudaStream_t)stream);
}

// The bf16 instance: dy, x, dw, db bf16 (scratch fp32), a route-2 plan
// (bn 16 or 32) or a route-3 one (bn 64 or 128); slope = bf16(0.1).
extern "C" int ev_mrf_conv_bwd_weight_bf16(const void* dy, const void* x,
                                           void* dw, void* db, void* scratch,
                                           int B, int Cin, int Cout, int T,
                                           int k, int dil, float slope,
                                           int bn, int bi, int taps,
                                           int cluster, int clusters,
                                           void* stream) {
  return wgrad<bf16>((const bf16*)dy, (const bf16*)x, (bf16*)dw, (bf16*)db,
                     (float*)scratch, B, Cin, Cout, T, k, dil, slope, bn, bi,
                     taps, cluster, clusters, (cudaStream_t)stream);
}
