// K2: single-token decode attention over one layer's KV cache, with the
// cache write of the new token and the cache-validity test inside.
//
// Replaces: no Pallas kernel; it carries the per-layer attention of
// Text2SemanticDecoder.decode_step (easevoice_trainer_tpu/models/gpt/
// t2s.py:133-152 attention_step, :338-378): the dynamic_update_slice of the
// new K/V at `pos`, then attention over the cache under the kv_bias of the
// decode loop (easevoice_trainer_tpu/models/gpt/decode.py:141-156).
//
// Bound on the H100: the bytes of the cache.  Each (b, h) reads 2 * 32 * 4
// bytes per valid slot and does 128 flops on them, far below the card's
// flop/byte balance, and in the decode loop every layer's cache comes cold
// from HBM (24 layers' caches are far beyond the 50 MB L2).  Design
// (flash-decoding):
//
// - The valid slots of one (b, h) are split over a thread-block cluster of
//   `split` blocks (at most 8, the portable cluster size).  The split is
//   chosen from cache_len alone, so a whole decode launches one shape.  Each
//   block keeps its own softmax state (m, l, acc[32]) and stores it into
//   the cluster's first block's shared memory (distributed shared memory,
//   stores only, so no block waits on a remote load), which merges the
//   states in rank order: one launch, no atomics, results that repeat bit
//   for bit.
// - Coalesced reads: 8 lanes share one slot, each loading 16 bytes, so one
//   warp instruction reads 4 whole 128-byte rows; the dot product is summed
//   by 3 shuffles inside the 8-lane group.  Each lane issues the K and V
//   loads of UNROLL slots before it uses any (streaming loads: the cache is
//   read once a step).  128 threads at 56 registers keep the 512 blocks of
//   the serving shape in one wave; 256 threads, or UNROLL 8 or 16, cost
//   more in registers or waves than they gain in bytes in flight (measured
//   on an H100, one layout against the other on the same inputs).
// - Only valid slots are read: [0, x_lens[b]) of the text and [x_len, pos)
//   of prompt + generated tokens; the text pads in the middle of the cache
//   (slots x_lens[b] .. x_len-1) are skipped, so the plain version's
//   (B, 1, 1, cache_len) bias is never built.
// - The new token's q, k and v are read through their strides from the
//   fused qkv projection by the first block's first warp, loaded at the
//   start and used after the main loop, which also writes k and v into slot
//   `pos`; no block reads slot `pos` from the cache: the first block adds
//   the new token's term from the values it has in registers.
//
// Layout: q, k, v are (B, 1, H, 32) fp32 views (head stride 32, unit
// stride in dk, batch strides passed in, multiples of 4 floats, 16-byte
// aligned); the caches are (B, cache_len, H, 32) contiguous (one layer of
// the (L, B, cache_len, H, dk) stack); o is (B, 1, H, 32) contiguous.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

namespace cg = cooperative_groups;

constexpr int DK = 32;
constexpr int NTHREADS = 128;
constexpr int LPS = 8;                // lanes per slot: 8 x 16 B = one row
constexpr int NG = NTHREADS / LPS;    // slot groups per block
constexpr int UNROLL = 4;             // slots in flight per group
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

constexpr int MAX_SPLIT = 8;           // the portable cluster size

// a block's merged softmax state: m, l, acc[32] (m in log2 units)
struct State {
  float m, l, acc[DK];
};

// the two halves of a cluster barrier: arrive (release, or relaxed when it
// only marks that the block runs) and wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(NTHREADS) decode_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ kn,
    const float* __restrict__ vn, float* kc, float* vc, float* __restrict__ o,
    const int* __restrict__ x_lens, long long q_sb, long long k_sb,
    long long v_sb, int H, int cache_len, int x_len, int pos, float scale,
    int split) {
  const int rank = blockIdx.x;  // the block's rank in its cluster
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int grp = tid / LPS, j = tid % LPS;  // lane j holds dims 4j..4j+3
  const float c = scale * LOG2E;
  // a block may store into another's shared memory only once that block
  // runs: this arrival is waited for before the stores
  if (split > 1) cluster_arrive_relaxed();

  // the new token's q, k and v, in the first block's first warp (lane d
  // holds dim d): loaded here, used after the main loop
  const long long row = (long long)H * DK;  // floats between slots
  const bool owner = rank == 0 && tid < DK;
  float qd = 0.f, kd = 0.f, vd = 0.f;
  if (owner) {
    qd = q[b * q_sb + h * DK + tid];
    kd = kn[b * k_sb + h * DK + tid];
    vd = vn[b * v_sb + h * DK + tid];
  }

  const int n_text = min(max(x_lens[b], 0), x_len);
  const int n_old = n_text + (pos - x_len);  // valid slots before pos
  const int begin = (int)((long long)rank * n_old / split);
  const int end = (int)((long long)(rank + 1) * n_old / split);

  float4 q4 = *reinterpret_cast<const float4*>(q + b * q_sb + h * DK + 4 * j);
  q4.x *= c; q4.y *= c; q4.z *= c; q4.w *= c;

  const float* kbase = kc + (long long)b * cache_len * row + h * DK + 4 * j;
  const float* vbase = vc + (long long)b * cache_len * row + h * DK + 4 * j;
  float m = -INFINITY, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // the trip count is the same for the whole block, so every lane of a
  // warp reaches the shuffles
  for (int i0 = begin; i0 < end; i0 += NG * UNROLL) {
    float4 kr[UNROLL], vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * NG + grp;
      if (i < end) {
        const int s = i < n_text ? i : x_len + (i - n_text);
        kr[u] = __ldcs(reinterpret_cast<const float4*>(kbase + s * row));
        vr[u] = __ldcs(reinterpret_cast<const float4*>(vbase + s * row));
      } else {
        kr[u] = vr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    float sc[UNROLL];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float d = dot4(q4, kr[u]);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      sc[u] = i0 + u * NG + grp < end ? d : -INFINITY;
      mx = fmaxf(mx, sc[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m - base);
    l *= alpha;
    acc.x *= alpha; acc.y *= alpha; acc.z *= alpha; acc.w *= alpha;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float p = exp2f(sc[u] - base);
      l += p;
      acc.x = fmaf(p, vr[u].x, acc.x);
      acc.y = fmaf(p, vr[u].y, acc.y);
      acc.z = fmaf(p, vr[u].z, acc.z);
      acc.w = fmaf(p, vr[u].w, acc.w);
    }
    m = m_new;
  }

  // the new token's row into slot pos, and its score
  float sn = 0.f;
  if (owner) {
    const long long dst = ((long long)b * cache_len + pos) * row + h * DK + tid;
    kc[dst] = kd;
    vc[dst] = vd;
    sn = qd * c * kd;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sn += __shfl_xor_sync(0xffffffffu, sn, off);
  }

  // merge the 4 groups of a warp by shuffles (lanes 0-7 end with the
  // warp's state), then the warps in order through shared memory: warp 0,
  // lane d owns dim d
#pragma unroll
  for (int off = LPS; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    float4 ao;
    ao.x = __shfl_xor_sync(0xffffffffu, acc.x, off);
    ao.y = __shfl_xor_sync(0xffffffffu, acc.y, off);
    ao.z = __shfl_xor_sync(0xffffffffu, acc.z, off);
    ao.w = __shfl_xor_sync(0xffffffffu, acc.w, off);
    const float mn = fmaxf(m, mo);
    const float base = mn == -INFINITY ? 0.f : mn;
    const float f = exp2f(m - base), fo = exp2f(mo - base);
    l = fmaf(l, f, lo * fo);
    acc.x = fmaf(acc.x, f, ao.x * fo);
    acc.y = fmaf(acc.y, f, ao.y * fo);
    acc.z = fmaf(acc.z, f, ao.z * fo);
    acc.w = fmaf(acc.w, f, ao.w * fo);
    m = mn;
  }
  constexpr int NW = NTHREADS / 32;
  __shared__ float s_m[NW], s_l[NW];
  __shared__ __align__(16) float s_acc[NW][DK];
  __shared__ State states[MAX_SPLIT];  // filled in the first block only
  const int warp = tid / 32;
  if (tid % 32 < LPS) {
    if (j == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
    *reinterpret_cast<float4*>(&s_acc[warp][4 * j]) = acc;
  }
  __syncthreads();
  float mb = -INFINITY, lb = 0.f, ab = 0.f;
  if (tid < DK) {
#pragma unroll
    for (int w = 0; w < NW; ++w) mb = fmaxf(mb, s_m[w]);
    const float base = mb == -INFINITY ? 0.f : mb;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = exp2f(s_m[w] - base);
      lb = fmaf(s_l[w], f, lb);
      ab = fmaf(s_acc[w][tid], f, ab);
    }
  }

  // every block's state into the first block's shared memory
  if (split > 1) cluster_wait();  // every block of the cluster runs
  if (tid < DK) {
    State* st = split > 1
                    ? cg::this_cluster().map_shared_rank(&states[rank], 0)
                    : &states[0];
    st->acc[tid] = ab;
    if (tid == 0) {
      st->m = mb;
      st->l = lb;
    }
  }
  if (split > 1) {
    cluster_arrive();  // the stores are visible to the first block
    cluster_wait();
    if (rank > 0) return;
  } else {
    __syncthreads();
  }

  // the first block: the cluster's states in rank order, then the new token
  if (owner) {
    float mc = -INFINITY;
    for (int r = 0; r < split; ++r) mc = fmaxf(mc, states[r].m);
    const float base = mc == -INFINITY ? 0.f : mc;
    float lc = 0.f, ac = 0.f;
    for (int r = 0; r < split; ++r) {
      const float f = exp2f(states[r].m - base);
      lc = fmaf(states[r].l, f, lc);
      ac = fmaf(states[r].acc[tid], f, ac);
    }
    const float mt = fmaxf(mc, sn);
    const float fb = exp2f(mc - mt), fn = exp2f(sn - mt);
    const float lt = fmaf(lc, fb, fn);
    o[((long long)b * H + h) * DK + tid] = fmaf(ac, fb, vd * fn) / lt;
  }
}

// blocks per (b, h): one per 128 cache slots, at most MAX_SPLIT; a
// function of cache_len only
int split_for(int cache_len) {
  const int s = cache_len / 128;
  return s < 1 ? 1 : (s > MAX_SPLIT ? MAX_SPLIT : s);
}

}  // namespace

extern "C" int ev_decode_attention_f32(
    const void* q, const void* k, const void* v, void* k_cache, void* v_cache,
    void* o, const void* x_lens, long long q_sb, long long k_sb,
    long long v_sb, int B, int H, int cache_len, int x_len, int pos,
    float scale, void* stream) {
  if (pos < x_len || pos >= cache_len) return (int)cudaErrorInvalidValue;
  const int split = split_for(cache_len);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, H, B);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_attention_kernel, (const float*)q, (const float*)k,
      (const float*)v, (float*)k_cache, (float*)v_cache, (float*)o,
      (const int*)x_lens, q_sb, k_sb, v_sb, H, cache_len, x_len, pos, scale,
      split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
