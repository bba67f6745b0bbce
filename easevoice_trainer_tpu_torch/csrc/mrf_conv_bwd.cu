// K4: the backward of K3 (one MRF ResBlock conv,
//   y = conv1d(leaky_relu(x), w, dilation, same padding) + b (+ residual)),
// on (B, C, T) fp32, T contiguous.  Two entry points:
//
//   ev_mrf_conv_bwd_data_f32    dx[b,i,t] = lrelu'(x[b,i,t])
//                                   * sum_o sum_q w[o,i,q] * dy[b,o,t-q*d+p]
//   ev_mrf_conv_bwd_weight_f32  dw[o,i,q] = sum_{b,t} dy[b,o,t]
//                                   * lrelu(x)[b,i,t+q*d-p]   (0 outside [0,T))
//                               db[o]     = sum_{b,t} dy[b,o,t]
//
// (the residual's gradient is dy itself and needs no kernel).
//
// Replaces: the backward of the Pallas kernel mrf_stage
// (easevoice_trainer_tpu/ops/fused_mrf.py `_bwd_kernel`, git 42ecfe8), which
// recomputed a whole stage from x in VMEM and gave dx, dW summed over the
// batch and db.  As for K3, the port keeps one launch per conv: a whole stage
// does not fit 227 KB of shared memory at C=256.
//
// Bound on the H100: both are flop-bound at C >= 64 (2*C*C*k flops per
// sample), bytes-bound at C <= 32.  Over the 45 s2 shapes chip_smoke times
// (B=8, (C, T) = (256, 320) ... (16, 20480), k in {3, 7, 11}, d in
// {1, 3, 5}) each entry point does 100.4 GFLOP: 1.50 ms on the fp32 CUDA
// cores (67 TFLOP/s), 0.61 ms in 3xTF32 on the tensor cores (3 * 100.4 /
// 495 TFLOP/s); dx's 1.23 GB of dy, x and dx take 0.37 ms to move.
//
// Data gradient: K3's loop (mrf_conv_tile.cuh, BWD = true), the 3xTF32
// implicit GEMM on the tensor cores, run over dy with the weight transposed
// and flipped as it is staged in shared memory; the lrelu derivative is
// applied in the epilogue from the saved pre-activation x, so neither
// lrelu'(x) nor the transposed weight reaches device memory.  It replaced a
// SIMT direct convolution that ran at 14.6 TFLOP/s, 9 % of the 3xTF32 bound
// (PERF.md; NVIDIA H100 80GB HBM3, 700 W).
//
// Weight gradient: a GEMM of M = Cout by N = Cin*k over a reduction of B*T
// terms (up to 8 * 20480 in the s2 step).  A block owns 16*CO_PER output
// channels x 16 input channels x all k taps (k sums per output pair in
// registers, so each shared-memory load of an activation feeds CO_PER FMAs)
// and one chunk of `tch` samples of one batch row, staged 64 samples at a
// time: dy as [t][o] and lrelu(x) with its (k-1)*d halo as [t][i] (rows
// padded by one word so the transposing stores do not collide in a bank).
// Each block writes its partial sums to a scratch buffer; a second kernel
// adds the chunks in a fixed order.  No float atomics, so the result repeats
// bit for bit between runs.  db comes from the blocks of the first input-
// channel tile, in the same pass.
#include "mrf_conv_tile.cuh"

namespace {

constexpr int TX = 16;      // threads along input channels
constexpr int TY = 16;      // threads along output channels
constexpr int NT = TX * TY;

constexpr int TS = 64;      // samples per shared-memory stage
constexpr int MAX_K = 16;   // taps of the generic (KT = 0) instance

template <int CO_PER, int KT>
__global__ void __launch_bounds__(NT) wgrad_partial_kernel(
    const float* __restrict__ dy, const float* __restrict__ x,
    float* __restrict__ part_w, float* __restrict__ part_b, int Cin,
    int Cout, int T, int ksize, int dil, float slope, int tch,
    int chunks_per_row) {
  constexpr int CO_TILE = TY * CO_PER;
  constexpr int SDY = CO_TILE + 1;  // padded row of the [t][o] dy stage
  constexpr int SA = TX + 1;        // padded row of the [t][i] lrelu(x) stage
  constexpr int KA = KT > 0 ? KT : MAX_K;
  const int K = KT > 0 ? KT : ksize;
  const int halo = (K - 1) * dil;
  const int pad = halo / 2;
  const int W = TS + halo;

  const int chunk = blockIdx.x;
  const int b = chunk / chunks_per_row;
  const int t_begin = (chunk % chunks_per_row) * tch;
  const int t_end = min(T, t_begin + tch);
  const int co0 = blockIdx.y * CO_TILE;
  const int ci0 = blockIdx.z * TX;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;

  extern __shared__ float smem[];
  float* sdy = smem;            // [TS][SDY]
  float* sa = smem + TS * SDY;  // [W][SA]

  float acc[CO_PER][KA];
  float bacc[CO_PER];
#pragma unroll
  for (int p = 0; p < CO_PER; ++p) {
    bacc[p] = 0.f;
#pragma unroll
    for (int j = 0; j < KA; ++j) acc[p][j] = 0.f;
  }

  const float* dyb = dy + (long long)b * Cout * T;
  const float* xb = x + (long long)b * Cin * T;
  for (int s0 = t_begin; s0 < t_end; s0 += TS) {
    const int n = min(TS, t_end - s0);
    for (int idx = tid; idx < CO_TILE * TS; idx += NT) {
      const int o = idx / TS, u = idx % TS;
      const int co = co0 + o;
      sdy[u * SDY + o] = (co < Cout && u < n) ? dyb[(long long)co * T + s0 + u] : 0.f;
    }
    for (int idx = tid; idx < TX * W; idx += NT) {
      const int i = idx / W, v = idx % W;
      const int ci = ci0 + i, t = s0 - pad + v;
      float val = 0.f;
      if (ci < Cin && t >= 0 && t < T) {
        val = xb[(long long)ci * T + t];
        val = val >= 0.f ? val : val * slope;
      }
      sa[v * SA + i] = val;
    }
    __syncthreads();

    for (int u = 0; u < n; ++u) {
      float dv[CO_PER];
#pragma unroll
      for (int p = 0; p < CO_PER; ++p) {
        dv[p] = sdy[u * SDY + ty + TY * p];
        bacc[p] += dv[p];
      }
      const float* sau = sa + u * SA + tx;
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        if (KT == 0 && j >= K) break;
        const float av = sau[j * dil * SA];
#pragma unroll
        for (int p = 0; p < CO_PER; ++p) acc[p][j] = fmaf(dv[p], av, acc[p][j]);
      }
    }
    __syncthreads();
  }

  const int ci = ci0 + tx;
#pragma unroll
  for (int p = 0; p < CO_PER; ++p) {
    const int co = co0 + ty + TY * p;
    if (co >= Cout) continue;
    if (ci < Cin) {
      float* dst = part_w + (((long long)chunk * Cout + co) * Cin + ci) * K;
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        if (j >= K) break;
        dst[j] = acc[p][j];
      }
    }
    if (blockIdx.z == 0 && tx == 0) part_b[(long long)chunk * Cout + co] = bacc[p];
  }
}

// out[j] = sum over chunks c = 0, 1, ... of part[c * n + j], in that order
__global__ void reduce_chunks_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int n_chunks,
                                     long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += part[(long long)c * n + j];
  out[j] = s;
}

template <int CO_PER, int KT>
int launch_wgrad(const float* dy, const float* x, float* part_w,
                 float* part_b, int B, int Cin, int Cout, int T, int k,
                 int dil, float slope, int tch, cudaStream_t stream) {
  constexpr int CO_TILE = TY * CO_PER;
  const int chunks_per_row = (T + tch - 1) / tch;
  const size_t smem = sizeof(float) * ((size_t)TS * (CO_TILE + 1) +
                                       (size_t)(TS + (k - 1) * dil) * (TX + 1));
  auto kern = wgrad_partial_kernel<CO_PER, KT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * chunks_per_row, (Cout + CO_TILE - 1) / CO_TILE, (Cin + TX - 1) / TX);
  kern<<<grid, NT, smem, stream>>>(dy, x, part_w, part_b, Cin, Cout, T, k, dil,
                                   slope, tch, chunks_per_row);
  return (int)cudaGetLastError();
}

template <int CO_PER>
int dispatch_wgrad_k(const float* dy, const float* x, float* part_w,
                     float* part_b, int B, int Cin, int Cout, int T, int k,
                     int dil, float slope, int tch, cudaStream_t s) {
  switch (k) {
    case 3: return launch_wgrad<CO_PER, 3>(dy, x, part_w, part_b, B, Cin, Cout, T, k, dil, slope, tch, s);
    case 7: return launch_wgrad<CO_PER, 7>(dy, x, part_w, part_b, B, Cin, Cout, T, k, dil, slope, tch, s);
    case 11: return launch_wgrad<CO_PER, 11>(dy, x, part_w, part_b, B, Cin, Cout, T, k, dil, slope, tch, s);
    default: return launch_wgrad<CO_PER, 0>(dy, x, part_w, part_b, B, Cin, Cout, T, k, dil, slope, tch, s);
  }
}

int reduce_chunks(const float* part, float* out, int n_chunks, long long n,
                  cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  reduce_chunks_kernel<<<blocks, threads, 0, s>>>(part, out, n_chunks, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Cin / Cout are the forward conv's: dy and w are (B, Cout, T) and
// (Cout, Cin, k); x and dx are (B, Cin, T).
extern "C" int ev_mrf_conv_bwd_data_f32(const void* dy, const void* x,
                                        const void* w, void* dx, int B,
                                        int Cin, int Cout, int T, int k,
                                        int dil, float slope, void* stream) {
  return mrf::conv_tile<true>((const float*)dy, (const float*)w, nullptr,
                              (const float*)x, (float*)dx, B, Cout, Cin, T, k,
                              dil, slope, (cudaStream_t)stream);
}

// part_w holds B*ceil(T/tch) * Cout*Cin*k floats and part_b B*ceil(T/tch) *
// Cout: the per-chunk partial sums, reduced into dw (Cout, Cin, k) and db.
extern "C" int ev_mrf_conv_bwd_weight_f32(const void* dy, const void* x,
                                          void* dw, void* db, void* part_w,
                                          void* part_b, int B, int Cin,
                                          int Cout, int T, int k, int dil,
                                          float slope, int tch, void* stream) {
  if (k > MAX_K || tch <= 0) return (int)cudaErrorInvalidValue;
  const float* dyp = (const float*)dy;
  const float* xp = (const float*)x;
  float* pw = (float*)part_w;
  float* pb = (float*)part_b;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (Cout >= 64) rc = dispatch_wgrad_k<4>(dyp, xp, pw, pb, B, Cin, Cout, T, k, dil, slope, tch, s);
  else if (Cout >= 32) rc = dispatch_wgrad_k<2>(dyp, xp, pw, pb, B, Cin, Cout, T, k, dil, slope, tch, s);
  else rc = dispatch_wgrad_k<1>(dyp, xp, pw, pb, B, Cin, Cout, T, k, dil, slope, tch, s);
  if (rc != 0) return rc;
  const int n_chunks = B * ((T + tch - 1) / tch);
  rc = reduce_chunks(pw, (float*)dw, n_chunks, (long long)Cout * Cin * k, s);
  if (rc != 0) return rc;
  return reduce_chunks(pb, (float*)db, n_chunks, (long long)Cout, s);
}
