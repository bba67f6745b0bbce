// The tiled direct 1-D convolution under K3 (mrf_conv.cu) and the data
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
// A block owns CO_TILE output channels x T_TILE samples of one batch row;
// input channels stream through shared memory CI_TILE at a time, each tile
// loaded once with its (k-1)*d halo next to the matching weight slice.  Each
// thread keeps a CO_PER x T_PER register tile of sums (32 outputs), so every
// shared-memory load feeds several FMAs.  The tile shape follows the output
// width: (4, 8) at C >= 64, (2, 16) at C = 32 and (1, 32) at C = 16, so a
// narrow stage still fills the 16 x 16 thread grid.
#pragma once
#include <cuda_runtime.h>

namespace mrf {

constexpr int TX = 16;       // threads along time
constexpr int TY = 16;       // threads along output channels
constexpr int NT = TX * TY;
constexpr int CI_TILE = 8;   // input channels per shared-memory stage

template <int CO_PER, int T_PER, int KT, bool BWD>
__global__ void __launch_bounds__(NT) conv_tile_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ res,
    float* __restrict__ y, int Cin, int Cout, int T, int ksize, int dil,
    float slope) {
  constexpr int CO_TILE = TY * CO_PER;
  constexpr int T_TILE = TX * T_PER;
  const int K = KT > 0 ? KT : ksize;
  const int halo = (K - 1) * dil;
  const int pad = halo / 2;
  const int W = T_TILE + halo;

  const int b = blockIdx.z;
  const int co0 = blockIdx.y * CO_TILE;
  const int t0 = blockIdx.x * T_TILE;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;

  extern __shared__ float smem[];
  float* sx = smem;                // [CI_TILE][W] (activated) input + halo
  float* sw = smem + CI_TILE * W;  // [CI_TILE][K][CO_TILE] weights

  float acc[CO_PER][T_PER];
#pragma unroll
  for (int p = 0; p < CO_PER; ++p)
#pragma unroll
    for (int i = 0; i < T_PER; ++i) acc[p][i] = 0.f;

  const float* xb = x + (long long)b * Cin * T;
  for (int ci0 = 0; ci0 < Cin; ci0 += CI_TILE) {
    for (int idx = tid; idx < CI_TILE * W; idx += NT) {
      const int c = idx / W, u = idx % W;
      const int ci = ci0 + c, t = t0 - pad + u;
      float val = 0.f;
      if (ci < Cin && t >= 0 && t < T) {
        val = xb[(long long)ci * T + t];
        if (!BWD) val = val >= 0.f ? val : val * slope;
      }
      sx[idx] = val;
    }
    for (int idx = tid; idx < CI_TILE * K * CO_TILE; idx += NT) {
      const int co_l = idx % CO_TILE, rest = idx / CO_TILE;
      const int j = rest % K, c = rest / K;
      const int co = co0 + co_l, ci = ci0 + c;
      float wv = 0.f;
      if (co < Cout && ci < Cin)
        wv = BWD ? w[((long long)ci * Cout + co) * K + (K - 1 - j)]
                 : w[((long long)co * Cin + ci) * K + j];
      sw[idx] = wv;
    }
    __syncthreads();

    for (int c = 0; c < CI_TILE; ++c) {
      const float* sxc = sx + c * W + tx;
      const float* swc = sw + c * K * CO_TILE + ty;
      // K is a compile-time constant when KT > 0, so the tap loop unrolls
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float wv[CO_PER], xv[T_PER];
#pragma unroll
        for (int p = 0; p < CO_PER; ++p) wv[p] = swc[j * CO_TILE + TY * p];
#pragma unroll
        for (int i = 0; i < T_PER; ++i) xv[i] = sxc[TX * i + j * dil];
#pragma unroll
        for (int p = 0; p < CO_PER; ++p)
#pragma unroll
          for (int i = 0; i < T_PER; ++i) acc[p][i] = fmaf(wv[p], xv[i], acc[p][i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < CO_PER; ++p) {
    const int co = co0 + ty + TY * p;
    if (co >= Cout) continue;
    const float bv = (!BWD && bias) ? bias[co] : 0.f;
    const long long row = ((long long)b * Cout + co) * T;
#pragma unroll
    for (int i = 0; i < T_PER; ++i) {
      const int t = t0 + tx + TX * i;
      if (t >= T) continue;
      float out;
      if (BWD) {
        out = res[row + t] >= 0.f ? acc[p][i] : acc[p][i] * slope;
      } else {
        out = acc[p][i] + bv;
        if (res) out += res[row + t];
      }
      y[row + t] = out;
    }
  }
}

template <int CO_PER, int T_PER, int KT, bool BWD>
int launch_tile(const float* x, const float* w, const float* bias,
                const float* res, float* y, int B, int Cin, int Cout, int T,
                int k, int dil, float slope, cudaStream_t stream) {
  constexpr int CO_TILE = TY * CO_PER;
  constexpr int T_TILE = TX * T_PER;
  const int W = T_TILE + (k - 1) * dil;
  const size_t smem = sizeof(float) * ((size_t)CI_TILE * W + (size_t)CI_TILE * k * CO_TILE);
  auto kern = conv_tile_kernel<CO_PER, T_PER, KT, BWD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((T + T_TILE - 1) / T_TILE, (Cout + CO_TILE - 1) / CO_TILE, B);
  kern<<<grid, NT, smem, stream>>>(x, w, bias, res, y, Cin, Cout, T, k, dil, slope);
  return (int)cudaGetLastError();
}

template <int CO_PER, int T_PER, bool BWD>
int dispatch_tile_k(const float* x, const float* w, const float* bias,
                    const float* res, float* y, int B, int Cin, int Cout,
                    int T, int k, int dil, float slope, cudaStream_t s) {
  switch (k) {
    case 3: return launch_tile<CO_PER, T_PER, 3, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
    case 7: return launch_tile<CO_PER, T_PER, 7, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
    case 11: return launch_tile<CO_PER, T_PER, 11, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
    default: return launch_tile<CO_PER, T_PER, 0, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
  }
}

// Cin / Cout are the channels of the tensor read and of the tensor written.
template <bool BWD>
int conv_tile(const float* x, const float* w, const float* bias,
              const float* res, float* y, int B, int Cin, int Cout, int T,
              int k, int dil, float slope, cudaStream_t s) {
  if (Cout >= 64) return dispatch_tile_k<4, 8, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
  if (Cout >= 32) return dispatch_tile_k<2, 16, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
  return dispatch_tile_k<1, 32, BWD>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
}

}  // namespace mrf
