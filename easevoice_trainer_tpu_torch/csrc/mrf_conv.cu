// K3: one conv of a HiFi-GAN MRF ResBlock,
//   y = conv1d(leaky_relu(x, slope), w, dilation, same padding) + b (+ residual)
// on (B, C, T) fp32, T contiguous.
//
// Replaces: the forward of the Pallas kernel mrf_stage
// (easevoice_trainer_tpu/ops/fused_mrf.py `_fwd_kernel`, git 42ecfe8), i.e.
// the lrelu -> weight-normed dilated conv -> residual chain of ResBlock1 /
// ResBlock2 (easevoice_trainer_tpu/models/sovits/generator.py:22-69).  Each
// dilation step of ResBlock1 is two launches: t = K3(x, w1, d) and
// x = K3(t, w2, 1, residual=x).
//
// Bound on the H100: flops at C >= 128 (2*C*C*k flops per output sample
// against 8 bytes of input and output), bytes at C <= 32.  Design: a direct
// convolution tiled as a small GEMM on the CUDA cores.  A block owns
// CO_TILE output channels x T_TILE samples of one batch row; input channels
// stream through shared memory 8 at a time, each tile loaded once with its
// (k-1)*d halo and the leaky-relu applied on the way in, next to the
// matching weight slice.  Each thread keeps a CO_PER x T_PER register tile of
// sums (32 outputs), so every shared-memory load feeds several FMAs.  Bias
// and residual are added in the epilogue: neither the activated input nor
// the partial conv reaches device memory.  The tile shape follows C: (4, 8)
// at C >= 64, (2, 16) at C = 32 and (1, 32) at C = 16, so a narrow stage
// still fills the 16 x 16 thread grid.
#include <cuda_runtime.h>

namespace {

constexpr int TX = 16;       // threads along time
constexpr int TY = 16;       // threads along output channels
constexpr int NT = TX * TY;
constexpr int CI_TILE = 8;   // input channels per shared-memory stage

template <int CO_PER, int T_PER, int KT>
__global__ void __launch_bounds__(NT) mrf_conv_kernel(
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
  float* sx = smem;                // [CI_TILE][W] activated input + halo
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
        val = val >= 0.f ? val : val * slope;
      }
      sx[idx] = val;
    }
    for (int idx = tid; idx < CI_TILE * K * CO_TILE; idx += NT) {
      const int co_l = idx % CO_TILE, rest = idx / CO_TILE;
      const int j = rest % K, c = rest / K;
      const int co = co0 + co_l, ci = ci0 + c;
      sw[idx] = (co < Cout && ci < Cin) ? w[((long long)co * Cin + ci) * K + j] : 0.f;
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
    const float bv = bias ? bias[co] : 0.f;
    const long long row = ((long long)b * Cout + co) * T;
#pragma unroll
    for (int i = 0; i < T_PER; ++i) {
      const int t = t0 + tx + TX * i;
      if (t >= T) continue;
      float out = acc[p][i] + bv;
      if (res) out += res[row + t];
      y[row + t] = out;
    }
  }
}

template <int CO_PER, int T_PER, int KT>
int launch(const float* x, const float* w, const float* bias, const float* res,
           float* y, int B, int Cin, int Cout, int T, int k, int dil,
           float slope, cudaStream_t stream) {
  constexpr int CO_TILE = TY * CO_PER;
  constexpr int T_TILE = TX * T_PER;
  const int W = T_TILE + (k - 1) * dil;
  const size_t smem = sizeof(float) * ((size_t)CI_TILE * W + (size_t)CI_TILE * k * CO_TILE);
  auto kern = mrf_conv_kernel<CO_PER, T_PER, KT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((T + T_TILE - 1) / T_TILE, (Cout + CO_TILE - 1) / CO_TILE, B);
  kern<<<grid, NT, smem, stream>>>(x, w, bias, res, y, Cin, Cout, T, k, dil, slope);
  return (int)cudaGetLastError();
}

template <int CO_PER, int T_PER>
int dispatch_k(const float* x, const float* w, const float* bias,
               const float* res, float* y, int B, int Cin, int Cout, int T,
               int k, int dil, float slope, cudaStream_t s) {
  switch (k) {
    case 3: return launch<CO_PER, T_PER, 3>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
    case 7: return launch<CO_PER, T_PER, 7>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
    case 11: return launch<CO_PER, T_PER, 11>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
    default: return launch<CO_PER, T_PER, 0>(x, w, bias, res, y, B, Cin, Cout, T, k, dil, slope, s);
  }
}

}  // namespace

extern "C" int ev_mrf_conv_f32(const void* x, const void* w, const void* bias,
                               const void* residual, void* y, int B, int Cin,
                               int Cout, int T, int k, int dil, float slope,
                               void* stream) {
  const float* xp = (const float*)x;
  const float* wp = (const float*)w;
  const float* bp = (const float*)bias;
  const float* rp = (const float*)residual;
  float* yp = (float*)y;
  cudaStream_t s = (cudaStream_t)stream;
  if (Cout >= 64) return dispatch_k<4, 8>(xp, wp, bp, rp, yp, B, Cin, Cout, T, k, dil, slope, s);
  if (Cout >= 32) return dispatch_k<2, 16>(xp, wp, bp, rp, yp, B, Cin, Cout, T, k, dil, slope, s);
  return dispatch_k<1, 32>(xp, wp, bp, rp, yp, B, Cin, Cout, T, k, dil, slope, s);
}
