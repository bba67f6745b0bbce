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
// convolution tiled as a small GEMM on the CUDA cores (mrf_conv_tile.cuh,
// shared with K4's data gradient).  The leaky relu is applied as the input
// tile and its halo are loaded; bias and residual are added in the epilogue:
// neither the activated input nor the partial conv reaches device memory.
#include "mrf_conv_tile.cuh"

extern "C" int ev_mrf_conv_f32(const void* x, const void* w, const void* bias,
                               const void* residual, void* y, int B, int Cin,
                               int Cout, int T, int k, int dil, float slope,
                               void* stream) {
  return mrf::conv_tile<false>((const float*)x, (const float*)w,
                               (const float*)bias, (const float*)residual,
                               (float*)y, B, Cin, Cout, T, k, dil, slope,
                               (cudaStream_t)stream);
}
