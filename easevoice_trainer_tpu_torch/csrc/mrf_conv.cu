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
// Bound on the H100 (132 SMs; 67 TFLOP/s fp32 on the CUDA cores, 495
// TFLOP/s dense TF32 on the tensor cores, 3.35 TB/s): 2*C*C*k flops per
// output sample against 8-12 bytes, so flops at C >= 64.  Over the 45
// serving shapes chip_smoke times (B=4, 512 frames, (C, T) = (256, 5120) ...
// (16, 327680), k in {3, 7, 11}, d in {1, 3, 5}) that is
// sum 2*B*T*C*C*k = 803.3 GFLOP: 12.0 ms on the fp32 CUDA cores, 4.87 ms in
// 3xTF32 (3 * 803.3 / 495), and 2.24 ms to move x, y and the residual
// (7.51 GB).  TF32 alone keeps ~10 mantissa bits, short of the port's fp32
// tolerance of 1e-4 relative; 3xTF32 keeps fp32-level error for 3x the
// TF32 work.
//
// Design (mrf_conv_tile.cuh, shared with K4's data gradient): an implicit
// GEMM on the tensor cores in 3xTF32, M = Cout, N = time, reduction = Cin x
// taps, with the x tile and its halo staged once per 8 input channels by
// cp.async and reused by every tap.  The earlier loop was a SIMT direct
// convolution (FFMA register tiles, 8 channels staged by plain loads between
// two barriers): the tensor cores sat idle, no load overlapped the math, and
// each x element was read from shared memory once per (tap, row) pair; it
// ran at 19.0 TFLOP/s, 12 % of the 3xTF32 bound (PERF.md; NVIDIA H100
// 80GB HBM3, 700 W).  The leaky relu is applied as a staged tile is split
// into TF32 halves; bias and residual are added in the epilogue: neither
// the activated input nor the partial conv reaches device memory.  The result no longer agrees with cuDNN's
// fp32 conv bit for bit: the tensor cores accumulate in another order and
// more coarsely than an FFMA chain, and the lo*lo term is dropped (up to
// ~2e-5 relative at C=256, k=11; the tolerance is 1e-4).
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
