// K3's bf16 instance: y = conv1d(leaky_relu(x), w, dilation, same padding)
// + b (+ residual) on (B, C, T) bf16, for the s2 fine-tune under is_half.
//
// Replaces: as K3 (mrf_conv.cu), the forward of the Pallas kernel mrf_stage
// (easevoice_trainer_tpu/ops/fused_mrf.py:125 `_fwd_kernel`, git 42ecfe8)
// as the JAX Generator runs it in bf16 (models/sovits/generator.py:31-44
// with dtype bfloat16: WNConv1d on bf16 activations and weights).
//
// Bound on the H100: 2*C*C*k flops per output sample against 4-6 bytes
// (x, y and the residual in bf16).  Over the 45 s2 shapes (B=8, (C, T) =
// (256, 320) ... (16, 20480), k in {3, 7, 11}, d in {1, 3, 5}) that is
// 100.4 GFLOP, 0.10 ms at 989 TFLOP/s dense bf16, against 0.14 ms of bytes
// at 3.35 TB/s (0.17 ms summing the larger of the two per shape): bytes
// bound it.
//
// Design: the bf16 loop of mrf_conv_tile_bf16.cuh (BWD = false), an
// implicit GEMM on mma.sync.m16n8k16 in bf16 with fp32 accumulators.  What
// held the first bf16 instance back (the fp32 loop with bf16 widened into
// fp32 stages: 2.634 ms over the 45 shapes on an H100 80GB HBM3 at 700 W,
// 1.54x cuDNN's bf16 conv; PERF.md), and what this loop does instead:
// synchronous staging -> cp.async into two or three raw stages; two fp32
// copies of each value in shared memory -> bf16; TF32 m16n8k8 fed by
// scalar loads -> bf16 m16n8k16 fed by ldmatrix.x4; 8 channels a chunk ->
// 16.  The leaky relu is applied, rounded as JAX rounds it, while the x
// tile is transposed to time-major in shared memory; bias and residual are
// added in the epilogue with JAX's roundings.
#include "mrf_conv_tile_bf16.cuh"

// slope: bf16(0.1), the leaky relu's slope as JAX rounds it in bf16
extern "C" int ev_mrf_conv_bf16(const void* x, const void* w,
                                const void* bias, const void* residual,
                                void* y, int B, int Cin, int Cout, int T,
                                int k, int dil, float slope, void* stream) {
  return mrf_bf16::conv_tile<false>(x, w, bias, residual, y, B, Cin, Cout,
                                    T, k, dil, slope, (cudaStream_t)stream);
}
