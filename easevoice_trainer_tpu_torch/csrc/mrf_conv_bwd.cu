// K4: the backward of K3 (one MRF ResBlock conv,
//   y = conv1d(leaky_relu(x), w, dilation, same padding) + b (+ residual)),
// on (B, C, T) fp32, T contiguous.  Two entry points:
//
//   ev_mrf_conv_bwd_data_f32    dx[b,i,t] = lrelu'(x[b,i,t])
//                                   * sum_o sum_q w[o,i,q] * dy[b,o,t-q*d+p]
//                               (this file)
//   ev_mrf_conv_bwd_weight_f32  dw[o,i,q] = sum_{b,t} dy[b,o,t]
//                                   * lrelu(x)[b,i,t+q*d-p]   (0 outside [0,T))
//                               db[o]     = sum_{b,t} dy[b,o,t]
//                               (mrf_conv_wgrad.cu)
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
// Weight gradient: a GEMM per tap over a reduction of B*T samples, on the
// tensor cores (wgmma where 64 input and output channels fill its tile,
// mma.sync below), with the B*T sum split per shape and its partial sums
// added in a fixed order inside one launch; see mrf_conv_wgrad.cu.
#include "mrf_conv_tile.cuh"

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
