// K3's bf16 instance: y = conv1d(leaky_relu(x), w, dilation, same padding)
// + b (+ residual) on (B, C, T) bf16, for the s2 fine-tune under is_half.
//
// Replaces: as K3 (mrf_conv.cu), the forward of the Pallas kernel mrf_stage
// (easevoice_trainer_tpu/ops/fused_mrf.py `_fwd_kernel`, git 42ecfe8) as the
// JAX Generator runs it in bf16 (models/sovits/generator.py:31-44 with
// dtype bfloat16: WNConv1d on bf16 activations and weights).
//
// Bound on the H100: the same 2*C*C*k flops per output sample, now against
// half the bytes; at dense bf16 tensor-core rates (989 TFLOP/s) the 45 s2
// shapes' 100 GFLOP take 0.10 ms and their bytes ~0.2 ms, so bytes bound
// it.  Design: K3's loop with E = bf16 (mrf_conv_tile.cuh, its note on the
// bf16 instances): bf16 widened into the fp32 stages, one TF32 product a
// tap, JAX's bf16 roundings in the epilogue.  Built in its own translation
// unit so that it compiles beside the fp32 instances.
#include "mrf_conv_tile.cuh"

// slope: bf16(0.1), the leaky relu's slope as JAX rounds it in bf16
extern "C" int ev_mrf_conv_bf16(const void* x, const void* w,
                                const void* bias, const void* residual,
                                void* y, int B, int Cin, int Cout, int T,
                                int k, int dil, float slope, void* stream) {
  using ev::bf16;
  return mrf::conv_tile<false, bf16>((const bf16*)x, (const bf16*)w,
                                     (const bf16*)bias,
                                     (const bf16*)residual, (bf16*)y, B, Cin,
                                     Cout, T, k, dil, slope,
                                     (cudaStream_t)stream);
}
