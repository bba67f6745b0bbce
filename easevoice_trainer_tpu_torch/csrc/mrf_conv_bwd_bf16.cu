// K4's data gradient, bf16 instance: dx = lrelu'(x) * conv_transpose1d(dy,
// w, dilation) on (B, C, T) bf16, for the s2 fine-tune under is_half.
//
// Replaces: as K4-dx (mrf_conv_bwd.cu), the backward of the Pallas kernel
// mrf_stage (easevoice_trainer_tpu/ops/fused_mrf.py:168 `_bwd_kernel`, git
// 42ecfe8) as jax.vjp takes it of the bf16 Generator
// (models/sovits/generator.py:31-44): the transposed conv rounded to bf16,
// then the leaky relu's derivative, da * bf16(0.1) rounded.
//
// Bound on the H100: over the 45 s2 shapes 100.4 GFLOP, 0.10 ms at 989
// TFLOP/s dense bf16, against 0.18 ms to move dy, x and dx in bf16 at 3.35
// TB/s (0.20 ms summing the larger of the two per shape): bytes bound it.
//
// Design: the bf16 loop of mrf_conv_tile_bf16.cuh with BWD = true: dy is
// staged and transposed to time-major as K3 stages x (no activation), the
// weight is transposed and its taps flipped as each chunk is converted in
// shared memory, and the derivative is applied in the epilogue from the
// saved x, read 16 bytes at a time.  Against the first bf16 instance
// (2.472 ms over the 45 shapes on an H100 80GB HBM3 at 700 W, 1.87x
// cuDNN's bf16 dgrad; PERF.md): cp.async
// staging in two or three raw stages in place of synchronous loads, bf16
// in shared memory in place of fp32, bf16 m16n8k16 fed by ldmatrix in
// place of TF32 m16n8k8 fed by scalar loads, 16 channels a chunk in place
// of 8.
#include "mrf_conv_tile_bf16.cuh"

// Cin / Cout are the forward conv's: dy and w are (B, Cout, T) and
// (Cout, Cin, k); x and dx are (B, Cin, T); all bf16.  slope: bf16(0.1).
extern "C" int ev_mrf_conv_bwd_data_bf16(const void* dy, const void* x,
                                         const void* w, void* dx, int B,
                                         int Cin, int Cout, int T, int k,
                                         int dil, float slope, void* stream) {
  return mrf_bf16::conv_tile<true>(dy, w, nullptr, x, dx, B, Cout, Cin, T,
                                   k, dil, slope, (cudaStream_t)stream);
}
