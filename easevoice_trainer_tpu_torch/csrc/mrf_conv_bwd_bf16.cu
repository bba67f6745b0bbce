// K4's data gradient, bf16 instance: dx = lrelu'(x) * conv_transpose1d(dy,
// w, dilation) on (B, C, T) bf16, for the s2 fine-tune under is_half.
//
// Replaces: as K4-dx (mrf_conv_bwd.cu), the backward of the Pallas kernel
// mrf_stage (easevoice_trainer_tpu/ops/fused_mrf.py `_bwd_kernel`, git
// 42ecfe8) as jax.vjp takes it of the bf16 Generator
// (models/sovits/generator.py:31-44): the transposed conv rounded to bf16,
// then the leaky relu's derivative, da * bf16(0.1) rounded.
//
// Bound on the H100: as K3's bf16 instance (mrf_conv_bf16.cu), bytes at
// dense bf16 rates.  Design: K3's loop with BWD = true and E = bf16
// (mrf_conv_tile.cuh); its own translation unit, compiled beside the fp32
// instances.
#include "mrf_conv_tile.cuh"

// Cin / Cout are the forward conv's: dy and w are (B, Cout, T) and
// (Cout, Cin, k); x and dx are (B, Cin, T); all bf16.  slope: bf16(0.1).
extern "C" int ev_mrf_conv_bwd_data_bf16(const void* dy, const void* x,
                                         const void* w, void* dx, int B,
                                         int Cin, int Cout, int T, int k,
                                         int dil, float slope, void* stream) {
  using ev::bf16;
  return mrf::conv_tile<true, bf16>((const bf16*)dy, (const bf16*)w, nullptr,
                                    (const bf16*)x, (bf16*)dx, B, Cout, Cin,
                                    T, k, dil, slope, (cudaStream_t)stream);
}
