// Philox4x32-10 and the keep mask of the s1 attention's dropout, which K1
// (prefill_attention.cu, prefill_attention_bf16.cu) draws and K5
// (prefill_attention_bwd.cu, prefill_attention_bwd_bf16.cu) draws again.
// Its twin, bit for bit, is ops/philox.py.
//
// Philox4x32-10 (Salmon, Moraes, Dror and Shaw, "Parallel random numbers:
// as easy as 1, 2, 3", SC 2011; Random123's philox4x32 with 10 rounds): a
// 128-bit counter and a 64-bit key give four 32-bit words through ten
// rounds of two 32 x 32 -> 64-bit products and two three-way xors, the key
// bumped by the Weyl increments before every round but the first.  It
// reproduces Random123's known-answer vectors (tests/test_torch_dropout.py).
//
// The mask, written down once here: the pair (query row, key) of batch row
// b, head h, layer l is kept iff its word is below `thr` =
// floor((1 - p) 2^32), a drop rate within 2^-32 of p.  A key is named by
// its segment (text keys [0, x_len), audio keys [x_len, T)) and its index
// i in it; one Philox call serves the four keys 4 (i / 4) .. + 3 of one
// segment and one row, word i % 4 for key i:
//
//   counter = (i / 4, row, row0 + b, l << 16 | (h0 + h) << 1 | is_audio_key)
//   key     = (seed & 0xffffffff, seed >> 32)
//
// row0 + b is the row in the global batch: a rank of a data-parallel step
// whose rows start at row0 of the global batch passes that row0 (0 outside
// data parallel), so a world of ranks draws the masks one process draws on
// the whole batch.  h0 + h is the head among the layer's heads: a rank of a
// tensor-parallel step holding heads h0 .. passes that h0 (0 otherwise).
//
// So the bit depends on (seed, l, row0 + b, h0 + h, row, key) and the text
// / audio split alone, never on a tile, a warp or the launch.  Every
// kernel's key tiles start at a multiple of 32 keys into their segment, so
// the four keys of a call sit in one tile; the kernels share each call's
// four bits among the lanes that hold those pairs by shuffles.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ev {

// one layer's dropout, as the wrappers pass it (by value, the last kernel
// argument; the instances without dropout take it and never read it)
struct Dropout {
  uint32_t k0, k1;  // the Philox key: the seed's low and high words
  uint32_t thr;     // keep a pair iff its word < thr
  uint32_t layer;   // the layer index, below 2^15
  float inv_keep;   // 1 / (1 - p)
  uint32_t row0;    // the global batch row of the launch's batch row 0
  uint32_t h0;      // the layer's head of the launch's head 0
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Keep bits of one Philox call: bit j for key 4 * group + j of the segment
// (audio or text), query `row`, the launch's batch row b (global row
// d.row0 + b), its head h (the layer's head d.h0 + h)
__device__ __forceinline__ uint32_t keep4(const Dropout& d, int b, int h,
                                          int row, int group, bool audio) {
  const uint4 w = philox4x32_10(
      make_uint4((uint32_t)group, (uint32_t)row, d.row0 + (uint32_t)b,
                 d.layer << 16 | (d.h0 + (uint32_t)h) << 1 |
                     (audio ? 1u : 0u)),
      d.k0, d.k1);
  return (uint32_t)(w.x < d.thr) | (uint32_t)(w.y < d.thr) << 1 |
         (uint32_t)(w.z < d.thr) << 2 | (uint32_t)(w.w < d.thr) << 3;
}

// The keep bits of an m16n8 accumulator tile whose element e is row
// rows[e >> 1], key 2t + (e & 1) of its 8 keys (K1, K5's dq): lanes t and
// t ^ 1 share the Philox call of keys 4 (t / 2) .. + 3; the even lane
// draws row rows[0]'s bits and the odd one rows[1]'s, and they trade.
// `group` is the call of the tile's first four keys, counted in their
// segment.  Bit e of the result is element e's.
__device__ __forceinline__ uint32_t keep_rows(const Dropout& d, int b, int h,
                                              const int (&rows)[2], int group,
                                              bool audio, int t) {
  const int odd = t & 1;
  const uint32_t own = keep4(d, b, h, rows[odd], group + (t >> 1), audio);
  const uint32_t other = __shfl_xor_sync(0xffffffffu, own, 1);
  const uint32_t top = odd ? other : own, bottom = odd ? own : other;
  return (top >> 2 * odd & 3u) | (bottom >> 2 * odd & 3u) << 2;
}

// The keep bits of an m16n8 tile transposed (K5's dkdv): element e is key
// kw + g + 8 (e >> 1), query q0 + 2t + (e & 1), the warp's 16 keys starting
// at index 4 * group of their segment.  Lane (g, t) draws query
// q0 + 2t + (g & 1) for keys 4 (group + g / 2) .. + 3 and each lane gathers
// its four bits from the lanes that drew them.  Bit e of the result is
// element e's.
__device__ __forceinline__ uint32_t keep_cols(const Dropout& d, int b, int h,
                                              int q0, int group, bool audio,
                                              int g, int t) {
  const uint32_t own =
      keep4(d, b, h, q0 + 2 * t + (g & 1), group + (g >> 1), audio);
  uint32_t bits = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int src = 4 * (2 * (g >> 2) + 4 * (e >> 1) + (e & 1)) + t;
    bits |= (__shfl_sync(0xffffffffu, own, src) >> (g & 3) & 1u) << e;
  }
  return bits;
}

}  // namespace ev
