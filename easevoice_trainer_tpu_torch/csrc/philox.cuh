// Philox4x32-10 and the keep mask of the s1 attention's dropout, which K1
// (prefill_attention.cu, prefill_attention_bf16.cu) draws once and writes
// as bits (below); K5 (prefill_attention_bwd.cu,
// prefill_attention_bwd_bf16.cu) reads those bits in both dtypes, so no
// kernel draws the mask twice.  Its twin, bit for bit, is ops/philox.py.
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
// the four keys of a call sit in one tile; K1 gathers each call's four bits
// into 32-key words by shuffles.
//
// The mask as bits (K1's dropout instances write it, K5's read it, in fp32
// and bf16 alike; ops/philox.py pack_keep_mask / unpack_keep_mask): a
// (B, H, T, W) int32 tensor, W = ceil(x_len / 32) + ceil((T - x_len) / 32),
// a query row's text words and then its audio words.  Bit j of word w of
// a segment is the keep bit of key 32 w + j of that segment AND-ed with
// the pair's visibility under the hybrid mask: hidden pairs, and the keys
// past a segment's end in its last word, read 0.  Since key tiles start at
// multiples of 32 keys into their segment, a tile of 32 n keys is n whole
// words of each row.
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

// W, the words of a query row of the mask as bits
__host__ __device__ __forceinline__ int mask_words(int T, int x_len) {
  return (x_len + 31) / 32 + (T - x_len + 31) / 32;
}

// The dropout argument of K1 and K5 (by value, the last kernel argument;
// the instances without dropout take it and never read it): Dropout's
// fields and the mask as bits
struct DropoutBits : Dropout {
  uint32_t* bits;  // (B, H, T, W): K1 writes them (not when null), K5 reads
                   // them
};

// The DropoutBits of a launch; K5, which only reads the bits, passes the
// key, threshold, layer, row0 and h0 as 0
__host__ inline DropoutBits dropout_bits(unsigned long long seed,
                                         uint32_t thr, uint32_t layer,
                                         float keep, uint32_t row0,
                                         uint32_t h0, void* bits) {
  DropoutBits d;
  d.k0 = (uint32_t)seed;
  d.k1 = (uint32_t)(seed >> 32);
  d.thr = thr;
  d.layer = layer;
  d.inv_keep = 1.f / keep;
  d.row0 = row0;
  d.h0 = h0;
  d.bits = (uint32_t*)bits;
  return d;
}

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

}  // namespace ev
