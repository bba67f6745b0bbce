"""Philox4x32-10 in torch integer arithmetic, and the keep mask of the s1
attention's dropout drawn from it: the twin of ``csrc/philox.cuh``, which
K1 and K5 (``csrc/prefill_attention*.cu``) draw the same mask from inside
their loops.

Philox4x32-10 is the counter-based generator of Salmon, Moraes, Dror and
Shaw, "Parallel random numbers: as easy as 1, 2, 3" (SC 2011), as the
Random123 library defines it: a 128-bit counter (c0, c1, c2, c3) and a
64-bit key (k0, k1) give four 32-bit words through ten rounds of

    hi0:lo0 = 0xD2511F53 * c0,  hi1:lo1 = 0xCD9E8D57 * c2,
    (c0, c1, c2, c3) <- (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0),

the key bumped by (0x9E3779B9, 0xBB67AE85) before every round but the
first.  Everything here is int64 tensors holding 32-bit values, so it runs
on the CPU and on the card alike; a 32 x 32-bit product is taken in 16-bit
halves, which int64 holds exactly.

The mask (written down once here and in ``philox.cuh``): the pair of query
``row`` and ``key`` of batch row ``b``, head ``h``, layer ``layer`` is kept
iff its word is below ``keep_threshold(p)``.  A key is named by its segment
(text keys ``[0, x_len)``, audio keys ``[x_len, T)``) and its index ``i`` in
that segment; one Philox call serves the four keys ``4 (i // 4) ..
4 (i // 4) + 3`` of one segment and one row, word ``i % 4`` for key ``i``:

    counter = (i // 4, row, row0 + b,
               layer << 16 | (h0 + h) << 1 | is_audio_key)
    key     = (seed mod 2^32, seed // 2^32)

``row0 + b`` is the row in the global batch: a rank of a data-parallel step
whose rows start at ``row0`` of the global batch passes that ``row0`` (0
outside data parallel), so a world of ranks draws the masks one process
draws on the whole batch.  ``h0 + h`` is the head among all heads: a rank of
a tensor-parallel step that holds heads ``h0 ..`` of the layer passes that
``h0`` (0 otherwise), so it draws the bits one process draws for them.

So a keep bit is a function of (seed, layer, row0 + b, h0 + h, row, key)
and the text / audio split alone: no tile, warp or launch enters it, and
the fp32 and bf16 kernels, K1 and K5, and this twin all draw the same bit.

The mask as bits (K1's dropout instances write it, K5's read it instead of
drawing it again, in fp32 and bf16 alike): an int32 tensor (..., T, W) with
``W = mask_words(T, x_len) = ceil(x_len / 32) + ceil((T - x_len) / 32)``,
a query row's text words and then its audio words; bit ``j`` of word ``w``
of a segment is key ``32 w + j`` of that segment.  K1 writes the keep
mask AND-ed with the pairs' visibility (hidden pairs read 0), one bit a
pair where the JAX package's ``jax.value_and_grad`` keeps the boolean mask,
a byte a pair, as a residual of the forward.  :func:`pack_keep_mask` and
:func:`unpack_keep_mask` are the twins of that layout.
"""
from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57     # the round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85     # the key schedule's increments
MASK32 = 0xFFFFFFFF
ROUNDS = 10


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x, m a 32-bit constant and x int64
    holding 32-bit values."""
    p_lo = m * (x & 0xFFFF)           # < 2^48
    p_hi = m * (x >> 16)              # < 2^48
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counters (int64 tensors of one shape and
    device, or ints broadcast against them, each in [0, 2^32)) under the
    key (k0, k1): four int64 tensors of 32-bit words."""
    dev = next((c.device for c in (c0, c1, c2, c3)
                if isinstance(c, torch.Tensor)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=dev)
          for c in (c0, c1, c2, c3)))
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(p: float) -> int:
    """A pair is kept iff its 32-bit word is below this: floor((1 - p)
    2^32), so the drop rate is p within 2^-32.  For 0 < p < 1."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"keep_threshold: p {p} outside (0, 1)")
    return min(int((1.0 - p) * 2.0 ** 32), MASK32)


def split_seed(seed: int):
    """The 64-bit Philox key of a host integer seed: (low, high) words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & MASK32, seed >> 32


def attention_keep_mask(seed: int, layer: int, b: int, h: int, t: int,
                        x_len: int, p: float, device=None,
                        row0: int = 0, h0: int = 0) -> torch.Tensor:
    """The keep mask (b, h, t, t) bool of the s1 attention's dropout at
    rate ``p`` in layer ``layer``: [batch, head, query row, key], drawn as
    the module note says, for the global batch rows ``row0 .. row0 + b``
    and the heads ``h0 .. h0 + h`` of the layer.
    Built one Philox call per four keys of a segment, as the kernels draw
    it."""
    if not 0 <= x_len <= t:
        raise ValueError(f"attention_keep_mask: x_len {x_len} outside "
                         f"[0, {t}]")
    k0, k1 = split_seed(seed)
    thr = keep_threshold(p)
    dev = torch.device("cpu") if device is None else torch.device(device)
    rows = torch.arange(t, dtype=torch.int64, device=dev)
    heads = torch.arange(h0, h0 + h, dtype=torch.int64, device=dev)
    parts = []
    for audio, n in ((0, x_len), (1, t - x_len)):
        if n == 0:
            continue
        groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=dev)
        words = []
        for bi in range(b):     # one batch row at a time bounds the memory
            c3 = (layer << 16) | (heads << 1) | audio
            w = philox4x32_10(groups[None, None, :], rows[None, :, None],
                              row0 + bi, c3[:, None, None], k0, k1)
            # (h, t, groups, 4) -> (h, t, 4 * groups): word j is key 4 g + j
            words.append(torch.stack(w, dim=-1).flatten(-2)[..., :n] < thr)
        parts.append(torch.stack(words))
    return torch.cat(parts, dim=-1)


def mask_words(t: int, x_len: int) -> int:
    """W, the 32-key words of one query row of the mask as bits: the text
    segment's, then the audio segment's, each rounded up."""
    return -(-x_len // 32) + -(-(t - x_len) // 32)


def pack_keep_mask(mask: torch.Tensor, x_len: int) -> torch.Tensor:
    """The mask as bits: ``mask`` (..., T) bool over the keys of each row
    (text keys ``[0, x_len)``, then audio keys) -> int32 (..., W), bit j
    of word w of a segment key 32 w + j of that segment, the keys past a
    segment's end 0."""
    t = mask.shape[-1]
    if not 0 <= x_len <= t:
        raise ValueError(f"pack_keep_mask: x_len {x_len} outside [0, {t}]")
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=mask.device),
        torch.arange(32, device=mask.device))
    words = []
    for seg in (mask[..., :x_len], mask[..., x_len:]):
        n = seg.shape[-1]
        pad = -n % 32
        seg = torch.nn.functional.pad(seg.to(torch.int64), (0, pad))
        w = (seg.unflatten(-1, ((n + pad) // 32, 32)) * weights).sum(-1)
        words.append(torch.where(w >= 2 ** 31, w - 2 ** 32, w))
    return torch.cat(words, dim=-1).to(torch.int32)


def unpack_keep_mask(bits: torch.Tensor, t: int, x_len: int) -> torch.Tensor:
    """The inverse of :func:`pack_keep_mask`: int32 (..., W) -> bool
    (..., T) over the keys of each row."""
    n_text = -(-x_len // 32)
    if not 0 <= x_len <= t or bits.shape[-1] != mask_words(t, x_len):
        raise ValueError(f"unpack_keep_mask: {bits.shape[-1]} words for "
                         f"T = {t}, x_len = {x_len}")
    shifts = torch.arange(32, device=bits.device)
    keys = (bits.to(torch.int64)[..., None] >> shifts) & 1
    keys = keys.flatten(-2).bool()
    return torch.cat([keys[..., :x_len],
                      keys[..., 32 * n_text:32 * n_text + t - x_len]], -1)
