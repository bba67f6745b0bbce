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

    counter = (i // 4, row, b, layer << 16 | h << 1 | is_audio_key)
    key     = (seed mod 2^32, seed // 2^32)

So a keep bit is a function of (seed, layer, b, h, row, key) and the
text / audio split alone: no tile, warp or launch enters it, and the fp32
and bf16 kernels, K1 and K5, and this twin all draw the same bit.
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
                        x_len: int, p: float, device=None) -> torch.Tensor:
    """The keep mask (b, h, t, t) bool of the s1 attention's dropout at
    rate ``p`` in layer ``layer``: [batch, head, query row, key], drawn as
    the module note says.  Built one Philox call per four keys of a
    segment, as the kernels draw it."""
    if not 0 <= x_len <= t:
        raise ValueError(f"attention_keep_mask: x_len {x_len} outside "
                         f"[0, {t}]")
    k0, k1 = split_seed(seed)
    thr = keep_threshold(p)
    dev = torch.device("cpu") if device is None else torch.device(device)
    rows = torch.arange(t, dtype=torch.int64, device=dev)
    heads = torch.arange(h, dtype=torch.int64, device=dev)
    parts = []
    for audio, n in ((0, x_len), (1, t - x_len)):
        if n == 0:
            continue
        groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=dev)
        words = []
        for bi in range(b):     # one batch row at a time bounds the memory
            c3 = (layer << 16) | (heads << 1) | audio
            w = philox4x32_10(groups[None, None, :], rows[None, :, None],
                              bi, c3[:, None, None], k0, k1)
            # (h, t, groups, 4) -> (h, t, 4 * groups): word j is key 4 g + j
            words.append(torch.stack(w, dim=-1).flatten(-2)[..., :n] < thr)
        parts.append(torch.stack(words))
    return torch.cat(parts, dim=-1)
