"""The yardstick: the chip's peaks, each kernel's operations and bytes from
its call's shapes, and the model FLOPs of one utterance or clip.

Operations and bytes follow the least-time rule: each input byte read once,
each output byte written once, operations over the work the inputs need (the
visible pairs of a masked attention, not its padded square).  The model
FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over the
plain references on the meta device (forward and backward, no
recomputation), at each item's unpadded lengths.
"""
from __future__ import annotations

import hashlib
import json
import os
from fractions import Fraction
from typing import Callable, Dict, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAKS = {
    "bf16_flops_per_s": 989e12,
    "tf32_flops_per_s": 495e12,
    "hbm_bytes_per_s": 3.35e12,
}


def flops_per_s(dtype: str) -> float:
    """The peak rate of a compute dtype's products: bf16 on the tensor
    cores; fp32-accurate products as three TF32 passes."""
    return PEAKS["bf16_flops_per_s"] if dtype == "bfloat16" else \
        PEAKS["tf32_flops_per_s"] / 3


def elem_bytes(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def least_seconds(flops: float, nbytes: float,
                  flops_per_s: float = PEAKS["bf16_flops_per_s"]) -> float:
    """The least time of a call: operations at the peak rate or bytes at
    the memory's, whichever is longer."""
    return max(flops / flops_per_s, nbytes / PEAKS["hbm_bytes_per_s"])


# ---- attention (K1 forward with its lse, K5 backward) ---------------------


def visible_pairs(x_len: int, y_len: int, x_lens: Sequence[int],
                  y_lens: Sequence[int]) -> int:
    """(query row, key) pairs the s1 hybrid mask lets through, summed over
    the batch: every one of the x_len text rows sees its row's valid text;
    audio row j sees the valid text and audio keys 0..min(j, y_len_b - 1)."""
    total = 0
    for xl, yl in zip(x_lens, y_lens):
        xl, yl = int(xl), int(yl)
        total += (x_len + y_len) * xl + yl * (yl + 1) // 2 + (y_len - yl) * yl
    return total


def attention_fwd_cost(b: int, t: int, h: int, dk: int, pairs: int,
                       elem_bytes: int = 2) -> Tuple[float, float]:
    """K1 with its lse: (operations, bytes).  QK and PV for each visible
    (row, key, head): 4 dk; q, k, v read and o written at ``elem_bytes``,
    the fp32 lse written."""
    return 4.0 * dk * pairs * h, elem_bytes * 4.0 * b * t * h * dk + \
        4.0 * b * h * t


def attention_bwd_cost(b: int, t: int, h: int, dk: int, pairs: int,
                       elem_bytes: int = 2) -> Tuple[float, float]:
    """K5: (operations, bytes).  S, dP, dV, dQ and dK for each visible
    (row, key, head): 10 dk; q, k, v, o, dO read and dq, dk, dv written at
    ``elem_bytes``, the fp32 lse read."""
    return 10.0 * dk * pairs * h, elem_bytes * 8.0 * b * t * h * dk + \
        4.0 * b * h * t


# ---- the MRF convs (K3 forward, K4-dx, K4-dW) ----------------------------


def mrf_conv_costs(b: int, ch: int, t: int, k: int, residual: bool,
                   elem_bytes: int = 2) -> Dict[str, Tuple[float, float]]:
    """One ResBlock conv of ``ch`` channels, kernel ``k``, over (b, ch, t):
    {"k3" | "dx" | "dw": (operations, bytes)}.  K3 reads x (and the
    residual), the weight and bias and writes y; K4-dx reads dy and x (the
    activation's derivative) and the weight and writes dx; K4-dW reads dy
    and x and writes the weight's and the bias's gradients."""
    flops = 2.0 * b * t * ch * ch * k
    act = b * ch * t
    wts = ch * ch * k
    return {
        "k3": (flops, elem_bytes * (act * (3 if residual else 2) + wts + ch)),
        "dx": (flops, elem_bytes * (3 * act + wts)),
        "dw": (flops, elem_bytes * (2 * act + wts + ch)),
    }


# ---- model FLOPs ----------------------------------------------------------


def count_flops(fn: Callable[[], None]) -> int:
    """FLOPs that FlopCounterMode counts over ``fn`` (run it on meta
    tensors: it costs no device time)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        with torch.device("meta"):
            fn()
    return int(counter.get_total_flops())


def solve_exact(rows, values):
    """Solves a small square system of integer equations exactly."""
    n = len(rows)
    a = [[Fraction(x) for x in r] + [Fraction(v)] for r, v in
         zip(rows, values)]
    for c in range(n):
        piv = next(r for r in range(c, n) if a[r][c] != 0)
        a[c], a[piv] = a[piv], a[c]
        for r in range(n):
            if r != c and a[r][c] != 0:
                f = a[r][c] / a[c][c]
                a[r] = [x - f * y for x, y in zip(a[r], a[c])]
    return [a[i][n] / a[i][i] for i in range(n)]


class PolyFlops:
    """FLOPs as an exact sum of monomials of an item's lengths, fitted from
    counts at as many points as terms and checked at one more (or given
    the coefficients of such a fit)."""

    def __init__(self, terms: Sequence[Callable[..., int]],
                 count: Callable[..., int] = None,
                 points: Sequence[tuple] = (), coef=None):
        self.terms = list(terms)
        if coef is not None:
            self.coef = [Fraction(c) for c in coef]
            return
        n = len(self.terms)
        if len(points) != n + 1:
            raise ValueError("PolyFlops: give one point more than terms")
        rows = [[t(*p) for t in self.terms] for p in points[:n]]
        self.coef = solve_exact(rows, [count(*p) for p in points[:n]])
        check = points[n]
        got, want = self(*check), count(*check)
        if got != want:
            raise ValueError(f"PolyFlops: the fit gives {got} at {check}, "
                             f"the counter {want}: the terms miss a shape")

    def __call__(self, *lengths) -> int:
        total = sum(c * t(*lengths) for c, t in zip(self.coef, self.terms))
        if total.denominator != 1:
            raise ValueError(f"PolyFlops: {total} FLOPs at {lengths}")
        return int(total)


CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "evbench", "flops")


def cached(cfg: dict, sources: Sequence[str],
           compute: Callable[[], Dict[str, list]]) -> Dict[str, list]:
    """``compute()`` (lists of exact coefficients, as strings), kept in the
    checkout's build directory under a hash of the configuration and the
    files the count reads, so that only a checkout's first run counts."""
    digest = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
    for path in sources:
        with open(path, "rb") as f:
            digest.update(f.read())
    path = os.path.join(CACHE, digest.hexdigest()[:24] + ".json")
    if os.path.exists(path):
        with open(path, encoding="utf8") as f:
            return json.load(f)
    out = compute()
    os.makedirs(CACHE, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf8") as f:
        json.dump(out, f)
    os.replace(tmp, path)
    return out


def coef_strings(fit: PolyFlops) -> list:
    return [str(c) for c in fit.coef]
