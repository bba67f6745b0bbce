"""The one generator of the benchmark's traffic: a set of utterances or
clips from a workload file's parameters and a seed.

Every seed gets the same set of sizes: each duration is a quantile of the
file's distribution at (i + 0.5) / count, paired with a phoneme rate (a
quantile of its own distribution) by a permutation fixed for the mix, and
the seed only decides which item gets which pair and what the item holds.
So two seeds do the same work, padded to the same shapes, in another
order, and the spread between seeds is the system's, not the draw's.

A workload file holds:

* ``count``: items in the dataset folder;
* ``seconds``: {"dist": "uniform" | "log_uniform", "low", "high"};
* ``phonemes_per_second``: the same, the text's rate over its audio;
* ``language``: which symbols the phonemes are drawn from ("zh": the
  toned finals and initials of the v2 inventory);
* ``batch_size``: rows a step takes;
* ``why``: one line;
* ``sources``: for each of the above that is not the program's own, where
  it comes from, or that it is assumed.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import List

import numpy as np

from .common import HERE, TAG_TRAFFIC, sub_seed

LANG_SYMBOLS = {"zh": r"^[a-z]+[1-5]?$"}


def symbols() -> List[str]:
    with open(os.path.join(HERE, "data", "symbols_v2.json"),
              encoding="utf8") as f:
        return json.load(f)


def quantiles(spec: dict, n: int) -> np.ndarray:
    """``n`` sizes at the (i + 0.5) / n quantiles of ``spec``."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(spec["low"]), float(spec["high"])
    if spec["dist"] == "uniform":
        return lo + u * (hi - lo)
    if spec["dist"] == "log_uniform":
        return np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    raise ValueError(f"unknown distribution {spec['dist']!r}")


@dataclasses.dataclass
class Item:
    name: str
    seconds: float
    phonemes: np.ndarray        # symbol ids, int64


def items(traffic: dict, seed: int) -> List[Item]:
    """The dataset's items for ``seed``: names, lengths and phonemes."""
    rng = np.random.default_rng(sub_seed(seed, TAG_TRAFFIC))
    n = int(traffic["count"])
    pairing = np.random.default_rng(0).permutation(n)   # the mix's own
    order = rng.permutation(n)
    secs = quantiles(traffic["seconds"], n)[order]
    rates = quantiles(traffic["phonemes_per_second"], n)[pairing][order]
    table = symbols()
    rx = re.compile(LANG_SYMBOLS[traffic["language"]])
    pool = np.asarray([i for i, s in enumerate(table) if rx.match(s)])
    out = []
    for i in range(n):
        n_ph = max(1, int(round(secs[i] * rates[i])))
        out.append(Item(f"utt{i:05d}", float(secs[i]),
                        rng.choice(pool, size=n_ph).astype(np.int64)))
    return out


def random_normal(torch, n: int, seed: int, device, dtype) -> np.ndarray:
    """``n`` N(0, 1) values drawn on ``device`` in one call, on the host."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(n, generator=gen, device=device,
                       dtype=dtype).cpu().numpy()


def random_ints(torch, n: int, high: int, seed: int, device) -> np.ndarray:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, high, (n,), generator=gen,
                         device=device).cpu().numpy()
