"""What every cell of the benchmark shares: seeds, the weights made from a
seed, the data file layout, the result line, and the look for JAX.

Nothing here imports the program under test; the drivers do.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))

# top-level module names that no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "easevoice_trainer_tpu")

# sub-seed tags: each draw of a run has its own stream from --seed
TAG_WEIGHTS, TAG_TRAFFIC, TAG_ORDER, TAG_STEP = 1, 2, 3, 4


def sub_seed(seed: int, tag: int, bits: int = 63) -> int:
    """A seed for the draw ``tag`` of run ``seed`` (any non-negative
    integer; the driver's are larger than 32 bits hold)."""
    state = np.random.SeedSequence([int(seed) % (1 << 128), tag])
    word = state.generate_state(2, np.uint64)
    return int((int(word[0]) << 64 | int(word[1])) % (1 << bits))


def load_json(path: str) -> dict:
    with open(path, encoding="utf8") as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_file(name: str) -> dict:
    return load_json(os.path.join(HERE, "workloads", name + ".json"))


def load_module(path: str, name: str):
    """A module from a file path (metric readers are named with dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, kind: str, workload: str) -> List[dict]:
    """The ``kind`` ("end_to_end" / "per_layer") metrics that cell
    ``workload`` reports."""
    e2e = {m["name"] for m in metrics_for_e2e(bench, workload)}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def metrics_for_e2e(bench: dict, workload: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def top_level_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)})


def forbidden_loaded() -> List[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole (the
    port's name begins with the JAX package's)."""
    loaded = set(top_level_modules())
    return [m for m in FORBIDDEN_MODULES if m in loaded]


# ---- weights from the seed -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InitRule:
    """How a parameter is drawn: ``mean + std * N(0, 1)``."""

    mean: float
    std: float


def default_rule(name: str, shape: Sequence[int]) -> InitRule:
    """Weights at 1 / sqrt(fan-in), biases small, embeddings at 1, norm
    gains, scalars and weight-norm gains near 1 (a direction drawn at
    1 / sqrt(fan-in) has about unit norm, so the weight keeps its scale)."""
    leaf = name.rsplit(".", 1)[-1]
    n = int(np.prod(shape)) if len(shape) else 1
    norm_gain = len(shape) == 1 and leaf == "weight" and "norm" in name
    if n == 1 or leaf in ("gamma", "weight_g") or norm_gain:
        return InitRule(1.0, 0.1)
    if leaf in ("bias", "beta"):
        return InitRule(0.0, 0.02)
    if "embedding" in name:
        return InitRule(0.0, 1.0)
    fan_in = n // shape[0] if len(shape) > 1 else n
    return InitRule(0.0, 1.0 / math.sqrt(max(fan_in, 1)))


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
                 rule: Callable[[str, Sequence[int]], InitRule] = default_rule
                 ) -> Dict[str, "torch.Tensor"]:
    """fp32 weights for ``shapes``, drawn on ``device`` in one call from a
    generator seeded by ``seed`` and cut in sorted name order: the same seed
    gives the same weights on the same kind of device."""
    import torch

    names = sorted(shapes)
    sizes = [int(np.prod(shapes[k])) if len(shapes[k]) else 1 for k in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, TAG_WEIGHTS))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for k, n in zip(names, sizes):
        r = rule(k, shapes[k])
        out[k] = (flat[at:at + n] * r.std + r.mean).view(shapes[k]).clone()
        at += n
    return out


# ---- the run's result ---------------------------------------------------


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_info(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def print_checks(checks: Dict[str, dict]) -> None:
    """Each compared number beside its limit, as the last lines on stderr."""
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Tuple[float, str]], device: dict,
                checks: Dict[str, dict],
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": v, "unit": u}
                       for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m
