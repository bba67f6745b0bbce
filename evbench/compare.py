"""The comparison that decides ``correct`` for a training cell.

A cell's check follows the program's first optimizer steps with the plain
reference, from the same weights and the same rows, and reads the numbers
below; those that the configuration's ``check.limits`` names are compared:

* ``loss_gap``: each step's (or micro-batch's) loss, the worst relative gap;
* ``grad_gap``: the first gradient as the optimizer got it, leaf by leaf:
  the gap between the program's norm and the reference's over the larger
  of the reference's norm of that leaf and of the median leaf;
* ``change_gap``: the parameters' change over the steps the reference
  follows, measured the same way.  Only the elements whose first reference
  gradient is at least a thousandth of the median leaf's RMS gradient
  count: the others (a key's bias under softmax, a third of each fused qkv
  bias) have a gradient that is nought but round-off, which Adam scales up
  to full-size steps of random sign in either implementation.
"""
from __future__ import annotations

import statistics
from typing import Dict, Sequence

SMALL_GRADIENT = 1e-3   # of the median leaf's RMS gradient


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    if len(program) != len(reference) or not program:
        raise ValueError(f"{len(program)} program losses against "
                         f"{len(reference)} of the reference")
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float]
              ) -> Dict[str, float]:
    """Each leaf's |norm_p - norm_r| / max(norm_r, the median leaf's
    norm_r)."""
    missing = [k for k in reference if k not in program]
    if missing:
        raise ValueError(f"the program has no {missing[:3]}")
    floor = statistics.median(reference.values())
    return {k: abs(program[k] - r) / max(r, floor)
            for k, r in reference.items()}


def leaf_gap(program: Dict[str, float], reference: Dict[str, float]
             ) -> float:
    """The worst leaf's gap."""
    return max(leaf_gaps(program, reference).values())


def moving_masks(ref_grads: dict) -> dict:
    """{leaf: bool mask of its elements whose first reference gradient is
    at least SMALL_GRADIENT x the median leaf's RMS gradient}, leaves with
    no such element left out."""
    rms = {k: float(g.float().pow(2).mean().sqrt()) for k, g in
           ref_grads.items()}
    floor = SMALL_GRADIENT * statistics.median(rms.values())
    masks = {k: g.abs() >= floor for k, g in ref_grads.items()}
    return {k: m for k, m in masks.items() if bool(m.any())}


def masked_change_norms(after: dict, before: dict, masks: dict,
                        device) -> Dict[str, float]:
    """Each masked leaf's norm of (after - before) over its mask."""
    return {k: float((after[k].to(device).float() - before[k])[m].norm())
            for k, m in masks.items()}


def checks(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} in the order of ``limits``."""
    return {k: {"value": float(values[k]), "limit": float(limits[k])}
            for k in limits}


def passed(checks_: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks_.values())
