#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, for one cell, in one
process (the benchmark's own runs do not run this).

    python3 evbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--mixed-seeds 1 2 3] \
        [--draw fan_in] [--optimizer-steps n] [--out file.jsonl]

For each seed: set-up as a run makes it (data, weights, the program's first
steps), then the plain reference follows those steps, and the compared
numbers are printed, one JSON line each ("program").  For each control seed
also: the reference computed in the precision below the configuration's, in
the program's place ("control"), and the reference with half of each batch
left out and the rest's sum doubled ("half_batch").  A step that leaves the
state unchanged reads 1 on ``change_gap`` by construction and needs no run.
For each mixed seed: the reference under ``torch.autocast`` in the
configuration's compute dtype ("mixed"), the published 16-mixed, in the
program's place: what the program's own rounding is measured against.

``--draw fan_in`` draws the weights by the common rule alone (the
benchmark's first draw: s1's matrices at 1 / sqrt(fan-in)) instead of the
reference's ``init_rule``; ``--optimizer-steps`` overrides the steps the s1
reference follows.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from evbench import common  # noqa: E402
from evbench import run as run_mod  # noqa: E402,F401  (cache locations)

LOWER = {"bfloat16": "float8_e4m3fn", "float16": "float8_e4m3fn",
         "float32": "bfloat16"}


def readings(driver_module, cfg: dict, traffic: dict, seed: int,
             device: str, control: bool, mixed: bool = False):
    """-> [(kind, numbers)] of one seed."""
    import torch

    drv = driver_module.Driver(cfg, traffic, seed, device)
    try:
        t = time.perf_counter()
        drv.setup()
        drv.release()
        common.log(f"seed {seed}: set-up {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        reference = drv.follow()
        common.log(f"seed {seed}: reference {time.perf_counter() - t:.1f} s")
        out = [("program", drv.numbers(drv.program_result(), reference))]
        if control:
            low = getattr(torch, LOWER[cfg["compute_dtype"]])
            out.append(("control", drv.numbers(
                drv.follow(q=driver_module.ref.Lowp(low)), reference)))
            out.append(("half_batch", drv.numbers(
                drv.follow(half_rows=True), reference)))
        if mixed:
            with torch.autocast(drv.device.type,
                                dtype=getattr(torch, cfg["compute_dtype"])):
                autocast = drv.follow()
            out.append(("mixed", drv.numbers(autocast, reference)))
        return out
    finally:
        drv.close()


def main(argv=None) -> int:
    import importlib

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--mixed-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--draw", choices=("config", "fan_in"), default="config")
    ap.add_argument("--optimizer-steps", type=int)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench = common.benchmark()
    cell = common.cell(bench, args.workload)
    cfg = common.config_file(bench, cell["config"])
    traffic = common.traffic_file(cell["traffic"])
    import torch

    if not torch.cuda.is_available():
        common.log("calibrate needs the card")
        return 2
    mod = importlib.import_module("evbench.drivers." + cfg["driver"])
    if args.optimizer_steps:
        cfg["check"]["optimizer_steps"] = args.optimizer_steps
    if args.draw == "fan_in":
        mod.ref.init_rule = common.default_rule
    lines = []
    seeds = set(args.seeds) | set(args.control_seeds) | set(args.mixed_seeds)
    for seed in sorted(seeds):
        for kind, numbers in readings(mod, cfg, traffic, seed, "cuda",
                                      seed in args.control_seeds,
                                      seed in args.mixed_seeds):
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "kind": kind, "draw": args.draw,
                               "optimizer_steps": cfg["check"].get(
                                   "optimizer_steps"), **numbers})
            print(line, flush=True)
            lines.append(line)
    if args.out:
        with open(args.out, "a", encoding="utf8") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
