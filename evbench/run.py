#!/usr/bin/env python3
"""The benchmark of ``easevoice_trainer_tpu_torch``: one run of one cell.

    python3 evbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration and its traffic are found by name in
``BENCHMARK.json``; the configuration's ``driver`` names the module under
``evbench/drivers/`` that builds the run.  Set-up (data, weights, the
first steps that warm every shape up) is timed from the process start; the
window then runs for ``--seconds``.  ``--trace 0`` prints the cell's
end-to-end metrics; ``--trace 1`` runs the same window, then a few steps
under the profiler, and prints the per-layer metrics, each read by
``evbench/metrics/<name>.py``.  After the window the program's first steps
are checked against the plain reference, and the last line of standard
output is one JSON object.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# the caches of what the run builds live in the checkout, at fixed paths
for _var, _sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernel_cache"),
                   ("TRITON_CACHE_DIR", "triton_cache"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, "build", "evbench", _sub)

from evbench import common, compare, evtrace  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the window's step records, the traced
    block (None where the profiler lost records), the configuration, the
    traffic and the peaks."""

    window: dict
    trace: object
    cfg: dict
    traffic: dict
    cell: dict


def per_layer(bench: dict, cell: dict, ctx: Context) -> dict:
    out = {}
    for m in common.metrics_of(bench, "per_layer", cell["name"]):
        mod = common.load_module(
            os.path.join(common.HERE, "metrics", m["name"] + ".py"),
            "evbench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = (float(value), m["unit"])
    return out


def run(bench: dict, cell: dict, cfg: dict, traffic: dict, seed: int,
        seconds: float, trace: bool, device: str = "cuda",
        driver_module=None):
    """One run: -> (result line, exit code)."""
    import torch

    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if driver_module is None:
        driver_module = importlib.import_module("evbench.drivers."
                                                + cfg["driver"])
    drv = driver_module.Driver(cfg, traffic, seed, device)
    try:
        drv.setup()
        setup_s = time.perf_counter() - T0
        win = drv.window(seconds)
        traced = None
        if trace:
            traced = evtrace.traced_block(
                torch, lambda: drv.traced_steps(cfg["trace_steps"]),
                drv.launches, evtrace.kernels_of(), log=common.log,
                device=device)
            if traced is None:
                common.log("the profiler lost records in every session")
                return None, 1
        if on_card:
            dev = common.device_info(torch, cell["chips"])
        else:
            dev = {"platform": "cpu", "kind": "cpu", "count": 1,
                   "memory_peak_bytes": 0}
        if trace:
            metrics = per_layer(bench, cell, Context(win, traced, cfg,
                                                     traffic, cell))
            dev["busy_s"] = traced.busy_s()
            dev["window_s"] = traced.window_s
            breakdown = {"device_ops": traced.top_ops(),
                         "idle_gaps": traced.idle_gaps()}
        else:
            values = dict(win["e2e"])
            values["setup_s"] = setup_s
            values["train_peak_gib"] = dev["memory_peak_bytes"] / 2 ** 30
            metrics = {m["name"]: (values[m["name"]], m["unit"])
                       for m in common.metrics_of(bench, "end_to_end",
                                                  cell["name"])}
            breakdown = None
        common.log(f"window {win['seconds']:.3f} s, {win['attempted']} steps;"
                   f" set-up {setup_s:.3f} s; peak "
                   f"{dev['memory_peak_bytes'] / 2 ** 30:.3f} GiB")
        for key in ("load_s", "step_s", "audio_s"):
            vals = sorted(r[key] for r in win["steps"])
            common.log(f"window {key}: mean {sum(vals) / len(vals):.4f}, "
                       f"min {vals[0]:.4f}, median {vals[len(vals) // 2]:.4f},"
                       f" max {vals[-1]:.4f}")
        drv.release()
        t = time.perf_counter()
        checks = drv.check()
        common.log(f"check {time.perf_counter() - t:.1f} s")
    finally:
        drv.close()
    for c in checks.values():
        if not math.isfinite(c["value"]):
            common.log(f"a compared number is {c['value']}")
            c["value"] = 1e300
    correct = compare.passed(checks)
    line = common.result_line(correct, win["attempted"], win["failed"],
                              metrics, dev, checks, breakdown)
    return line, 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = common.benchmark()
    cell = common.cell(bench, args.workload)
    cfg = common.config_file(bench, cell["config"])
    traffic = common.traffic_file(cell["traffic"])
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        common.log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                   f"this machine has "
                   f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    line, rc = run(bench, cell, cfg, traffic, args.seed, args.seconds,
                   bool(args.trace))
    if rc:
        return rc
    found = common.forbidden_loaded()
    if found:
        common.log(f"modules that no run may load are loaded: {found}")
        return 3
    import json

    common.print_checks(json.loads(line)["checks"])
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
