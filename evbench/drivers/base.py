"""What the fine-tune drivers share: the program's bucket order as an
endless stream, one timed step (the batch load, the step, the
synchronize), the window, the traced steps and the reading of the
program's launch counters.

A driver subclasses :class:`TrainDriver` and gives ``setup``, ``load``
(one batch on the device and its record) and ``step`` (the program's call
on it), and the check: ``program_result``, ``follow`` and ``numbers``.
"""
from __future__ import annotations

import statistics
import tempfile
import time
from typing import Dict, List, Optional

from .. import compare, evtrace
from ..common import log


class TrainDriver:
    """One run of a fine-tune cell on ``device`` (the card; "cpu" in the
    tests)."""

    # the end-to-end rate the window reports, and the audio rate of a frame
    rate_metric = ""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        import torch

        self.torch = torch
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        # the models' compute dtype (None: fp32, the program's default)
        self.dtype = None if cfg["compute_dtype"] == "float32" else \
            getattr(torch, cfg["compute_dtype"])
        self.check_cfg = cfg["check"]
        self.records: List[dict] = []
        self.prefix = None                  # the set-up's steps, once run
        self.t_setup = time.perf_counter()
        self.tmp: Optional[tempfile.TemporaryDirectory] = None

    def _stream(self, batcher):
        epoch = 1
        while True:
            for bucket, idxs in batcher.epoch_batches(epoch):
                yield bucket, idxs
            epoch += 1

    def run_step(self) -> dict:
        """One step as the trainer runs it: load the batch, call the step,
        synchronize.  Appends and returns its record."""
        torch = self.torch
        from torch.profiler import record_function

        t0 = time.perf_counter()
        if self.prefix is None:
            log(f"set-up step {len(self.records) + 1} at "
                f"{time.perf_counter() - self.t_setup:.2f} s")
        with record_function("evbench.batch_load"):
            batch, rec = self.load()
        t1 = time.perf_counter()
        with record_function("evbench.step"):
            metrics = self.step(batch, rec)
        with record_function("evbench.sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        rec["load_s"], rec["step_s"] = t1 - t0, time.perf_counter() - t1
        self.after_step(rec, metrics)
        self.records.append(rec)
        return rec

    def mark(self, what: str) -> None:
        """Logs how far set-up has come."""
        log(f"set-up: {what} at {time.perf_counter() - self.t_setup:.2f} s")

    def after_step(self, rec: dict, metrics: dict) -> None:
        """What the check keeps of a set-up step."""

    def window(self, seconds: float) -> dict:
        self.records = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.run_step()
        elapsed = time.perf_counter() - t0
        steps = self.records
        return {"seconds": elapsed, "steps": steps,
                "e2e": {self.rate_metric: sum(r["audio_s"] for r in steps)
                        / elapsed},
                "attempted": len(steps), "failed": 0}

    def traced_steps(self, n: int) -> List[dict]:
        self.records = []
        for _ in range(n):
            self.run_step()
        return list(self.records)

    def launches(self) -> int:
        """The program's launches of the kernels ``kernels/`` names."""
        from easevoice_trainer_tpu_torch import ops

        return evtrace.counted_launches(ops.launch_counts())

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        for name in self.program_state:
            setattr(self, name, None)
        if self.device.type == "cuda":
            import gc

            gc.collect()
            self.torch.cuda.empty_cache()

    program_state = ()

    def check(self) -> dict:
        numbers = self.numbers(self.program_result(), self.follow())
        return compare.checks(numbers, self.check_cfg["limits"])

    def close(self) -> None:
        if self.tmp is not None:
            self.tmp.cleanup()
            self.tmp = None


def leaf_norms(torch, tensors: Dict[str, "torch.Tensor"]) -> Dict[str, float]:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def log_loss_gaps(program, reference) -> None:
    """Each step's relative loss gap, to stderr."""
    log("loss gaps by step: " + ", ".join(
        f"{abs(p - r) / abs(r):.3g}" for p, r in zip(program, reference)))


def log_worst(name: str, program: Dict[str, float],
              reference: Dict[str, float], n: int = 3) -> None:
    """The leaves that set a leaf gap, to stderr."""
    gaps = compare.leaf_gaps(program, reference)
    log(f"{name}: {len(gaps)} leaves, median reference norm "
        f"{statistics.median(reference.values()):.6g}, median gap "
        f"{statistics.median(gaps.values()):.4g}")
    log(f"{name}: worst leaves " + ", ".join(
        f"{k} {g:.4g} (program {program[k]:.6g}, reference "
        f"{reference[k]:.6g})" for k, g in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:n]))
