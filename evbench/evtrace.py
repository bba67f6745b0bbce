"""The traced block of a ``--trace 1`` run: a few steps under
``torch.profiler``, read back from its Chrome trace.

A profiler session on that machine has been seen to drop the first few
device records it should hold, and now and then all of them.  So a session
first launches a few warm-up kernels outside the window, and then the count
of the program's own kernels in the window is checked against the program's
launch counters over the same steps; a session short of any is taken again,
up to ``attempts`` in all, and where none is whole the block gives no trace
(its readers then report nothing).

Which kernels are the program's own, and which launch counter counts each,
is the table in ``kernels/``: a file ``<group>.json`` (or
``<group>.<anything>.json``, which adds to the group) holds the counters of
``ops.launch_counts()`` that the group's kernels count in and a regex of
their names.  Only counters that the table names are compared, so a kernel
that a later change adds, and the table does not name, is ignored; a
renamed one is named by a file added beside the group's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

KERNEL_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "kernels")

WINDOW_SPAN = "evbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class Trace:
    """What one whole session recorded inside the window (times in s)."""

    window: Tuple[float, float]
    kernels: List[Tuple[str, float, float]]     # (name, start, duration)
    device: List[Tuple[str, float, float]]      # kernels, copies, sets
    host: List[Tuple[str, float, float]]        # host ops and spans
    steps: List[dict]                           # the steps' records

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        spans = sorted((s, s + d) for _, s, d in self.device)
        busy, end = 0.0, self.window[0]
        for s, e in spans:
            s, e = max(s, end), min(e, self.window[1])
            if e > s:
                busy += e - s
                end = e
        return busy

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(d for n, _, d in self.kernels if rx.search(n))

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, _, d in self.device:
            by[name] = by.get(name, 0.0) + d
        return [[k[:200], v] for k, v in sorted(by.items(),
                                                key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest stretches with no device operation, each named by
        the innermost host op or span running at its middle."""
        spans = sorted((s, s + d) for _, s, d in self.device)
        gaps, end = [], self.window[0]
        for s, e in spans:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            inside = [(d, name) for name, s, d in self.host
                      if s <= mid <= s + d and name != WINDOW_SPAN]
            label = min(inside)[1] if inside else "no host op"
            out.append([label[:200], b - a])
        return out


def kernel_groups(table: str = KERNEL_TABLE) -> Dict[str, dict]:
    """{group: {"counters": set of launch counters, "kernels": regex}}: the
    files of ``table``, a group's files joined (their regexes as
    alternatives)."""
    groups: Dict[str, dict] = {}
    for fname in sorted(os.listdir(table)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(table, fname), encoding="utf8") as f:
            entry = json.load(f)
        g = groups.setdefault(fname.split(".")[0],
                              {"counters": set(), "patterns": []})
        g["counters"].update(entry["counters"])
        g["patterns"].append(entry["kernels"])
    return {name: {"counters": g["counters"],
                   "kernels": "|".join(f"(?:{p})" for p in g["patterns"])}
            for name, g in groups.items()}


def kernels_of(*names: str, table: str = KERNEL_TABLE) -> str:
    """The regex of the kernels of the named groups (all groups: none
    named)."""
    groups = kernel_groups(table)
    return "|".join(f"(?:{groups[n]['kernels']})"
                    for n in (names or sorted(groups)))


def counted_launches(counts: Dict[str, int],
                     table: str = KERNEL_TABLE) -> int:
    """The launches of ``ops.launch_counts()`` under the table's counters."""
    named = set().union(*(g["counters"]
                          for g in kernel_groups(table).values()))
    return sum(v for k, v in counts.items() if k in named)


def _read(path: str, steps: List[dict]) -> Optional[Trace]:
    with open(path, encoding="utf8") as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW_SPAN]
    if not win:
        return None
    w0 = float(win[0]["ts"]) * 1e-6
    w1 = w0 + float(win[0]["dur"]) * 1e-6
    device, kernels, host = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        cat = e.get("cat", "")
        if cat in DEVICE_CATS and w0 <= s <= w1:
            device.append((e["name"], s, d))
            if cat == "kernel":
                kernels.append((e["name"], s, d))
        elif cat in HOST_CATS and s + d >= w0 and s <= w1:
            host.append((e["name"], s, d))
    return Trace((w0, w1), kernels, device, host, steps)


def traced_block(torch, run_steps: Callable[[], List[dict]],
                 launches: Callable[[], int], own_kernels: str,
                 attempts: int = 3, log=print,
                 device: str = "cuda") -> Optional[Trace]:
    """Profiles ``run_steps`` (which runs the steps, synchronises and
    returns their records) inside the window span; ``launches()`` reads
    the program's launch counters, and ``own_kernels`` is a regex of its
    kernels' names."""
    from torch.profiler import ProfilerActivity, profile, record_function

    rx = re.compile(own_kernels)
    for attempt in range(1, attempts + 1):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                warm = torch.zeros(1024, device=device)
                for _ in range(32):
                    warm += 1.0
                if device == "cuda":
                    torch.cuda.synchronize()
                before = launches()
                with record_function(WINDOW_SPAN):
                    steps = run_steps()
                launched = launches() - before
            prof.export_chrome_trace(path)
            trace = _read(path, steps)
        seen = 0 if trace is None else sum(
            1 for n, _, _ in trace.kernels if rx.search(n))
        if trace is not None and seen == launched and (
                trace.device or device != "cuda"):
            return trace
        log(f"trace session {attempt} of {attempts}: {seen} of the "
            f"program's {launched} kernel launches recorded")
    return None
