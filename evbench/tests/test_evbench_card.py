"""On the card: a short run of a cell is correct, and the reference in
the precision below the configuration's, put in the program's place at
the cell's own size, is not.  Skips on a machine without a card."""
import json
import subprocess
import sys

import pytest

from evbench import common

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["s1_sliced_b32", "s2_sliced_b32"])
def test_short_run_is_correct(cell, card):
    proc = subprocess.run(
        [sys.executable, "evbench/run.py", "--workload", cell, "--seed",
         str(2 ** 40 + 77), "--seconds", "3", "--trace", "0"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["s1_sliced_b32", "s2_sliced_b32"])
def test_control_at_the_cells_size_is_not_correct(cell, card):
    proc = subprocess.run(
        [sys.executable, "evbench/calibrate.py", "--workload", cell,
         "--seeds", "5", "--control-seeds", "5"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = {r["kind"]: r for r in map(json.loads,
                                      proc.stdout.strip().splitlines())}
    bench = common.benchmark()
    limits = common.config_file(bench, common.cell(bench, cell)["config"])[
        "check"]["limits"]
    assert all(rows["program"][k] <= limits[k] for k in limits), rows
    assert any(rows["control"][k] > limits[k] for k in limits), rows
