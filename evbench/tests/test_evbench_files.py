"""Every configuration, workload and metric that BENCHMARK.json names has
its file, and each file is complete; a cell is added by adding files and
an entry, with no edit to a file that is there."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from evbench import common

BENCH = common.benchmark()
TRAFFIC_KEYS = {"why", "count", "seconds", "phonemes_per_second",
                "language", "batch_size", "sources"}


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in
                                  common.metrics_for_e2e(BENCH, w)}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_keep_the_contract(kind):
    for entry in BENCH[kind]:
        assert set(entry) - {"workloads"} == KEYS[kind], entry
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in \
                    entry[key] and "\t" not in entry[key]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in (
                "lower", "higher")
    assert json.dumps(BENCH).__len__() < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_complete(cfg):
    data = common.load_json(os.path.join(common.ROOT, cfg["file"]))
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    for key in ("driver", "compute_dtype", "check", "trace_steps",
                "assumed"):
        assert key in data, key
    assert os.path.exists(os.path.join(common.HERE, "drivers",
                                       data["driver"] + ".py"))
    limits = data["check"]["limits"]
    assert limits and set(limits) <= {"loss_gap", "grad_gap", "change_gap"}
    assert all(0 < v < 1 for v in limits.values())


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_file_complete(cell):
    traffic = common.traffic_file(cell["traffic"])
    assert TRAFFIC_KEYS <= set(traffic)
    # every distribution says where it comes from, or that it is assumed
    assert {"seconds", "phonemes_per_second", "batch_size"} <= set(
        traffic["sources"])
    assert cell["chips"] == 1
    assert common.metrics_of(BENCH, "per_layer", cell["name"])
    e2e = {m["name"] for m in common.metrics_of(BENCH, "end_to_end",
                                                cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_exists(metric):
    mod = common.load_module(os.path.join(common.HERE, "metrics",
                                          metric["name"] + ".py"),
                             "t_" + metric["name"].replace(".", "_"))
    assert callable(mod.read)


def test_cell_added_by_files_alone(tmp_path):
    """A copy of the benchmark with one traffic file and one BENCHMARK.json
    entry added finds the new cell, its traffic and its metrics."""
    root = tmp_path / "checkout"
    shutil.copytree(common.HERE, root / "evbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    new = dict(common.traffic_file("s1_sliced_b32"), count=64,
               why="a test's own mix")
    (root / "evbench" / "workloads" / "s1_test_mix.json").write_text(
        json.dumps(new))
    bench["workloads"].append({"name": "s1_test_cell", "config": "gpt_s1_v2",
                               "traffic": "s1_test_mix", "chips": 1,
                               "why": "added by a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "s1_long_b32" in m.get("workloads", []):
            m["workloads"].append("s1_test_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from evbench import common, traffic;"
            "b = common.benchmark(); c = common.cell(b, 's1_test_cell');"
            "t = common.traffic_file(c['traffic']);"
            "print(len(traffic.items(t, 7)),"
            " sorted(m['name'] for m in common.metrics_of("
            "b, 'per_layer', 's1_test_cell')))")
    out = subprocess.run([sys.executable, "-c", code, str(root)],
                         capture_output=True, text=True, check=True,
                         cwd=str(root)).stdout
    assert out.startswith("64 ")
    assert "k1_roofline" in out and "s1_mfu" in out


def test_run_refuses_a_bare_checkout(tmp_path):
    """A directory holding only BENCHMARK.json and evbench/ has no program
    to run: the run exits with an error and prints no result."""
    shutil.copytree(common.HERE, tmp_path / "evbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "evbench/run.py", "--workload", "s1_long_b32",
         "--seed", "1", "--seconds", "1"], cwd=str(tmp_path),
        capture_output=True, text=True)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
