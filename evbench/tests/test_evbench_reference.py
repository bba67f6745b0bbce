"""The plain references agree with the port on the CPU, and import
nothing of it."""
import subprocess
import sys

from evbench import common, run


def test_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import evbench.reference.gpt_s1, evbench.reference.sovits_s2;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, common.ROOT],
                         capture_output=True, text=True, check=True).stdout
    for name in ("easevoice_trainer_tpu_torch", "easevoice_trainer_tpu",
                 "jax"):
        assert f"'{name}'" not in out


def _run(cfg, traffic, driver, monkeypatch, limits):
    import importlib

    # fp32 optimizer state, so the port and the reference differ by
    # summation order alone
    monkeypatch.setenv("EASEVOICE_OPT_STATE", "fp32")
    cfg = dict(cfg, compute_dtype="float32")
    cfg["check"] = dict(cfg["check"], limits=limits)
    bench = common.benchmark()
    cell = common.cell(bench, "s1_long_b32" if driver == "gpt_s1"
                       else "s2_sliced_b32")
    line, rc = run.run(bench, cell, cfg, traffic, 2 ** 40 + 3, 0.5, False,
                       device="cpu",
                       driver_module=importlib.import_module(
                           "evbench.drivers." + driver))
    assert rc == 0
    import json

    return json.loads(line)


def test_s1_reference_agrees_with_the_port(tiny_s1, monkeypatch):
    cfg, traffic = tiny_s1
    out = _run(cfg, traffic, "gpt_s1", monkeypatch,
               {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-4})
    assert out["correct"], out["checks"]


def test_s2_reference_agrees_with_the_port(tiny_s2, monkeypatch):
    cfg, traffic = tiny_s2
    out = _run(cfg, traffic, "sovits_s2", monkeypatch,
               {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3})
    assert out["correct"], out["checks"]
