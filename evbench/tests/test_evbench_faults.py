"""The check catches what it is for: a sound run comes out correct, a run
whose timed path is broken underneath does not, and the reference computed
in the precision below the configuration's, in the program's place, reads
well above the program.  CPU runs at a test's size; the harness's look for
a card is skipped by calling ``run.run`` on the CPU."""
import importlib
import json

import pytest

from evbench import calibrate, common, run


def _run(cfg, traffic, cell_name, driver):
    bench = common.benchmark()
    line, rc = run.run(bench, common.cell(bench, cell_name), cfg, traffic,
                       2 ** 40 + 9, 0.5, False, device="cpu",
                       driver_module=importlib.import_module(
                           "evbench.drivers." + driver))
    assert rc == 0
    return json.loads(line)


def _s1_state_unchanged(monkeypatch):
    from easevoice_trainer_tpu_torch.train import scaled_adam

    monkeypatch.setattr(scaled_adam.ScaledAdam, "step",
                        lambda self, closure=None: None)


def _s1_half_batch(monkeypatch):
    from easevoice_trainer_tpu_torch.train import gpt_step

    loss = gpt_step.GPTTrainStep.loss

    def half(self, batch, seed=None, rows=None):
        n = batch["phoneme_ids"].shape[0] // 2
        out_loss, out = loss(self, {k: v[:n] for k, v in batch.items()},
                             seed, rows)
        return out_loss * 2.0, out
    monkeypatch.setattr(gpt_step.GPTTrainStep, "loss", half)


def _s2_state_unchanged(monkeypatch):
    from easevoice_trainer_tpu_torch.train import optim_lowp

    monkeypatch.setattr(optim_lowp.AdamWLowp, "step", lambda self: None)


def _s2_half_batch(monkeypatch):
    from easevoice_trainer_tpu_torch.train import sovits_step

    call = sovits_step.S2TrainStep.__call__

    def half(self, batch, generator=None, ids_slice=None, eps=None,
             rows=None):
        n = batch["ssl"].shape[0] // 2
        return call(self, {k: v[:n] for k, v in batch.items()}, generator,
                    ids_slice[:n], eps[:n], rows)
    monkeypatch.setattr(sovits_step.S2TrainStep, "__call__", half)


def _cell(which, tiny_s1, tiny_s2):
    """(configuration, traffic, cell, driver) at a test's size.  s2 runs
    fp32 here: at this width its bf16 first step leaves the whole decoder
    with a zero gradient on the CPU (at the cell's size on the card it is
    sound), so every bf16 run reads not correct and proves nothing."""
    if which == "s1":
        return (*tiny_s1, "s1_long_b32", "gpt_s1")
    cfg, traffic = tiny_s2
    return dict(cfg, compute_dtype="float32"), traffic, "s2_sliced_b32", \
        "sovits_s2"


@pytest.mark.parametrize("which", ["s1", "s2"])
def test_sound_run_is_correct(which, tiny_s1, tiny_s2):
    cfg, traffic, cell, driver = _cell(which, tiny_s1, tiny_s2)
    out = _run(cfg, traffic, cell, driver)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_s1_state_unchanged, _s1_half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_s1_fault_is_not_correct(fault, tiny_s1, tiny_s2, monkeypatch):
    cfg, traffic, cell, driver = _cell("s1", tiny_s1, tiny_s2)
    fault(monkeypatch)
    out = _run(cfg, traffic, cell, driver)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_s2_state_unchanged, _s2_half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_s2_fault_is_not_correct(fault, tiny_s1, tiny_s2, monkeypatch):
    cfg, traffic, cell, driver = _cell("s2", tiny_s1, tiny_s2)
    fault(monkeypatch)
    out = _run(cfg, traffic, cell, driver)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("which", ["s1", "s2"])
def test_control_in_lower_precision_is_not_correct(which, tiny_s1, tiny_s2):
    cfg, traffic, _, driver = _cell(which, tiny_s1, tiny_s2)
    readings = dict(calibrate.readings(
        importlib.import_module("evbench.drivers." + driver), cfg, traffic,
        2 ** 40 + 21, "cpu", control=True))
    limits = cfg["check"]["limits"]
    # at a test's size the gaps are smaller than at the cell's, where the
    # limits were set (the card's test holds the control to them); here
    # the control and the fault read three times the program or more on
    # a compared number
    program = readings["program"]
    for kind in ("control", "half_batch"):
        assert any(readings[kind][k] >= 3 * program[k] for k in limits), \
            (kind, readings)
