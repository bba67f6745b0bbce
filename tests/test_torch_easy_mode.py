"""The port's one-click pipeline (``cmd/easy_mode.py``) against the JAX
package's, under the stubs of tests/test_easy_mode.py: each stage a stub,
so the orchestration is held hermetically (step order, the session-data
lines and their order, the forwarded losses, the final response, and
fail-fast).  The port's stubs also record the device each stage was given.
Then the port's ``_run_train`` alone: the child it starts is the port's
train cmd, given the params' device, and its losses are forwarded."""
import json
import subprocess
import sys

import pytest

from easevoice_trainer_tpu.cmd import easy_mode as jeasy
from easevoice_trainer_tpu.utils.response import \
    EaseVoiceResponse as JResponse, ResponseStatus as JStatus
from easevoice_trainer_tpu_torch.cmd import easy_mode as peasy
from easevoice_trainer_tpu_torch.train.gpt import GPTTrainParams
from easevoice_trainer_tpu_torch.utils.response import \
    EaseVoiceResponse as PResponse, ResponseStatus as PStatus

PACKAGES = {"jax": (jeasy, "easevoice_trainer_tpu", JResponse, JStatus),
            "port": (peasy, "easevoice_trainer_tpu_torch", PResponse,
                     PStatus)}

STEP_NAMES = {"denoise": "Audio Denoise", "normalize": "Normalization",
              "train_gpt": "GPT Training"}


def _stubs(monkeypatch, name, fail_at=None):
    """Stub AudioService / NormalizeService / _run_train and capture the
    connector's session-data and loss lines, in order."""
    mod, pkg, Response, Status = PACKAGES[name]
    calls, lines = [], []

    def ok(msg="ok", data=None):
        return Response(Status.SUCCESS, msg, data=data or {})

    def stage(step):
        def run(self):
            calls.append((step, self.device))
            if step == fail_at:
                return Response(Status.FAILED, "boom")
            return ok()
        return run

    class Audio:
        def __init__(self, source_dir, output_dir, device="<none>"):
            self.device = device

        uvr5, slicer, denoise, asr = (stage(s) for s in
                                      ("uvr5", "slicer", "denoise", "asr"))

    class Norm:
        def __init__(self, processing_path, device="<none>"):
            self.device = device

        def run(self):
            calls.append(("normalize", self.device))
            if fail_at == "normalize":
                return Response(Status.FAILED, "boom")
            return ok(data={"output_path": "/tmp/normed"})

    def run_train(module, request):
        calls.append((module, getattr(request, "device", "<none>")))
        mod._connector.write_loss(3, 1.5, {"epoch": 1})
        if module == fail_at:
            return Response(Status.FAILED, "boom")
        return ok(data={"model_path": f"/models/{module}"})

    audio_mod = __import__(f"{pkg}.service.audio", fromlist=["x"])
    norm_mod = __import__(f"{pkg}.service.normalize", fromlist=["x"])
    monkeypatch.setattr(audio_mod, "AudioService", Audio)
    monkeypatch.setattr(norm_mod, "NormalizeService", Norm)
    monkeypatch.setattr(mod, "_run_train", run_train)
    monkeypatch.setattr(mod._connector, "write_session_data",
                        lambda d: lines.append(("session", d)))
    monkeypatch.setattr(mod._connector, "write_loss",
                        lambda step, loss, other=None:
                        lines.append(("loss", step, loss, other)))
    return calls, lines


def _run(name, monkeypatch, tmp_path, fail_at=None):
    mod = PACKAGES[name][0]
    calls, lines = _stubs(monkeypatch, name, fail_at)
    params = {"source_dir": str(tmp_path), "project_dir": str(tmp_path),
              "sovits_output_name": "s", "gpt_output_name": "g"}
    if name == "port":
        params["device"] = "cpu"
    try:
        resp = mod.main(params)
        out = (str(resp.status), resp.message, resp.data)
    except mod._StepFailed as e:
        out = ("raised", str(e))
    return out, calls, lines


@pytest.mark.parametrize("fail_at", [None, "denoise", "normalize",
                                     "train_gpt"])
def test_easy_mode_matches_jax(fail_at, monkeypatch, tmp_path):
    want, jcalls, jlines = _run("jax", monkeypatch, tmp_path / "j", fail_at)
    got, pcalls, plines = _run("port", monkeypatch, tmp_path / "p", fail_at)
    assert got == want
    assert plines == jlines
    assert [c for c, _ in pcalls] == [c for c, _ in jcalls]
    # every stage of the port ran on the params' device
    assert {d for _, d in pcalls} == {"cpu"}, pcalls
    if fail_at is None:
        assert [c for c, _ in pcalls] == [
            "uvr5", "slicer", "denoise", "asr", "normalize",
            "train_sovits", "train_gpt"]
        assert [d["progress"] for kind, *rest in plines if kind == "session"
                for d in rest if "progress" in d][-1] == 100.0
    else:
        assert [c for c, _ in pcalls][-1] == fail_at
        step = STEP_NAMES[fail_at]
        assert ("session", {"current_step_description":
                            f"{step} failed: boom"}) in plines


def test_run_train_starts_the_port_cmd(monkeypatch, tmp_path):
    """The child is ``-m easevoice_trainer_tpu_torch.cmd.train_gpt -c
    <params>`` with the request's device; its loss line is forwarded and
    its response returned."""
    seen, lines = {}, []
    popen = subprocess.Popen
    child = ("import sys; print('loss-of-easevoice {\"step\": 10, "
             "\"loss\": 4.0, \"acc\": 0.5}', flush=True); "
             "print('response-of-easevoice {\"status\": \"success\", "
             "\"message\": \"done\", \"data\": {\"model_path\": \"m\"}, "
             "\"uuid\": null}', flush=True)")

    def fake(argv, **kw):
        seen["argv"] = argv
        with open(argv[-1]) as f:
            seen["params"] = json.load(f)
        return popen([sys.executable, "-c", child], **kw)

    monkeypatch.setattr(peasy.subprocess, "Popen", fake)
    monkeypatch.setattr(peasy._connector, "write_loss",
                        lambda *a: lines.append(a))
    resp = peasy._run_train("train_gpt", GPTTrainParams(
        train_input_dir=str(tmp_path), project_dir=str(tmp_path),
        device="cpu"))
    assert resp.ok and resp.data == {"model_path": "m"}
    assert seen["argv"][1:4] == ["-m", "easevoice_trainer_tpu_torch.cmd."
                                 "train_gpt", "-c"]
    assert seen["params"]["device"] == "cpu"
    assert seen["params"]["train_input_dir"] == str(tmp_path)
    assert lines == [(10, 4.0, {"acc": 0.5})]
