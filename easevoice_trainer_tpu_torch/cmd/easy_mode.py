"""cmd: one-click pipeline — uvr5 -> slice -> denoise -> asr -> normalize ->
s2 train -> s1 train (JAX: cmd/easy_mode.py), on the params' device (one
CUDA card unless they name ``"device": "cpu"``).

The audio stages and the normalization run in this process; the training
steps run as nested subprocesses (the port's train cmds, given the same
device), whose connector streams are consumed here: their losses are
forwarded and their final responses checked.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

from . import run_task
from ..utils.connector import ConnectorDataType, MultiProcessOutputConnector
from ..utils.response import EaseVoiceResponse, ResponseStatus

_connector = MultiProcessOutputConnector()


class _StepFailed(Exception):
    pass


def _check(resp: EaseVoiceResponse, step_name: str, step: int) -> None:
    _connector.write_session_data({"current_step": step})
    if resp.status == ResponseStatus.FAILED:
        _connector.write_session_data({
            "current_step_description": f"{step_name} failed: {resp.message}",
        })
        raise _StepFailed(f"{step_name} failed: {resp.message}")
    _connector.write_session_data({
        "current_step_description": f"{step_name} completed successfully",
        "progress": step / 7 * 100,
    })


def _run_train(module: str, request) -> EaseVoiceResponse:
    with tempfile.NamedTemporaryFile(mode="w+", encoding="utf-8",
                                     suffix=".json", delete=False) as fp:
        json.dump(dataclasses.asdict(request), fp)
        path = fp.name
    proc = subprocess.Popen(
        [sys.executable, "-m", f"easevoice_trainer_tpu_torch.cmd.{module}",
         "-c", path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    connector = MultiProcessOutputConnector()
    for data in connector.read_data(proc):
        if data.dataType == ConnectorDataType.RESP:
            return data.response
        if data.dataType == ConnectorDataType.LOSS:
            _connector.write_loss(data.loss.step, data.loss.loss,
                                  data.loss.other)
    return EaseVoiceResponse(ResponseStatus.FAILED, "Unknown error")


def main(params: dict) -> EaseVoiceResponse:
    from ..normalization import random_choice
    from ..service.audio import AudioService
    from ..service.normalize import NormalizeService
    from ..train.gpt import GPTTrainParams
    from ..train.sovits import SovitsTrainParams

    source_dir = params["source_dir"]
    project_dir = params.get("project_dir", "")
    device = params.get("device", "cuda")
    _connector.write_session_data({
        "total_steps": 7, "current_step": 0, "progress": 0,
        "current_step_description": "Prepare for starting EaseVoice",
    })
    output_dir = os.path.join(source_dir, f"easy_mode_{random_choice()}")
    os.makedirs(output_dir, exist_ok=True)

    audio = AudioService(source_dir=source_dir, output_dir=output_dir,
                         device=device)
    _check(audio.uvr5(), "Audio UVR5", 1)
    _check(audio.slicer(), "Audio Slicer", 2)
    _check(audio.denoise(), "Audio Denoise", 3)
    _check(audio.asr(), "Audio ASR", 4)

    norm = NormalizeService(processing_path=output_dir, device=device)
    resp = norm.run()
    _check(resp, "Normalization", 5)
    normalize_path = resp.data["output_path"]

    sovits_params = SovitsTrainParams(
        train_input_dir=normalize_path,
        output_model_name=params.get("sovits_output_name", ""),
        project_dir=project_dir, device=device)
    sovits_resp = _run_train("train_sovits", sovits_params)
    _check(sovits_resp, "Sovits Training", 6)

    gpt_params = GPTTrainParams(
        train_input_dir=normalize_path,
        output_model_name=params.get("gpt_output_name", ""),
        project_dir=project_dir, device=device)
    gpt_resp = _run_train("train_gpt", gpt_params)
    _check(gpt_resp, "GPT Training", 7)

    return EaseVoiceResponse(
        ResponseStatus.SUCCESS, "Training GPT completed successfully",
        data={"sovits_output": sovits_resp.data["model_path"],
              "gpt_output": gpt_resp.data["model_path"]})


if __name__ == "__main__":
    run_task(main)
