"""Voice-clone service on the PyTorch TTS (JAX: service/voice.py).

Resolves named models from the project's trained-model dirs, runs the TTS
pipeline, concatenates fragments and writes ``voice_<timestamp>.wav`` to the
task's output dir.  ``session_manager`` is any object with
``update_session_info(uuid, info)`` and
``end_session_with_response(uuid, response)``, such as the JAX package's
``service.session.SessionManager``.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from ..inference.tts import TTS, InferenceTaskData, TTSConfig
from ..utils import audio_io
from ..utils.response import EaseVoiceResponse, ResponseStatus


def generate_random_name() -> str:
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")


def _list_models(root: str, suffix: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    base = Path(root)
    if not base.is_dir():
        return out
    for sub in base.iterdir():
        if not sub.is_dir():
            continue
        for f in sub.glob(f"*{suffix}"):
            out[f.name] = str(f)
    return out


def list_train_gpts(project_dir: str) -> Dict[str, str]:
    return _list_models(os.path.join(project_dir, "models", "gpt_train"),
                        ".ckpt")


def list_train_sovits(project_dir: str) -> Dict[str, str]:
    return _list_models(os.path.join(project_dir, "models", "sovits_train"),
                        ".pth")


class VoiceCloneService:
    def __init__(self, session_manager: Any, tts: Optional[TTS] = None):
        self.session_manager = session_manager
        self._tts = tts

    @property
    def tts(self) -> TTS:
        if self._tts is None:
            self._tts = TTS(TTSConfig())
        return self._tts

    def clone(self, uuid: str, params: dict) -> EaseVoiceResponse:
        known = {f.name for f in dataclasses.fields(InferenceTaskData)}
        project_dir = params.get("project_dir", "")
        task = InferenceTaskData(
            **{k: v for k, v in params.items() if k in known})
        self._resolve_model_paths(task, project_dir)

        self.session_manager.update_session_info(
            uuid, {"message": "voice clone started"})
        if task.sovits_path:
            self.tts.init_vits_weights(task.sovits_path)
        if task.gpt_path:
            self.tts.init_t2s_weights(task.gpt_path)

        items = list(self.tts.run(task))
        self.session_manager.update_session_info(
            uuid, {"message": "voice clone completed, start to write audio"})

        sampling_rate = items[0][0]
        data = np.concatenate([audio for _, audio in items])
        os.makedirs(task.output_dir or ".", exist_ok=True)
        path = os.path.join(task.output_dir or ".",
                            f"voice_{generate_random_name()}.wav")
        audio_io.write_wav(path, data, sampling_rate)
        result = EaseVoiceResponse(
            ResponseStatus.SUCCESS, "Voice cloned successfully",
            {"sampling_rate": sampling_rate, "output_path": path,
             "actual_seed": getattr(self.tts, "last_seed", None)})
        self.session_manager.end_session_with_response(uuid, result)
        return result

    @staticmethod
    def _resolve_model_paths(task: InferenceTaskData,
                             project_dir: str) -> None:
        if task.gpt_path == "default":
            task.gpt_path = ""
        if task.sovits_path == "default":
            task.sovits_path = ""
        if task.gpt_path and not os.path.exists(task.gpt_path):
            gpts = list_train_gpts(project_dir)
            if task.gpt_path not in gpts:
                raise ValueError(
                    f"failed to find gpt model for {task.gpt_path}")
            task.gpt_path = gpts[task.gpt_path]
        if task.sovits_path and not os.path.exists(task.sovits_path):
            sovits = list_train_sovits(project_dir)
            if task.sovits_path not in sovits:
                raise ValueError(
                    f"failed to find sovits model for {task.sovits_path}")
            task.sovits_path = sovits[task.sovits_path]
