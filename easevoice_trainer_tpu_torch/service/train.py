"""Thin training-service wrapper (JAX: service/train.py)."""
from __future__ import annotations

from ..train.gpt import GPTTrain, GPTTrainParams
from ..utils.response import EaseVoiceResponse


class TrainGPTService:
    def do_train_gpt(self, params: GPTTrainParams) -> EaseVoiceResponse:
        return GPTTrain(params).train()
