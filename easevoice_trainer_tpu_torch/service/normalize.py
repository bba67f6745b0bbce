"""Normalize service (JAX: service/normalize.py): the three stages in
order, stopping at the first failure, on the service's device."""
from __future__ import annotations

import dataclasses

from ..normalization import Normalize
from ..utils.response import EaseVoiceResponse, ResponseStatus


@dataclasses.dataclass
class NormalizeParams:
    processing_path: str = ""
    output_dir: str = ""
    predefined_output_path: str = ""
    device: str = "cuda"         # "cpu" runs the models on the host


class NormalizeService:
    def __init__(self, processing_path: str,
                 predefine_output_path: str = "", device="cuda"):
        self.normalize = Normalize(processing_path, predefine_output_path,
                                   device)

    def run(self) -> EaseVoiceResponse:
        for stage in (self.normalize.text, self.normalize.ssl,
                      self.normalize.token):
            resp = stage()
            if resp.status == ResponseStatus.FAILED:
                return resp
        return EaseVoiceResponse(
            ResponseStatus.SUCCESS, "normalize success",
            {"output_path": self.normalize.output_path})
