"""Audio preparation service (JAX: service/audio.py AudioService): the
slicer, the denoise stage and the refinement list, with the JAX package's
artifact contract:

  slices/                   <- {name}_{start:010d}_{end:010d}.wav @32k int16
  denoises/                 <- denoised slices (16 kHz with FRCRN)
  asrs/asr.list             <- path|lang|text
  refinements/refinement.list

Vocal separation (``uvr5``) and ASR (``asr``) wait for their nets.  The
denoiser runs on the service's device: the card unless the caller asks for
the CPU.  ``EASEVOICE_ALLOW_PASSTHROUGH=1`` copies the slices unmodified
where no denoise backend can be built, and the response says so.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import traceback
from typing import Dict, List

import numpy as np

from ..audiokit.refinement import Refinement
from ..audiokit.slicer import Slicer
from ..utils import audio_io
from ..utils.device import resolve_device
from ..utils.logger import logger
from ..utils.paths import (
    ACCOMPANIMENTS_OUTPUT, ASR_FILE, ASRS_OUTPUT, DENOISES_OUTPUT,
    REFINEMENT_FILE, REFINEMENTS_OUTPUT, SLICES_OUTPUT, VOCALS_OUTPUT)
from ..utils.response import EaseVoiceResponse, ResponseStatus

AUDIO_EXTS = ("wav", "flac", "mp3", "m4a")


def _passthrough_allowed() -> bool:
    return os.environ.get("EASEVOICE_ALLOW_PASSTHROUGH", "0") == "1"


class AudioService:
    def __init__(self, source_dir: str, output_dir: str, device="cuda"):
        self.device = resolve_device(device, "AudioService")
        self.source_dir = source_dir
        self.output_dir = output_dir
        self.refinement = Refinement(
            os.path.join(output_dir, ASRS_OUTPUT, ASR_FILE),
            os.path.join(output_dir, REFINEMENTS_OUTPUT, REFINEMENT_FILE))

    # ---- slicer ---------------------------------------------------------------

    def slicer(self, threshold: int = -34, min_length: int = 4000,
               min_interval: int = 300, hop_size: int = 10,
               max_silent_kept: int = 500, normalize_max: float = 0.9,
               alpha_mix: float = 0.25, **_kwargs) -> EaseVoiceResponse:
        out_dir = os.path.join(self.output_dir, SLICES_OUTPUT)
        os.makedirs(out_dir, exist_ok=True)
        files = self._get_files(VOCALS_OUTPUT) + self._get_files(
            ACCOMPANIMENTS_OUTPUT)
        if not files:  # also allow slicing straight from the source dir
            files = self._source_files()
        slicer = Slicer(sr=32000, threshold=int(threshold),
                        min_length=int(min_length),
                        min_interval=int(min_interval),
                        hop_size=int(hop_size),
                        max_sil_kept=int(max_silent_kept))
        data: Dict[str, str] = {}
        for path in files:
            name = os.path.basename(path).split(".")[0]
            try:
                audio = audio_io.load_audio(path, 32000)
                if audio.shape[0] == 0:
                    continue
                for chunk, start, end in slicer.slice(audio):
                    peak = np.abs(chunk).max()
                    if peak > 1:
                        chunk = chunk / peak
                    if peak > 0:
                        chunk = (chunk / peak * (normalize_max * alpha_mix)
                                 + (1 - alpha_mix) * chunk)
                    out = os.path.join(out_dir,
                                       "%s_%010d_%010d.wav" % (name, start, end))
                    audio_io.write_wav(out, chunk, 32000)
                data[name] = ResponseStatus.SUCCESS
            except Exception:
                logger.error("slice failed for %s\n%s", path,
                             traceback.format_exc())
                data[name] = ResponseStatus.FAILED
        return EaseVoiceResponse(ResponseStatus.SUCCESS, "Slice Success", data)

    # ---- denoise ---------------------------------------------------------------

    def denoise(self, **_kwargs) -> EaseVoiceResponse:
        out_dir = os.path.join(self.output_dir, DENOISES_OUTPUT)
        os.makedirs(out_dir, exist_ok=True)
        trace: Dict[str, str] = {}
        files = self._get_files(SLICES_OUTPUT)
        denoiser = self._load_denoiser(self.device)
        if denoiser is None and not _passthrough_allowed():
            return EaseVoiceResponse(
                ResponseStatus.FAILED,
                "denoise backend unavailable (FRCRN weights not present)")
        for path in files:
            base = os.path.basename(path)
            out = os.path.join(out_dir, base)
            try:
                if denoiser is None:
                    shutil.copyfile(path, out)
                else:
                    denoiser.denoise(path, out)
                trace[path] = ResponseStatus.SUCCESS
            except Exception:
                logger.error("denoise failed for %s\n%s", path,
                             traceback.format_exc())
                trace[path] = ResponseStatus.FAILED
        if denoiser is None:
            return EaseVoiceResponse(
                ResponseStatus.SUCCESS,
                "denoise passthrough: backend unavailable; files copied "
                "unmodified", trace)
        # which model actually ran (frcrn-torch / spectral-gate); reported
        # in the message so the trace stays a pure per-file map
        return EaseVoiceResponse(
            ResponseStatus.SUCCESS,
            f"Denoise Success (backend: {denoiser.backend})", trace)

    @staticmethod
    def _load_denoiser(device):
        """The Denoise backend on ``device``, or None where its module does
        not import.  A checkpoint that does not load, or a card that is not
        there, raises."""
        try:
            from ..audiokit.denoise import Denoise
        except ImportError:
            logger.error("denoise backend import failed\n%s",
                         traceback.format_exc())
            return None
        return Denoise(device)

    # ---- refinement -------------------------------------------------------------

    def refinement_load_source(self) -> EaseVoiceResponse:
        os.makedirs(os.path.join(self.output_dir, REFINEMENTS_OUTPUT),
                    exist_ok=True)
        if not self.refinement.source_file_content:
            self.refinement.load_text()
        data = {k: dataclasses.asdict(v)
                for k, v in self.refinement.source_file_content.items()}
        return EaseVoiceResponse(ResponseStatus.SUCCESS,
                                 "Load Source Success", data)

    def refinement_reload_source(self) -> EaseVoiceResponse:
        try:
            self.refinement.reload_text()
            data = {k: dataclasses.asdict(v)
                    for k, v in self.refinement.source_file_content.items()}
            return EaseVoiceResponse(ResponseStatus.SUCCESS,
                                     "Reload Source Success", data)
        except Exception as e:
            return EaseVoiceResponse(ResponseStatus.FAILED,
                                     "Reload Source Failed",
                                     {"error": str(e)})

    def refinement_submit_text(self, source_file_path: str, language: str,
                               text_content: str) -> EaseVoiceResponse:
        self.refinement.submit_text(source_file_path, language.lower(),
                                    text_content)
        data = {k: dataclasses.asdict(v)
                for k, v in self.refinement.source_file_content.items()}
        return EaseVoiceResponse(ResponseStatus.SUCCESS,
                                 "Submit Text Success", data)

    def refinement_delete_text(self, source_file_path: str) -> EaseVoiceResponse:
        self.refinement.delete_text(source_file_path)
        data = {k: dataclasses.asdict(v)
                for k, v in self.refinement.source_file_content.items()}
        return EaseVoiceResponse(ResponseStatus.SUCCESS,
                                 "Delete Text Success", data)

    # ---- helpers ------------------------------------------------------------------

    def _get_files(self, subdir: str) -> List[str]:
        root = os.path.join(self.output_dir, subdir)
        if not os.path.isdir(root):
            return []
        return [os.path.join(root, n) for n in sorted(os.listdir(root))
                if os.path.isfile(os.path.join(root, n))
                and n.split(".")[-1] in AUDIO_EXTS]

    def _source_files(self) -> List[str]:
        if not os.path.isdir(self.source_dir):
            return []
        return [os.path.join(self.source_dir, n)
                for n in sorted(os.listdir(self.source_dir))
                if os.path.isfile(os.path.join(self.source_dir, n))
                and n.split(".")[-1] in AUDIO_EXTS]
