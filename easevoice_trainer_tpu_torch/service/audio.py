"""Audio preparation service (JAX: service/audio.py AudioService): the
slicer, the denoise stage, ASR and the refinement list, with the JAX
package's artifact contract:

  slices/                   <- {name}_{start:010d}_{end:010d}.wav @32k int16
  denoises/                 <- denoised slices (16 kHz with FRCRN)
  asrs/asr.list             <- path|lang|text
  refinements/refinement.list

Vocal separation (``uvr5``) waits for its nets.  The denoiser and the ASR
nets run on the service's device: the card unless the caller asks for the
CPU.  ``EASEVOICE_ALLOW_PASSTHROUGH=1`` copies the slices unmodified where
no denoise backend can be built, and writes empty transcripts where no ASR
model directory exists; the response says so.

ASR: for ``zh``, fsmn-VAD -> Paraformer-large -> CT-punc
(``EASEVOICE_PARAFORMER_DIR``, ``EASEVOICE_VAD_DIR``, ``EASEVOICE_PUNC_DIR``,
by default ``<base>/models/asr/{paraformer-zh,fsmn-vad,ct-punc}``; the VAD and
the punctuation are each left out where their directory holds no
checkpoint), and Whisper for the other languages, or for zh without a
Paraformer (``EASEVOICE_WHISPER_DIR``, by default ``<base>/models/whisper``).
Two differences from the JAX service, on purpose: it tries no external
backend first (``faster_whisper``, ``funasr``: packages of finished models,
whatever ``asr_model`` says), and a checkpoint that is present but does not
load raises, where the JAX loaders log it and quietly drop the VAD or the
punctuation, or fall through to Whisper.
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
from ..utils import audio_io, paths
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

    # ---- ASR -----------------------------------------------------------------

    def asr(self, asr_model: str = "funasr", model_size: str = "large",
            language: str = "zh", precision: str = "float32",
            **_kwargs) -> EaseVoiceResponse:
        """Transcribe every denoised clip into ``asrs/asr.list`` and the
        refinement dump, ``path|lang|text`` a line.  ``asr_model``,
        ``model_size`` and ``precision`` name external backends, which the
        port does not have: the route is chosen by ``language``."""
        files = self._get_files(DENOISES_OUTPUT)
        output_file = os.path.join(self.output_dir, ASRS_OUTPUT, ASR_FILE)
        dump_file = os.path.join(self.output_dir, REFINEMENTS_OUTPUT,
                                 REFINEMENT_FILE)
        os.makedirs(os.path.dirname(output_file), exist_ok=True)
        os.makedirs(os.path.dirname(dump_file), exist_ok=True)

        recognize = self._load_asr(language, self.device)
        if recognize is None and not _passthrough_allowed():
            return EaseVoiceResponse(
                ResponseStatus.FAILED,
                f"ASR backend '{asr_model}' unavailable in this environment")

        lines: List[str] = []
        trace: Dict[str, str] = {}
        for path in files:
            try:
                text = recognize(path) if recognize else ""
                lines.append(f"{path}|{language.lower()}|{text}")
                trace[path] = ResponseStatus.SUCCESS
            except Exception:
                logger.error("asr failed for %s\n%s", path,
                             traceback.format_exc())
                trace[path] = ResponseStatus.FAILED
        for target in (output_file, dump_file):
            with open(target, "w", encoding="utf-8") as f:
                f.write("\n".join(lines))
        if recognize is None:
            # passthrough must be visible to the caller, not silent
            return EaseVoiceResponse(
                ResponseStatus.SUCCESS,
                "asr passthrough: no ASR backend available; empty "
                "transcripts written (set EASEVOICE_WHISPER_DIR or install "
                "an ASR backend)", trace)
        return EaseVoiceResponse(ResponseStatus.SUCCESS, "asr success", trace)

    @staticmethod
    def _load_asr(language: str, device):
        """The zh chain for zh where a Paraformer checkpoint exists, else
        Whisper; None where neither has a checkpoint."""
        if language == "zh":
            recognize = AudioService._load_paraformer(device)
            if recognize is not None:
                return recognize
        return AudioService._load_whisper(language, device)

    @staticmethod
    def _load_paraformer(device):
        """fsmn-VAD segmentation -> Paraformer transcription -> CT-Transformer
        punctuation (the reference FunASR pipeline); None without a
        Paraformer checkpoint, and no VAD / punctuation stage without
        theirs."""
        from ..audiokit.asr_paraformer import SAMPLE_RATE, ParaformerASR
        from ..audiokit.punc_ct import CTPunc
        from ..audiokit.vad_fsmn import FsmnVAD

        base = paths.get_base_path()

        def model_dir(env: str, name: str) -> str:
            return os.environ.get(env) or os.path.join(base, "models", "asr",
                                                       name)

        asr = ParaformerASR(model_dir("EASEVOICE_PARAFORMER_DIR",
                                      "paraformer-zh"), device)
        if not asr.available:
            return None
        vad = FsmnVAD(model_dir("EASEVOICE_VAD_DIR", "fsmn-vad"), device)
        punc = CTPunc(model_dir("EASEVOICE_PUNC_DIR", "ct-punc"), device)

        def recognize(path: str) -> str:
            wav = audio_io.load_audio(path, SAMPLE_RATE, mono=True)
            if vad.available:
                segs = vad.segments(wav)
                text = "".join(asr.transcribe(wav[s:e]) for s, e in segs)
            else:
                text = asr.transcribe(wav)
            if punc.available and text:
                text = punc.restore(text)
            return text

        return recognize

    @staticmethod
    def _load_whisper(language: str, device):
        from ..audiokit.asr_whisper import WhisperASR

        model_dir = os.environ.get("EASEVOICE_WHISPER_DIR") or os.path.join(
            paths.get_base_path(), "models", "whisper")
        asr = WhisperASR(model_dir, device)
        if not asr.available:
            return None
        lang = None if language == "auto" else language
        return lambda path: asr.transcribe(path, lang)

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
