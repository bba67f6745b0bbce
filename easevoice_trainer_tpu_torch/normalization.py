"""Dataset normalization (JAX: normalization.py): text -> BERT features,
audio -> SSL features, SSL features -> semantic tokens, on the
Normalize's device (the card unless the caller asks for the CPU).

The artifacts are the JAX package's, which its trainers and the port's
read alike:

  2-name2text.txt        name\\tphones\\tword2ph\\tnorm_text
  3-bert/{name}.pt       (1024, n_phones) phone-level BERT features (zh)
  4-cnhubert/{name}.pt   (1, 768, T) SSL features
  5-wav32k/{name}        int16 32 kHz audio
  6-name2semantic.tsv    item_name\\tsemantic_audio

Features are saved as contiguous fp32 CPU tensors.  HuBERT reads the
waveform at the 1145.14 amplitude-mix scale, as the reference does.  The
JAX package pads each clip to a 0.5 s bucket (and the token stage's input
to 32 frames) to bound its XLA compiles; here each clip runs at its own
length, and the frames kept are the same.
"""
from __future__ import annotations

import json
import os
import random
import string
import traceback
from typing import List

import numpy as np
import torch

from .utils import audio_io, paths
from .utils.config import GlobalCFG
from .utils.device import resolve_device
from .utils.logger import logger
from .utils.response import EaseVoiceResponse, ResponseStatus


def random_choice(k: int = 8) -> str:
    return "".join(random.choices(string.ascii_lowercase + string.digits,
                                  k=k))


class Normalize:
    MAXX = 0.95
    ALPHA = 0.5

    def __init__(self, processing_path: str, predefine_output_path: str = "",
                 device="cuda"):
        self.device = resolve_device(device, "Normalize")
        self.source_path = processing_path
        self.refinement_list = os.path.join(
            processing_path, paths.REFINEMENTS_OUTPUT, paths.REFINEMENT_FILE)
        self.denoises_dir = os.path.join(processing_path,
                                         paths.DENOISES_OUTPUT)
        out_name = predefine_output_path or random_choice()
        self.output_path = os.path.join(processing_path, out_name)
        os.makedirs(self.output_path, exist_ok=True)
        self.text_output_path = os.path.join(self.output_path,
                                             paths.TEXT_OUTPUT_NAME)
        self.bert_dir = os.path.join(self.output_path, paths.BERT_OUTPUT)
        self.hubert_dir = os.path.join(self.output_path, paths.SSL_OUTPUT)
        self.wav_dir = os.path.join(self.output_path, paths.WAV_OUTPUT)
        self.semantic_output_path = os.path.join(self.output_path,
                                                 paths.SEMANTIC_OUTPUT)
        for d in (self.bert_dir, self.hubert_dir, self.wav_dir):
            os.makedirs(d, exist_ok=True)
        for f in (self.text_output_path, self.semantic_output_path):
            if os.path.exists(f):
                os.remove(f)

        cfg = GlobalCFG()
        self.bert_path = cfg.bert_path
        self.cnhubert_path = cfg.cnhubert_path
        self.s2g_path = cfg.sovits_path

    # ---- helpers -------------------------------------------------------------

    def _read_refinements(self) -> List[List[str]]:
        with open(self.refinement_list, encoding="utf8") as f:
            lines = f.read().strip("\n").split("\n")
        out = []
        for line in lines:
            parts = line.split("|", 2)
            if len(parts) == 3:
                out.append(parts)
        return out

    @staticmethod
    def _save_pt(array: np.ndarray, path: str) -> None:
        torch.save(torch.from_numpy(np.ascontiguousarray(array)), path)

    # ---- stage 1: text ---------------------------------------------------------

    def text(self) -> EaseVoiceResponse:
        from .models.bert import BertFeatureExtractor
        from .text.cleaner import clean_text

        bert = BertFeatureExtractor(self.bert_path, self.device)
        rows = []
        for wav_name, lan, text in self._read_refinements():
            try:
                name = os.path.basename(wav_name.replace("\\", "/"))
                phones, word2ph, norm_text = clean_text(
                    text.replace("%", "-").replace("￥", ","), lan)
                if lan == "zh":
                    path_bert = os.path.join(self.bert_dir, name + ".pt")
                    if not os.path.exists(path_bert):
                        if not bert.available:
                            return EaseVoiceResponse(
                                ResponseStatus.FAILED,
                                f"BERT model unavailable at {self.bert_path}")
                        feature = bert.phone_features(norm_text, word2ph)
                        if feature.shape[-1] != len(phones):
                            return EaseVoiceResponse(
                                ResponseStatus.FAILED,
                                "bert_feature and phones not match")
                        self._save_pt(feature, path_bert)
                rows.append((name, " ".join(phones), word2ph, norm_text))
            except Exception as e:
                # the message names the cause (a missing jieba, say): the
                # session shows it, where the log may not reach the user
                logger.error("text normalize failed for %s\n%s", wav_name,
                             traceback.format_exc())
                return EaseVoiceResponse(
                    ResponseStatus.FAILED,
                    f"failed to process text: {type(e).__name__}: {e}")
        with open(self.text_output_path, "w", encoding="utf8") as f:
            f.write("\n".join("%s\t%s\t%s\t%s" % r for r in rows) + "\n")
        return EaseVoiceResponse(ResponseStatus.SUCCESS, "success")

    # ---- stage 2: ssl ------------------------------------------------------------

    def ssl(self) -> EaseVoiceResponse:
        from .models.cnhubert import load_cnhubert

        model = load_cnhubert(self.cnhubert_path, self.device)
        if model is None:
            return EaseVoiceResponse(
                ResponseStatus.FAILED,
                f"cnhubert weights unavailable at {self.cnhubert_path}")
        for wav_name, _lan, _text in self._read_refinements():
            name = os.path.basename(wav_name.replace("\\", "/"))
            if not self._ssl_one(name, model):
                return EaseVoiceResponse(ResponseStatus.FAILED,
                                         f"failed to process wav {name}")
        return EaseVoiceResponse(ResponseStatus.SUCCESS, "success")

    def _ssl_one(self, name: str, model) -> bool:
        from .models.cnhubert import feat_output_lengths

        hubert_path = os.path.join(self.hubert_dir, name + ".pt")
        if os.path.exists(hubert_path):
            return True
        wav_path = os.path.join(self.denoises_dir, name)
        if not os.path.exists(wav_path):
            logger.warning("missing wav %s", wav_path)
            return True
        audio = audio_io.load_audio(wav_path, 32000)
        peak = np.abs(audio).max()
        if peak <= 0 or peak > 2.2:
            return True  # reference skips clipped/silent items
        # amplitude-mix (normalize.py:155-163): int16-scale for the wav file,
        # 1145.14-scale for the hubert input
        audio32 = (audio / peak * (self.MAXX * self.ALPHA * 32768)
                   + (1 - self.ALPHA) * 32768 * audio)
        audio_b = (audio / peak * (self.MAXX * self.ALPHA * 1145.14)
                   + (1 - self.ALPHA) * 1145.14 * audio)
        wav16 = audio_io.resample(audio_b.astype(np.float32), 32000, 16000)
        true_len = wav16.shape[0]
        ssl = model(torch.from_numpy(wav16)[None].to(self.device),
                    torch.tensor([true_len], device=self.device))
        frames = int(feat_output_lengths(true_len, model.cfg))
        ssl = ssl[:, :frames].cpu().numpy()                # (1, T, 768)
        if np.isnan(ssl).any():
            return False
        audio_io.write_wav(os.path.join(self.wav_dir, name),
                           np.clip(audio32, -32768, 32767).astype(np.int16),
                           32000)
        # store (1, 768, T) like the reference
        self._save_pt(ssl.transpose(0, 2, 1).astype(np.float32), hubert_path)
        return True

    # ---- stage 3: token -------------------------------------------------------------

    def token(self) -> EaseVoiceResponse:
        from . import convert
        from .models.sovits import SovitsConfig, SynthesizerTrn

        if not os.path.exists(self.s2g_path):
            return EaseVoiceResponse(
                ResponseStatus.FAILED,
                f"pretrained s2G unavailable at {self.s2g_path}")
        with open(paths.s2_config_path(), encoding="utf8") as f:
            cfg = SovitsConfig.from_json_dict(json.load(f))
        model = SynthesizerTrn(cfg)
        # the posterior encoder is training-only (tts.py init_vits_weights)
        model.load_state_dict(convert.load_torch_state_dict(
            self.s2g_path, drop_prefix="enc_q."), strict=True)
        model = model.to(self.device).eval()

        rows = ["item_name\tsemantic_audio"]
        for wav_name, _lan, _text in self._read_refinements():
            name = os.path.basename(wav_name.replace("\\", "/"))
            hubert_path = os.path.join(self.hubert_dir, name + ".pt")
            if not os.path.exists(hubert_path):
                continue
            ssl = torch.load(hubert_path, map_location="cpu",
                             weights_only=False)
            ssl = ssl.to(torch.float32).transpose(1, 2)       # (1, T, 768)
            t = ssl.shape[1]
            n_codes = t // 2 if cfg.semantic_frame_rate == "25hz" else t
            with torch.no_grad():
                codes = model.extract_latent(ssl.to(self.device))
            codes = codes[0, :n_codes].cpu().tolist()
            rows.append("%s\t%s" % (name, " ".join(str(int(i))
                                                   for i in codes)))
        with open(self.semantic_output_path, "w", encoding="utf8") as f:
            f.write("\n".join(rows) + "\n")
        return EaseVoiceResponse(ResponseStatus.SUCCESS, "success")
