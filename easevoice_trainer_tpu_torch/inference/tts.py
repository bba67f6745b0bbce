"""Voice-clone TTS pipeline on PyTorch: reference prep -> AR decode -> VITS
vocoder (JAX: inference/tts.py).

* ``TTSConfig``: the two-tier (default/custom) config file, persisted back on
  weight changes.  It is written as JSON, which YAML readers also accept;
  a YAML file is read with ``yaml``, imported only when the file is not JSON.
* ``TTS.set_ref_audio``: 3-10 s reference, reference spectrogram + prompt
  semantic tokens via cnhubert -> s2 ``extract_latent``.
* ``TTS.run``: preprocess text (Chinese runs get BERT phone features from
  ``models/bert.py`` and polyphones from the G2PW model, both on the
  device) -> sort-by-length batches -> KV-cached AR decode -> VITS decode
  per batch -> peak-clamped splice with ``fragment_interval`` silence,
  order restored, int16 output.

Shapes are padded to the JAX package's buckets (phones to 16, codes to 64,
text to 16, ``max_new_tokens`` to 32) so both packages compute on the same
shapes.  Models run in fp32 on ``TTSConfig.device``.  The host-only pieces
(``InferenceTaskData``, ``to_batch``, ``_postprocess``) are copies of the JAX
module's, which imports jax at module top; the tests hold the copies equal.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import time
from typing import Any, Dict, Generator, List, Optional, Tuple

import numpy as np
import torch

from .. import convert
from ..models.bert import BertFeatureExtractor
from ..models.cnhubert import feat_output_lengths, load_cnhubert
from ..models.gpt import DecodeParams, T2SConfig, Text2SemanticDecoder, \
    decode_ar
from ..models.sovits import SovitsConfig, SynthesizerTrn
from ..text import chinese
from ..train.data import spectrogram_np
from ..utils import audio_io, paths
from ..utils.config import GlobalCFG
from ..utils.device import resolve_device
from ..utils.logger import logger
from .preprocessor import TextPreprocessor


@dataclasses.dataclass
class InferenceTaskData:
    """Request schema (reference: inference/__init__.py:21-48)."""

    text: str = ""
    text_lang: str = "zh"
    ref_audio_path: str = ""
    aux_ref_audio_paths: Optional[List[str]] = None
    prompt_text: str = ""
    prompt_lang: str = "zh"
    top_k: int = 5
    top_p: float = 1.0
    temperature: float = 1.0
    text_split_method: str = "by_4_sentences"
    batch_size: int = 1
    batch_threshold: float = 0.75
    split_bucket: bool = True
    return_fragment: bool = False
    speed_factor: float = 1.0
    fragment_interval: float = 0.3
    seed: int = -1
    keep_random: bool = True
    ref_text_free: bool = False
    parallel_infer: bool = True
    repetition_penalty: float = 1.35
    sovits_path: str = ""
    gpt_path: str = ""
    output_dir: str = ""
    project_dir: str = ""


def _read_config(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf8") as f:
        text = f.read()
    try:
        return json.loads(text) or {}
    except json.JSONDecodeError:
        import yaml

        return yaml.safe_load(text) or {}


class TTSConfig:
    """default/custom two-tier config (reference: tts.py:66-180)."""

    def __init__(self, config_path: Optional[str] = None):
        self.config_path = config_path or paths.tts_infer_config_path()
        data: Dict[str, Any] = {}
        if os.path.exists(self.config_path):
            data = _read_config(self.config_path)
        default = data.get("default", {})
        custom = data.get("custom", {})
        merged = {**default, **custom}

        # defaults: the JAX package's GlobalCFG env vars and pretrained layout
        glob = GlobalCFG()
        self.device = merged.get("device", "cuda")
        self.is_half = bool(merged.get("is_half", False))
        self.t2s_weights_path = merged.get("t2s_weights_path", glob.gpt_path)
        self.vits_weights_path = merged.get("vits_weights_path",
                                            glob.sovits_path)
        self.bert_base_path = merged.get("bert_base_path", glob.bert_path)
        self.cnhubert_base_path = merged.get(
            "cnhuhbert_base_path",
            merged.get("cnhubert_base_path", glob.cnhubert_path))
        self._default = default or self.as_dict()

        # runtime constants (reference: tts.py:126-134)
        self.sampling_rate = 32000
        self.hop_length = 640
        self.semantic_hz = 50
        self.max_sec = 54

    def as_dict(self) -> Dict[str, Any]:
        return {
            "device": self.device,
            "is_half": self.is_half,
            "t2s_weights_path": self.t2s_weights_path,
            "vits_weights_path": self.vits_weights_path,
            "bert_base_path": self.bert_base_path,
            "cnhuhbert_base_path": self.cnhubert_base_path,
        }

    def save_configs(self) -> None:
        data = {"default": self._default, "custom": self.as_dict()}
        os.makedirs(os.path.dirname(self.config_path) or ".", exist_ok=True)
        with open(self.config_path, "w", encoding="utf8") as f:
            json.dump(data, f, indent=2, ensure_ascii=False)


class NoReferenceAudioError(ValueError):
    pass


class TTS:
    def __init__(self, config: TTSConfig,
                 models: Optional[Dict[str, Any]] = None):
        """``models`` (testing/DI hook) may provide the ``vits``, ``t2s`` and
        ``cnhubert`` modules and the ``bert`` extractor (or None), already
        on ``config.device``.  The Chinese frontend's G2PW model runs on
        that device too."""
        self.cfg = config
        self.device = resolve_device(config.device, "TTS")
        chinese.set_g2pw_device(self.device)
        self.prompt_cache: Dict[str, Any] = {
            "ref_audio_path": None, "refer_spec": [], "prompt_semantic": None,
            "aux_ref_audio_paths": [],
        }
        self.vits: Optional[SynthesizerTrn] = None
        self.t2s: Optional[Text2SemanticDecoder] = None
        self.cnhubert = None
        if models is not None:
            self.__dict__.update(models)
            self.vits_cfg = self.vits.cfg
            self.t2s_cfg = self.t2s.cfg
            self.preprocessor = TextPreprocessor(getattr(self, "bert", None))
        else:
            self._init_models()

    # ---- model management ---------------------------------------------------

    def _init_models(self) -> None:
        self.vits_cfg = SovitsConfig()
        self.t2s_cfg = T2SConfig()
        self.bert = BertFeatureExtractor(self.cfg.bert_base_path,
                                         self.device)
        self.cnhubert = load_cnhubert(self.cfg.cnhubert_base_path,
                                      self.device)
        self.preprocessor = TextPreprocessor(
            self.bert if self.bert.available else None)
        if self.cfg.vits_weights_path and os.path.exists(
                self.cfg.vits_weights_path):
            self.init_vits_weights(self.cfg.vits_weights_path)
        if self.cfg.t2s_weights_path and os.path.exists(
                self.cfg.t2s_weights_path):
            self.init_t2s_weights(self.cfg.t2s_weights_path)

    def init_vits_weights(self, path: str) -> None:
        # the posterior encoder is training-only (reference exports drop it)
        state = convert.load_torch_state_dict(path, drop_prefix="enc_q.")
        model = SynthesizerTrn(self.vits_cfg)
        model.load_state_dict(state, strict=True)
        self.vits = model.to(self.device).eval()
        self.cfg.vits_weights_path = path
        self.cfg.save_configs()
        logger.info("loaded sovits weights %s", path)

    def init_t2s_weights(self, path: str) -> None:
        model = Text2SemanticDecoder(self.t2s_cfg)
        model.load_state_dict(convert.load_torch_state_dict(path),
                              strict=True)
        self.t2s = model.to(self.device).eval()
        self.cfg.t2s_weights_path = path
        self.cfg.save_configs()
        logger.info("loaded t2s weights %s", path)

    def _require_models(self) -> None:
        missing = []
        if self.vits is None:
            missing.append(f"sovits weights ({self.cfg.vits_weights_path})")
        if self.t2s is None:
            missing.append(f"gpt weights ({self.cfg.t2s_weights_path})")
        if self.cnhubert is None:
            missing.append(f"cnhubert ({self.cfg.cnhubert_base_path})")
        if missing:
            raise FileNotFoundError(
                "TTS models unavailable: " + "; ".join(missing))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ---- reference audio ----------------------------------------------------

    def set_ref_audio(self, ref_audio_path: str,
                      aux_ref_audio_paths: Optional[List[str]] = None) -> None:
        """Prompt cache fill (reference: tts.py:369-437, 3-10 s enforced)."""
        if not ref_audio_path or not os.path.exists(ref_audio_path):
            raise NoReferenceAudioError(
                f"reference audio not found: {ref_audio_path}")
        if ref_audio_path != self.prompt_cache["ref_audio_path"]:
            wav = audio_io.load_audio(ref_audio_path, self.cfg.sampling_rate)
            dur = len(wav) / self.cfg.sampling_rate
            if not (3.0 <= dur <= 10.0):
                raise ValueError(
                    f"reference audio must be 3-10 s, got {dur:.2f} s")
            spec = spectrogram_np(wav, 2048, self.cfg.hop_length, 2048)
            self.prompt_cache["refer_spec"] = [spec]
            self.prompt_cache["prompt_semantic"] = self._extract_semantic(wav)
            self.prompt_cache["ref_audio_path"] = ref_audio_path

        aux = [p for p in (aux_ref_audio_paths or []) if os.path.exists(p)]
        if aux != self.prompt_cache["aux_ref_audio_paths"]:
            specs = [self.prompt_cache["refer_spec"][0]]
            for p in aux:
                wav = audio_io.load_audio(p, self.cfg.sampling_rate)
                specs.append(spectrogram_np(wav, 2048, self.cfg.hop_length,
                                            2048))
            self.prompt_cache["refer_spec"] = specs
            self.prompt_cache["aux_ref_audio_paths"] = aux

    @torch.no_grad()
    def _extract_semantic(self, wav32k: np.ndarray) -> np.ndarray:
        """wav 32 kHz -> prompt semantic tokens (tts.py:411-437): 0.3 s of
        silence appended, resampled to 16 kHz, the raw waveform through
        masked hubert, then the s2 quantizer."""
        wav32k = np.concatenate(
            [wav32k, np.zeros(int(self.cfg.sampling_rate * 0.3), np.float32)])
        wav16k = audio_io.resample(wav32k, self.cfg.sampling_rate, 16000)
        # the JAX package's 0.5 s length bucket; the mask keeps real frames
        # independent of the padding
        true_len = wav16k.shape[0]
        bucket = max(8000, -(-true_len // 8000) * 8000)
        padded = np.zeros((1, bucket), np.float32)
        padded[0, :true_len] = wav16k
        ssl = self.cnhubert(self._tensor(padded),
                            self._tensor(np.asarray([true_len], np.int64)))
        frames = int(feat_output_lengths(true_len, self.cnhubert.cfg))
        ssl = ssl[:, :frames]
        # 25hz models halve the SSL rate via the stride-2 ssl_proj
        t25 = frames // 2 \
            if self.vits_cfg.semantic_frame_rate == "25hz" else frames
        pad_t = -(-ssl.shape[1] // 32) * 32
        ssl_p = torch.nn.functional.pad(ssl, (0, 0, 0, pad_t - ssl.shape[1]))
        codes = self.vits.extract_latent(ssl_p)               # (1, T25)
        return codes[0, :t25].cpu().numpy().astype(np.int32)

    # ---- batching -------------------------------------------------------------

    @staticmethod
    def to_batch(segments: List[Dict], batch_size: int,
                 threshold: float = 0.75,
                 split_bucket: bool = True
                 ) -> Tuple[List[List[Dict]], List[List[int]]]:
        """Similar-length bucketing (reference: tts.py:460-551): sort by
        normalized-text length, then take up to ``batch_size`` items while
        the window's median over mean length is >= ``threshold``; a
        singleton window is always accepted."""
        def _len(seg: Dict) -> int:
            t = seg.get("norm_text")
            return len(t) if t else len(seg["phones"])

        index_batches: List[List[int]] = []
        if split_bucket:
            order = sorted(range(len(segments)),
                           key=lambda i: _len(segments[i]))
            lens = [float(_len(segments[i])) for i in order]
            pos = 0
            while pos < len(order):
                pos_end = min(pos + batch_size, len(order))
                while pos < pos_end:
                    window = lens[pos:pos_end]
                    score = window[(pos_end - pos) // 2] / (
                        sum(window) / len(window) + 1e-8)
                    if score >= threshold or pos_end - pos == 1:
                        index_batches.append(order[pos:pos_end])
                        pos = pos_end
                        break
                    pos_end -= 1
        else:
            for i in range(0, len(segments), batch_size):
                index_batches.append(
                    list(range(i, min(i + batch_size, len(segments)))))
        batches = [[segments[i] for i in idxs] for idxs in index_batches]
        return batches, index_batches

    # ---- main pipeline ----------------------------------------------------------

    def run(self, task: InferenceTaskData
            ) -> Generator[Tuple[int, np.ndarray], None, None]:
        """Yields (sample_rate, int16 waveform).

        ``seed=-1`` (or ``keep_random``) draws a fresh seed, surfaced via
        ``self.last_seed``; sampling draws from one ``torch.Generator`` on
        the device seeded with it.  ``return_fragment`` yields one fragment
        per batch (bucketing disabled); an exception mid-synthesis yields one
        second of silence, reloads both models, and re-raises.
        """
        self._require_models()
        t0 = time.time()
        self.set_ref_audio(task.ref_audio_path, task.aux_ref_audio_paths)

        seed = -1 if task.keep_random else task.seed
        actual_seed = seed if seed not in (-1, 0, "", None) \
            else random.randrange(1 << 32)
        self.last_seed = int(actual_seed)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.last_seed)

        split_bucket = task.split_bucket
        if task.return_fragment and split_bucket:
            split_bucket = False
            logger.info("return_fragment: split_bucket disabled")
        if task.speed_factor != 1.0:
            split_bucket = False

        prompt_phones: List[int] = []
        prompt_bert = np.zeros((1024, 0), np.float32)
        prompt_text = "" if task.ref_text_free else task.prompt_text
        if prompt_text.strip():
            phones, bert, _ = self.preprocessor.get_phones_and_bert(
                prompt_text, task.prompt_lang)
            prompt_phones, prompt_bert = phones, bert
        t1 = time.time()

        segments = self.preprocessor.preprocess(
            task.text, task.text_lang, task.text_split_method)
        if not segments:
            yield self.cfg.sampling_rate, np.zeros(
                int(self.cfg.sampling_rate * 0.3), np.int16)
            return
        t2 = time.time()

        batches, index_batches = self.to_batch(
            segments, task.batch_size, task.batch_threshold, split_bucket)

        prompt_semantic = self.prompt_cache["prompt_semantic"]
        audio_fragments: List[Optional[np.ndarray]] = [None] * len(segments)
        t_ar = 0.0
        t_voc = 0.0
        n_tokens = 0
        sr = self.cfg.sampling_rate

        try:
            for batch, idxs in zip(batches, index_batches):
                ta = time.time()
                tokens, lengths = self._ar_decode(
                    batch, prompt_phones, prompt_bert, prompt_semantic, task,
                    generator)
                t_ar += time.time() - ta
                n_tokens += int(lengths.sum())

                tv = time.time()
                if task.parallel_infer and len(batch) > 1:
                    wavs = self._vocode_batch(tokens, lengths, batch,
                                              task.speed_factor)
                else:
                    wavs = []
                    for j, seg in enumerate(batch):
                        n = int(lengths[j])
                        codes = np.asarray(tokens[j][:max(n, 1)])
                        wavs.append(self._vocode(codes, seg["phones"],
                                                 task.speed_factor))
                for j, wav in enumerate(wavs):
                    audio_fragments[idxs[j]] = wav
                t_voc += time.time() - tv

                if task.return_fragment:
                    yield sr, self._postprocess(list(wavs),
                                                task.fragment_interval)
        except Exception:
            yield sr, np.zeros(sr, np.int16)
            self._reload_models()
            raise

        if task.return_fragment:
            return
        audio = self._postprocess(
            [a for a in audio_fragments if a is not None],
            task.fragment_interval)
        self.last_phases = {"ref_prep": t1 - t0, "text_preproc": t2 - t1,
                            "ar_decode": t_ar, "vocoder": t_voc}
        self.last_generated_tokens = n_tokens
        logger.info("tts phases: ref=%.2fs text=%.2fs ar=%.2fs voc=%.2fs",
                    t1 - t0, t2 - t1, t_ar, t_voc)
        yield sr, audio

    def _reload_models(self) -> None:
        """Drop and reload both models (reference tts.py:856-864)."""
        self.vits = None
        self.t2s = None
        try:
            if self.cfg.vits_weights_path and os.path.exists(
                    self.cfg.vits_weights_path):
                self.init_vits_weights(self.cfg.vits_weights_path)
            if self.cfg.t2s_weights_path and os.path.exists(
                    self.cfg.t2s_weights_path):
                self.init_t2s_weights(self.cfg.t2s_weights_path)
        except Exception:
            logger.exception("model reload after inference failure failed")

    # ---- stages ---------------------------------------------------------------

    def _ar_decode(self, batch: List[Dict], prompt_phones: List[int],
                   prompt_bert: np.ndarray, prompt_semantic: np.ndarray,
                   task: InferenceTaskData, generator: torch.Generator
                   ) -> Tuple[np.ndarray, np.ndarray]:
        B = len(batch)
        seqs = [list(prompt_phones) + list(seg["phones"]) for seg in batch]
        berts = [np.concatenate([prompt_bert, seg["bert_features"]], axis=1)
                 for seg in batch]
        max_ph = _round_up(max(len(s) for s in seqs), 16)
        x = np.zeros((B, max_ph), np.int64)
        x_lens = np.zeros((B,), np.int32)
        bert = np.zeros((B, max_ph, 1024), np.float32)
        for i, (s, b) in enumerate(zip(seqs, berts)):
            x[i, :len(s)] = s
            x_lens[i] = len(s)
            bert[i, :b.shape[1]] = b.T
        prompts = np.tile(prompt_semantic[None, :], (B, 1)).astype(np.int64)

        # cap new tokens by the remaining semantic budget
        max_new = min(1500, self.cfg.max_sec * self.cfg.semantic_hz // 2
                      - prompts.shape[1])
        params = DecodeParams(
            top_k=task.top_k, top_p=task.top_p,
            temperature=task.temperature,
            repetition_penalty=task.repetition_penalty,
            max_new_tokens=_round_up(max(max_new, 32), 32))
        tokens, lengths = decode_ar(
            self.t2s, self._tensor(x), self._tensor(x_lens),
            self._tensor(prompts), self._tensor(bert), params, generator)
        return tokens.cpu().numpy(), lengths.cpu().numpy()

    def _refer(self) -> Tuple[torch.Tensor, torch.Tensor]:
        refer_specs = self.prompt_cache["refer_spec"]
        max_t = max(s.shape[0] for s in refer_specs)
        refer = np.zeros((len(refer_specs), max_t, refer_specs[0].shape[1]),
                         np.float32)
        refer_lens = np.zeros((len(refer_specs),), np.int64)
        for i, s in enumerate(refer_specs):
            refer[i, :s.shape[0]] = s
            refer_lens[i] = s.shape[0]
        return self._tensor(refer), self._tensor(refer_lens)

    @torch.no_grad()
    def _vocode(self, codes: np.ndarray, phones: List[int],
                speed_factor: float) -> np.ndarray:
        n_codes = len(codes)
        pad_codes = _round_up(max(n_codes, 16), 64)
        codes_p = np.zeros((1, pad_codes), np.int64)
        codes_p[0, :n_codes] = codes
        pad_text = _round_up(max(len(phones), 8), 16)
        text = np.zeros((1, pad_text), np.int64)
        text[0, :len(phones)] = phones
        refer, refer_lens = self._refer()
        wav = self.vits.decode(
            self._tensor(codes_p), self._tensor(text),
            self._tensor(np.asarray([len(phones)], np.int64)), refer,
            refer_lens, speed=speed_factor,
            codes_lengths=self._tensor(np.asarray([n_codes], np.int64)))
        samples = n_codes * 2 * self.cfg.hop_length
        return wav[0, :samples, 0].cpu().numpy()

    # Padded batch-samples per vocoder call; larger batches are chunked
    # (the JAX package's memory guard, kept so both packages compute on the
    # same padded shapes).
    _VOCODE_BUDGET_SAMPLES = 3_000_000

    @torch.no_grad()
    def _vocode_batch(self, tokens: np.ndarray, lengths: np.ndarray,
                      batch: List[Dict], speed_factor: float
                      ) -> List[np.ndarray]:
        """Padded VITS decode for the segment batch, chunked under the
        budget above (reference parallel_infer: tts.py:796-807)."""
        B = len(batch)
        pad_all = _round_up(max(max(int(lengths[j]) for j in range(B)), 16),
                            64) * 2 * self.cfg.hop_length
        rows_per_call = max(1, self._VOCODE_BUDGET_SAMPLES // max(pad_all, 1))
        if rows_per_call < B:
            out: List[np.ndarray] = []
            for s in range(0, B, rows_per_call):
                sl = slice(s, min(s + rows_per_call, B))
                out.extend(self._vocode_batch(tokens[sl], lengths[sl],
                                              batch[sl], speed_factor))
            return out
        n_codes = [max(int(lengths[j]), 1) for j in range(B)]
        pad_codes = _round_up(max(max(n_codes), 16), 64)
        codes = np.zeros((B, pad_codes), np.int64)
        for j in range(B):
            codes[j, :n_codes[j]] = np.asarray(tokens[j][:n_codes[j]])
        pad_text = _round_up(max(len(s["phones"]) for s in batch), 16)
        text = np.zeros((B, pad_text), np.int64)
        text_lens = np.zeros((B,), np.int64)
        for j, seg in enumerate(batch):
            text[j, :len(seg["phones"])] = seg["phones"]
            text_lens[j] = len(seg["phones"])
        refer, refer_lens = self._refer()
        wav = self.vits.decode(
            self._tensor(codes), self._tensor(text), self._tensor(text_lens),
            refer, refer_lens, speed=speed_factor,
            codes_lengths=self._tensor(np.asarray(n_codes, np.int64)))
        wav = wav.cpu().numpy()
        return [wav[j, :n_codes[j] * 2 * self.cfg.hop_length, 0]
                for j in range(B)]

    def _postprocess(self, fragments: List[np.ndarray],
                     fragment_interval: float) -> np.ndarray:
        """Peak clamp + silence splice + int16 (reference: tts.py:878-908)."""
        sr = self.cfg.sampling_rate
        gap = np.zeros(int(sr * max(fragment_interval, 0.01)), np.float32)
        out: List[np.ndarray] = []
        for frag in fragments:
            peak = np.abs(frag).max() if frag.size else 0.0
            if peak > 1.0:
                frag = frag / peak
            out.append(frag)
            out.append(gap)
        audio = np.concatenate(out) if out else gap
        return (audio * 32768.0).clip(-32768, 32767).astype(np.int16)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
