"""FSMN voice-activity detection (JAX: audiokit/vad_fsmn.py), FunASR's
``fsmn-vad`` in front of Paraformer.

Host copies of the JAX package's, under the same names: ``FsmnVadConfig``
and the offline hysteresis segmenter ``segment_speech_probs``; the frontend
is the Paraformer port's fbank / LFR 5/1 / CMVN.  The scorer runs on the
VAD's device: affine 400 -> 140 -> 250 (relu each), four memory blocks
(250 -> 128 projection without bias, a 20-tap *causal* depthwise memory,
128 -> 250 affine + relu), affine 250 -> 140 -> 248 with no activation
between them, and a softmax over 248 senones of which ``sil_pdf_ids`` are
silence; speech probability per 10 ms frame is ``1 - p(sil)``.

Module names are FunASR's FSMN encoder's (``in_linear1.linear.weight``,
``fsmn.{i}.fsmn_block.conv_left.weight`` with its ``(C, 1, k, 1)``
Conv2d kernel, ...); a checkpoint's ``encoder.`` prefix is detected and
taken off, as the JAX converter does (vad_fsmn.py:161-162).  A directory
with no checkpoint gives ``available=False``; a checkpoint that is present
and does not load raises (the JAX class logs it and reports
``available=False``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .asr_paraformer import (apply_lfr, bucket, find_weights, kaldi_fbank,
                             load_checkpoint, load_cmvn, read_config)

SAMPLE_RATE = 16000
FRAME_MS = 10


@dataclasses.dataclass(frozen=True)
class FsmnVadConfig:
    # net (encoder_conf of the published fsmn-vad checkpoint)
    input_dim: int = 400           # 80 mels * LFR 5
    input_affine_dim: int = 140
    fsmn_layers: int = 4
    linear_dim: int = 250
    proj_dim: int = 128
    lorder: int = 20
    rorder: int = 0
    output_affine_dim: int = 140
    output_dim: int = 248
    lfr_m: int = 5
    lfr_n: int = 1
    sil_pdf_ids: Tuple[int, ...] = (0,)
    # decision (model_conf)
    window_size_ms: int = 200
    speech_noise_thres: float = 0.6
    sil_to_speech_time_thres: int = 150
    speech_to_sil_time_thres: int = 150
    max_end_silence_time: int = 800
    max_single_segment_time: int = 60000
    lookback_time_start_point: int = 200
    lookahead_time_end_point: int = 100

    @classmethod
    def from_yaml(cls, cfg: dict) -> "FsmnVadConfig":
        enc = cfg.get("encoder_conf", {})
        mdl = cfg.get("model_conf", {})
        front = cfg.get("frontend_conf", {})
        lfr_m = front.get("lfr_m", 5)
        n_mels = front.get("n_mels", 80)
        return cls(
            input_dim=n_mels * lfr_m,
            input_affine_dim=enc.get("input_affine_dim", 140),
            fsmn_layers=enc.get("fsmn_layers", 4),
            linear_dim=enc.get("linear_dim", 250),
            proj_dim=enc.get("proj_dim", 128),
            lorder=enc.get("lorder", 20),
            rorder=enc.get("rorder", 0),
            output_affine_dim=enc.get("output_affine_dim", 140),
            output_dim=enc.get("output_dim", 248),
            lfr_m=lfr_m,
            lfr_n=front.get("lfr_n", 1),
            sil_pdf_ids=tuple(mdl.get("sil_pdf_ids", [0])),
            window_size_ms=mdl.get("window_size_ms", 200),
            speech_noise_thres=mdl.get("speech_noise_thres", 0.6),
            sil_to_speech_time_thres=mdl.get("sil_to_speech_time_thres", 150),
            speech_to_sil_time_thres=mdl.get("speech_to_sil_time_thres", 150),
            max_end_silence_time=mdl.get("max_end_silence_time", 800),
            max_single_segment_time=mdl.get("max_single_segment_time", 60000),
            lookback_time_start_point=mdl.get("lookback_time_start_point", 200),
            lookahead_time_end_point=mdl.get("lookahead_time_end_point", 100),
        )


# ---------------------------------------------------------------------------
# Torch net (FunASR fsmn_vad_streaming/encoder.py FSMN)
# ---------------------------------------------------------------------------

class _Linear(nn.Module):
    """FunASR's LinearTransform / AffineTransform: a Linear named
    ``linear``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.linear = nn.Linear(d_in, d_out, bias=bias)

    def forward(self, x):
        return self.linear(x)


class _MemoryBlock(nn.Module):
    """FunASR's FSMNBlock: causal depthwise taps over the current frame and
    ``lorder - 1`` past ones (``conv_left``), and with ``rorder`` > 0 future
    taps starting one frame ahead (``conv_right``); Conv2d kernels
    ``(C, 1, k, 1)``."""

    def __init__(self, c: "FsmnVadConfig"):
        super().__init__()
        d = c.proj_dim
        self.lorder, self.rorder = c.lorder, c.rorder
        self.conv_left = nn.Conv2d(d, d, (c.lorder, 1), groups=d, bias=False)
        if c.rorder > 0:
            self.conv_right = nn.Conv2d(d, d, (c.rorder, 1), groups=d,
                                        bias=False)

    def forward(self, p):
        t = p.shape[1]
        x = p.transpose(1, 2)                               # (B, C, T)
        mem = F.conv1d(F.pad(x, (self.lorder - 1, 0)),
                       self.conv_left.weight[..., 0], groups=x.shape[1])
        if self.rorder > 0:
            fut = F.conv1d(F.pad(x, (0, self.rorder)),
                           self.conv_right.weight[..., 0], groups=x.shape[1])
            mem = mem + fut[:, :, 1:t + 1]
        return p + mem.transpose(1, 2)


class _BasicBlock(nn.Module):
    """linear (no bias) -> memory -> affine -> relu."""

    def __init__(self, c: "FsmnVadConfig"):
        super().__init__()
        self.linear = _Linear(c.linear_dim, c.proj_dim, bias=False)
        self.fsmn_block = _MemoryBlock(c)
        self.affine = _Linear(c.proj_dim, c.linear_dim)

    def forward(self, x):
        return F.relu(self.affine(self.fsmn_block(self.linear(x))))


class FSMN(nn.Module):
    def __init__(self, cfg: "FsmnVadConfig" = None):
        super().__init__()
        c = cfg or FsmnVadConfig()
        self.in_linear1 = _Linear(c.input_dim, c.input_affine_dim)
        self.in_linear2 = _Linear(c.input_affine_dim, c.linear_dim)
        self.fsmn = nn.ModuleList(_BasicBlock(c)
                                  for _ in range(c.fsmn_layers))
        self.out_linear1 = _Linear(c.linear_dim, c.output_affine_dim)
        self.out_linear2 = _Linear(c.output_affine_dim, c.output_dim)

    def forward(self, x):
        """(B, T, input_dim) -> senone probabilities (B, T, output_dim)."""
        x = F.relu(self.in_linear1(x))
        x = F.relu(self.in_linear2(x))
        for block in self.fsmn:
            x = block(x)
        return torch.softmax(self.out_linear2(self.out_linear1(x)), dim=-1)


def strip_encoder_prefix(state: dict) -> dict:
    """The FSMN's keys of a FunASR fsmn-vad state dict: the ``encoder.``
    prefix taken off where the checkpoint carries it."""
    if any(k.startswith("encoder.") for k in state):
        return {k[len("encoder."):]: v for k, v in state.items()
                if k.startswith("encoder.")}
    return dict(state)


# ---------------------------------------------------------------------------
# Offline segmenter (host-side numpy over per-frame speech probabilities)
# ---------------------------------------------------------------------------

def segment_speech_probs(probs: np.ndarray, cfg: FsmnVadConfig,
                         frame_ms: int = FRAME_MS) -> List[Tuple[int, int]]:
    """Speech probabilities per frame -> [(start_ms, end_ms)] segments.

    Offline re-derivation of FunASR's windowed state machine: smooth over
    the 200 ms window, threshold at ``speech_noise_thres`` with the
    sil→speech / speech→sil persistence times as hysteresis, close a
    segment after ``max_end_silence_time`` of silence, extend by the
    lookback/lookahead margins, split at ``max_single_segment_time``.
    """
    n = len(probs)
    if n == 0:
        return []
    win = max(1, cfg.window_size_ms // frame_ms)
    kernel = np.ones(win, np.float32) / win
    smooth = np.convolve(np.asarray(probs, np.float32), kernel, mode="same")
    is_speech = smooth >= cfg.speech_noise_thres

    up = max(1, cfg.sil_to_speech_time_thres // frame_ms)
    down = max(1, cfg.max_end_silence_time // frame_ms)
    segs: List[Tuple[int, int]] = []
    state = 0  # 0 = silence, 1 = speech
    run = 0
    start = 0
    for i in range(n):
        if state == 0:
            run = run + 1 if is_speech[i] else 0
            if run >= up:
                state, start, run = 1, i - run + 1, 0
        else:
            run = run + 1 if not is_speech[i] else 0
            if run >= down:
                segs.append((start, i - run + 1))
                state, run = 0, 0
    if state == 1:
        segs.append((start, n))

    look_b = cfg.lookback_time_start_point // frame_ms
    look_a = cfg.lookahead_time_end_point // frame_ms
    max_frames = max(1, cfg.max_single_segment_time // frame_ms)
    out: List[Tuple[int, int]] = []
    for s, e in segs:
        s = max(0, s - look_b)
        e = min(n, e + look_a)
        while e - s > max_frames:
            out.append((s * frame_ms, (s + max_frames) * frame_ms))
            s += max_frames
        out.append((s * frame_ms, e * frame_ms))
    # merge strict overlaps produced by the extension margins (touching
    # boundaries from the max-length split stay separate)
    merged: List[Tuple[int, int]] = []
    for s, e in out:
        if merged and s < merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


# ---------------------------------------------------------------------------
# Runtime wrapper
# ---------------------------------------------------------------------------

class FsmnVAD:
    """Filesystem-checkpoint FSMN VAD on ``device`` (the card unless the
    caller asks for the CPU).

    ``model_dir`` holds ``model.pt`` + ``config.yaml`` + ``am.mvn`` — the
    layout ``tools/fetch_pretrained.py`` produces from the modelscope repo
    ``iic/speech_fsmn_vad_zh-cn-16k-common-pytorch``.
    """

    def __init__(self, model_dir: str, device="cuda"):
        self.device = resolve_device(device, "FsmnVAD")
        self.model_dir = model_dir
        self.available = False
        model_path = find_weights(model_dir)
        if model_path is None:
            return
        self.cfg = FsmnVadConfig.from_yaml(read_config(model_dir))
        mvn_path = os.path.join(model_dir, "am.mvn")
        if os.path.exists(mvn_path):
            self.cmvn_shift, self.cmvn_scale = load_cmvn(mvn_path)
        else:
            self.cmvn_shift = np.zeros(self.cfg.input_dim, np.float32)
            self.cmvn_scale = np.ones(self.cfg.input_dim, np.float32)
        self.model = FSMN(self.cfg)
        self.model.load_state_dict(
            strip_encoder_prefix(load_checkpoint(model_path)), strict=True)
        self.model.to(self.device).eval()
        self.available = True

    @torch.no_grad()
    def speech_probs(self, wav: np.ndarray) -> np.ndarray:
        """Per-10 ms-frame speech probability for a mono 16 kHz wave.  The
        frames are padded to the JAX package's bucket, as there (with
        ``rorder`` 0 the memory is causal and the padding does not reach
        the valid frames)."""
        feats = kaldi_fbank(wav, n_mels=self.cfg.input_dim // self.cfg.lfr_m)
        feats = apply_lfr(feats, self.cfg.lfr_m, self.cfg.lfr_n)
        feats = (feats + self.cmvn_shift) * self.cmvn_scale
        if feats.shape[0] == 0:
            return np.zeros((0,), np.float32)
        t = feats.shape[0]
        x = torch.zeros((1, bucket(t, 16), feats.shape[1]),
                        device=self.device)
        x[0, :t] = torch.from_numpy(np.asarray(feats, np.float32)).to(
            self.device)
        scores = self.model(x)[0, :t]
        sil = scores[:, list(self.cfg.sil_pdf_ids)].sum(-1)
        return (1.0 - sil).cpu().numpy()

    def segments(self, wav: np.ndarray,
                 sample_rate: int = SAMPLE_RATE) -> List[Tuple[int, int]]:
        """[(start_sample, end_sample)] speech segments; [] when silent."""
        probs = self.speech_probs(wav)
        ms = segment_speech_probs(probs, self.cfg)
        step = sample_rate // 1000
        return [(s * step, min(len(wav), e * step)) for s, e in ms]
