"""Linear and mel spectrograms in torch (JAX: ops/stft.py).

Same pipeline and layout as the JAX package: reflect-pad the waveform by
``(n_fft - hop) / 2`` on each side, frame without centring, periodic Hann
window, ``sqrt(re^2 + im^2 + 1e-6)``, Slaney mel filterbank from the shared
numpy ``ops/mel.py``, then ``log(clamp(x, 1e-5))``.  Spectrograms are
``(..., frames, bins)``.  The FFT is ``torch.fft.rfft``: the JAX package
calls ``jnp.fft`` outside any Pallas kernel too.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

import easevoice_trainer_tpu


def _shared_mel_module():
    """The JAX package's numpy ``ops/mel.py``, loaded by path: importing it
    as ``easevoice_trainer_tpu.ops.mel`` would run ``ops/__init__.py``,
    which imports jax."""
    path = os.path.join(os.path.dirname(easevoice_trainer_tpu.__file__),
                        "ops", "mel.py")
    spec = importlib.util.spec_from_file_location("_easevoice_mel", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


mel_filterbank = _shared_mel_module().mel_filterbank


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Spectrogram hyperparameters (mirrors configs/s2.json "data" and the
    JAX package's ``ops/stft.py MelConfig``)."""

    sampling_rate: int = 32000
    n_fft: int = 2048
    hop_length: int = 640
    win_length: int = 2048
    n_mels: int = 128
    fmin: float = 0.0
    fmax: Optional[float] = None


def _hann(win_length: int, n_fft: int, device) -> torch.Tensor:
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)
    lpad = (n_fft - win_length) // 2
    return F.pad(w, (lpad, n_fft - win_length - lpad))


def spectrogram(y: torch.Tensor, n_fft: int = 2048, hop_length: int = 640,
                win_length: int = 2048) -> torch.Tensor:
    """Magnitude spectrogram of ``(..., samples)`` ->
    ``(..., frames, n_fft // 2 + 1)``."""
    lead = y.shape[:-1]
    y = y.to(torch.float32).reshape(-1, 1, y.shape[-1])
    pad = (n_fft - hop_length) // 2
    y = F.pad(y, (pad, pad), mode="reflect")[:, 0]
    frames = y.unfold(-1, n_fft, hop_length)          # (N, frames, n_fft)
    spec = torch.fft.rfft(frames * _hann(win_length, n_fft, y.device), n=n_fft)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6)
    return mag.reshape(*lead, *mag.shape[-2:])


@functools.lru_cache(maxsize=8)
def _mel_matrix(cfg: MelConfig, device: torch.device) -> torch.Tensor:
    # (n_freq, n_mels), as the JAX package contracts frames x bins @ bins x mels
    mat = mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                         cfg.fmax).T
    return torch.from_numpy(np.ascontiguousarray(mat)).to(device)


def spec_to_mel(spec: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """(..., frames, n_freq) linear magnitude -> (..., frames, n_mels)
    log-mel."""
    mel = spec.to(torch.float32) @ _mel_matrix(cfg, spec.device)
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_spectrogram(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Waveform ``(..., samples)`` -> log-mel ``(..., frames, n_mels)``."""
    return spec_to_mel(spectrogram(y, cfg.n_fft, cfg.hop_length,
                                   cfg.win_length), cfg)
