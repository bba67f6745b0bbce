"""Mel filterbank construction (Slaney-style, librosa-compatible).

The reference builds its mel basis with ``librosa.filters.mel`` using the
default ``htk=False, norm="slaney"`` convention
(reference: src/easevoice/module/mel_processing.py:77-93).  librosa is not a
dependency here, so the same filterbank is derived from first principles:

* Slaney mel scale: linear below 1 kHz (m = f / (200/3)), logarithmic above
  (step of log(6.4)/27 per mel).
* Triangular filters between successive mel band edges over the rFFT bin
  frequencies.
* "slaney" area normalization: each triangle is scaled by
  2 / (f_upper - f_lower).

Computed once on host in float64, embedded as a constant in jitted programs.
"""
from __future__ import annotations

import numpy as np

_MIN_LOG_HZ = 1000.0
_LIN_STEP = 200.0 / 3.0
_LOG_STEP = np.log(6.4) / 27.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _LIN_STEP


def hz_to_mel(freq):
    """Slaney (Auditory Toolbox) Hz -> mel."""
    freq = np.asanyarray(freq, dtype=np.float64)
    mel = freq / _LIN_STEP
    log_region = freq >= _MIN_LOG_HZ
    # np.where evaluates both branches; guard the log against nonpositive input
    safe = np.maximum(freq, 1e-10)
    mel = np.where(log_region, _MIN_LOG_MEL + np.log(safe / _MIN_LOG_HZ) / _LOG_STEP, mel)
    return mel


def mel_to_hz(mel):
    """Slaney mel -> Hz."""
    mel = np.asanyarray(mel, dtype=np.float64)
    freq = mel * _LIN_STEP
    log_region = mel >= _MIN_LOG_MEL
    freq = np.where(log_region, _MIN_LOG_HZ * np.exp(_LOG_STEP * (mel - _MIN_LOG_MEL)), freq)
    return freq


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Return a ``(n_mels, 1 + n_fft // 2)`` Slaney-normalized mel matrix."""
    if fmax is None:
        fmax = sr / 2.0

    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    band_edges = mel_frequencies(n_mels + 2, fmin, fmax)  # (n_mels + 2,)

    lower = band_edges[:-2][:, None]   # (n_mels, 1)
    center = band_edges[1:-1][:, None]
    upper = band_edges[2:][:, None]

    up_slope = (fft_freqs[None, :] - lower) / np.maximum(center - lower, 1e-10)
    down_slope = (upper - fft_freqs[None, :]) / np.maximum(upper - center, 1e-10)
    weights = np.maximum(0.0, np.minimum(up_slope, down_slope))

    # Slaney-style area normalization
    enorm = 2.0 / (band_edges[2:] - band_edges[:-2])
    weights *= enorm[:, None]
    return weights.astype(dtype)
