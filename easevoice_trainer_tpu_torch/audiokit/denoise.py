"""Speech denoising stage (JAX: audiokit/denoise.py).

Backends, in order:

1. the FRCRN net (:mod:`.frcrn`) on the Denoise's device when a checkpoint
   is present (``EASEVOICE_FRCRN_PATH`` or
   ``{base}/models/denoise/speech_frcrn_ans_cirm_16k/``);
2. otherwise the host spectral gate (noise-floor estimate per band + soft
   mask), a different algorithm, reported as such in :attr:`Denoise.backend`.

Two differences from the JAX class.  Its first backend, modelscope's own
pipeline, is not ported: the port's FRCRN is that network.  And a
checkpoint that is present but does not load raises here, where the JAX
class logs it and falls back to the spectral gate.
"""
from __future__ import annotations

import numpy as np

from ..utils import audio_io
from ..utils.device import resolve_device
from . import frcrn


class Denoise:
    SR = 16000  # FRCRN operates at 16 kHz in the reference

    def __init__(self, device="cuda"):
        self.device = resolve_device(device, "Denoise")
        self._frcrn = None
        self.backend = "spectral-gate"
        path = frcrn.default_model_path()
        if path:
            self._frcrn = frcrn.FRCRNDenoiser(path, self.device)
            self.backend = "frcrn-torch"

    def denoise(self, input_path: str, output_path: str) -> None:
        if self._frcrn is not None:
            self._frcrn.denoise(input_path, output_path)
            return
        wav, sr = audio_io.read_wav(input_path)
        out = spectral_gate(wav, sr)
        audio_io.write_wav(output_path, out, sr)


def spectral_gate(wav: np.ndarray, sr: int, n_fft: int = 1024,
                  hop: int = 256, reduction_db: float = 12.0) -> np.ndarray:
    """Soft spectral-subtraction denoiser (stationary noise floor)."""
    if len(wav) < n_fft:
        return wav
    window = np.hanning(n_fft).astype(np.float32)
    n_frames = 1 + (len(wav) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = wav[idx] * window
    spec = np.fft.rfft(frames, axis=-1)
    mag = np.abs(spec)
    # noise floor: 10th percentile magnitude per bin
    noise = np.percentile(mag, 10, axis=0, keepdims=True)
    gain = np.maximum(1.0 - (noise / np.maximum(mag, 1e-9)) ** 2, 0.0)
    floor = 10 ** (-reduction_db / 20.0)
    gain = np.maximum(gain, floor)
    cleaned = spec * gain
    # overlap-add
    out = np.zeros(len(wav), np.float32)
    norm = np.zeros(len(wav), np.float32)
    frames_out = np.fft.irfft(cleaned, n=n_fft, axis=-1).astype(np.float32)
    for i in range(n_frames):
        start = i * hop
        out[start:start + n_fft] += frames_out[i] * window
        norm[start:start + n_fft] += window ** 2
    out /= np.maximum(norm, 1e-8)
    return out
