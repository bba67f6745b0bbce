"""Host-side audio IO.

The reference decodes everything through an ffmpeg subprocess
(reference: src/utils/audio/__init__.py:13-32).  Here:

* 16-bit PCM WAV is read/written natively (stdlib ``wave`` + numpy) — the
  entire artifact contract (5-wav32k, slices, outputs) is int16 WAV;
* other formats fall back to the ffmpeg CLI when present;
* resampling uses polyphase filtering (scipy) on host — feature extraction
  (32 kHz -> 16 kHz for the SSL model) stays on CPU, batches go to TPU.
"""
from __future__ import annotations

import os
import shutil
import struct
import subprocess
import wave
from typing import Optional, Tuple

import numpy as np

MAX_WAV_VALUE = 32768.0


def read_wav(path: str, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 in [-1, 1], sample_rate).

    ``mono=True`` downmixes to a 1-D array; ``mono=False`` returns
    (channels, samples) preserving true stereo (the UVR5 separation path,
    reference: src/audiokit/uvr5/separate.py:48-76)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / MAX_WAV_VALUE
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {sampwidth} in {path}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels)
        data = data.mean(axis=1) if mono else data.T.copy()
    elif not mono:
        data = data[None, :]
    return data, sr


def write_wav(path: str, data: np.ndarray, sr: int) -> None:
    """Write float [-1,1] or int16 data as 16-bit PCM WAV.

    1-D input is mono; 2-D input uses the (channels, samples) layout all
    separators emit and is interleaved to a multichannel file."""
    if data.ndim == 2:
        data = data.T  # (C, T) -> (T, C) frame-interleaved
    if data.dtype != np.int16:
        data = np.round(np.clip(data, -1.0, 1.0) * MAX_WAV_VALUE)
        data = np.clip(data, -32768, 32767).astype(np.int16)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if data.ndim == 1 else data.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.ascontiguousarray(data).tobytes())


def resample(data: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return data
    from math import gcd

    g = gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    try:  # native polyphase kernel when built (csrc/evaudio.cpp)
        from .. import native

        if native.available():
            if data.ndim == 1:
                return native.resample_poly(data, up, down)
            return np.stack([native.resample_poly(ch, up, down)
                             for ch in data])
    except Exception:
        pass
    from scipy.signal import resample_poly

    # time is the LAST axis (multichannel audio is (channels, samples))
    return resample_poly(data, up, down, axis=-1).astype(np.float32)


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def load_audio(path: str, target_sr: int, mono: bool = True) -> np.ndarray:
    """Decode any audio file to float32 at ``target_sr``.

    ``mono=True`` -> 1-D downmix (the training/feature path);
    ``mono=False`` -> (channels, samples) true stereo (the UVR5 path,
    reference reformats to stereo 44.1k before separation,
    src/service/audio.py:116-127).  WAV loads natively; other containers
    need the ffmpeg CLI (reference load_audio:
    src/utils/audio/__init__.py:13-32).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        try:
            data, sr = read_wav(path, mono=mono)
            return resample(data, sr, target_sr)
        except Exception:
            pass  # fall through to ffmpeg (e.g. float-PCM wav)
    if not have_ffmpeg():
        raise RuntimeError(
            f"cannot decode {path}: not int16 WAV and ffmpeg is unavailable")
    n_ch = 1 if mono else 2
    cmd = [
        "ffmpeg", "-nostdin", "-threads", "0", "-i", path,
        "-f", "f32le", "-acodec", "pcm_f32le", "-ac", str(n_ch),
        "-ar", str(target_sr), "-",
    ]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    data = np.frombuffer(out, np.float32).copy()
    if mono:
        return data
    return data.reshape(-1, n_ch).T.copy()


def probe_duration(path: str) -> Optional[float]:
    """Seconds of audio; WAV natively, else ffprobe."""
    try:
        with wave.open(path, "rb") as w:
            return w.getnframes() / w.getframerate()
    except Exception:
        pass
    if shutil.which("ffprobe"):
        try:
            out = subprocess.run(
                ["ffprobe", "-v", "error", "-show_entries", "format=duration",
                 "-of", "default=noprint_wrappers=1:nokey=1", path],
                capture_output=True, check=True).stdout
            return float(out.strip())
        except Exception:
            return None
    return None
