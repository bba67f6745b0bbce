"""ctypes bindings for the native host audio library (csrc/evaudio.cpp).

Every function has a numpy fallback, so the package works without the
compiled library; ``available()`` reports which path is active.  ``build()``
compiles the repository's ``csrc/evaudio.cpp`` with the host C++ compiler
into the git-ignored ``build/native/libevaudio.so``, the only library this
module loads.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCE = os.path.join(_ROOT, "csrc", "evaudio.cpp")
_LIB_PATH = os.path.join(_ROOT, "build", "native", "libevaudio.so")
_lib: Optional[ctypes.CDLL] = None


def _bind(path: str) -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    _f32p = ctypes.POINTER(ctypes.c_float)
    _i16p = ctypes.POINTER(ctypes.c_int16)
    _f64p = ctypes.POINTER(ctypes.c_double)
    lib.evaudio_peak.restype = ctypes.c_float
    lib.evaudio_peak.argtypes = [_f32p, ctypes.c_int64]
    lib.evaudio_float_to_int16.argtypes = [
        _f32p, _i16p, ctypes.c_int64, ctypes.c_float]
    lib.evaudio_frame_rms.argtypes = [
        _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _f64p,
        ctypes.c_int64]
    lib.evaudio_mix_normalize.argtypes = [
        _f32p, _f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float]
    lib.evaudio_resample_len.restype = ctypes.c_int64
    lib.evaudio_resample_len.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64]
    lib.evaudio_resample_poly.argtypes = [
        _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _f32p]
    return lib


if os.path.exists(_LIB_PATH):
    _lib = _bind(_LIB_PATH)


def build(path: str = _LIB_PATH) -> str:
    """Compile ``csrc/evaudio.cpp`` into ``path`` and load it; returns the
    path.  Raises when no C++ compiler is found or the build fails."""
    global _lib
    cxx = shutil.which(os.environ.get("CXX", "c++")) or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++ / g++) on PATH")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run([cxx, "-O3", "-shared", "-fPIC", "-std=c++17", _SOURCE,
                    "-o", tmp], check=True)
    os.replace(tmp, path)
    _lib = _bind(path)
    if _lib is None:
        raise RuntimeError(f"built {path} but could not load it")
    return path


def available() -> bool:
    return _lib is not None


def _as_f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32)


def peak(x: np.ndarray) -> float:
    if _lib is not None:
        xc = _as_f32(x)
        return float(_lib.evaudio_peak(
            xc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), xc.size))
    return float(np.abs(x).max()) if x.size else 0.0


def float_to_int16(x: np.ndarray, scale: float = 32768.0) -> np.ndarray:
    if _lib is not None:
        xc = _as_f32(x)
        out = np.empty(xc.size, np.int16)
        _lib.evaudio_float_to_int16(
            xc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            xc.size, ctypes.c_float(scale))
        return out.reshape(x.shape)
    return np.clip(np.round(x * scale), -32768, 32767).astype(np.int16)


def frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    n_frames = 1 + len(y) // hop_length
    if _lib is not None:
        yc = _as_f32(y)
        out = np.empty(n_frames, np.float64)
        _lib.evaudio_frame_rms(
            yc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), yc.size,
            frame_length, hop_length,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_frames)
        return out
    return _np_frame_rms(y, frame_length, hop_length)[:n_frames]


def _np_frame_rms(y: np.ndarray, frame_length: int,
                  hop_length: int) -> np.ndarray:
    """Centered frame RMS, constant padding (the JAX package's
    ``audiokit/slicer.py frame_rms``)."""
    pad = frame_length // 2
    y = np.pad(y, (pad, pad), mode="constant")
    n_frames = 1 + (len(y) - frame_length) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(frame_length)[None, :])
    frames = y[idx]
    return np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=1))


def mix_normalize(x: np.ndarray, maxx: float, alpha: float,
                  scale: float) -> np.ndarray:
    p = peak(x)
    if _lib is not None:
        xc = _as_f32(x)
        out = np.empty_like(xc)
        _lib.evaudio_mix_normalize(
            xc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            xc.size, ctypes.c_float(p), ctypes.c_float(maxx),
            ctypes.c_float(alpha), ctypes.c_float(scale))
        return out
    if p <= 0:
        return np.zeros_like(x)
    return (x / p * (maxx * alpha * scale)
            + (1 - alpha) * scale * x).astype(np.float32)


def resample_poly(x: np.ndarray, up: int, down: int) -> np.ndarray:
    from math import gcd

    g = gcd(up, down)
    up, down = up // g, down // g
    if up == down:
        return np.asarray(x, np.float32)
    if _lib is not None:
        xc = _as_f32(x)
        out_n = int(_lib.evaudio_resample_len(xc.size, up, down))
        out = np.empty(out_n, np.float32)
        _lib.evaudio_resample_poly(
            xc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), xc.size,
            up, down, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out
    from scipy.signal import resample_poly as sp

    return sp(x, up, down).astype(np.float32)

