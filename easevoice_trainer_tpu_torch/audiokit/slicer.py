"""RMS-based silence slicer (pure numpy).

Rebuild of the reference Slicer
(reference: src/audiokit/slicer/slicer.py:7-180): frame-level RMS against a
dB threshold, silences split at their quietest frame, leading/middle/
trailing silence trimmed with ``max_sil_kept`` frames retained; returns
chunks with sample offsets that name the output files
``{name}_{start:010d}_{end:010d}.wav``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Centered frame RMS, constant padding (librosa.feature.rms semantics)."""
    pad = frame_length // 2
    y = np.pad(y, (pad, pad), mode="constant")
    n_frames = 1 + (len(y) - frame_length) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(frame_length)[None, :])
    frames = y[idx]
    return np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=1))


class Slicer:
    def __init__(self, sr: int, threshold: float = -34.0,
                 min_length: int = 4000, min_interval: int = 300,
                 hop_size: int = 10, max_sil_kept: int = 500):
        if not min_length >= min_interval >= hop_size:
            raise ValueError("min_length >= min_interval >= hop_size required")
        if not max_sil_kept >= hop_size:
            raise ValueError("max_sil_kept >= hop_size required")
        min_interval_samples = sr * min_interval / 1000
        self.threshold = 10 ** (threshold / 20.0)
        self.hop_size = round(sr * hop_size / 1000)
        self.win_size = min(round(min_interval_samples), 4 * self.hop_size)
        self.min_length = round(sr * min_length / 1000 / self.hop_size)
        self.min_interval = round(min_interval_samples / self.hop_size)
        self.max_sil_kept = round(sr * max_sil_kept / 1000 / self.hop_size)

    def _cut(self, waveform: np.ndarray, begin: int, end: int) -> np.ndarray:
        return waveform[begin * self.hop_size:
                        min(len(waveform), end * self.hop_size)]

    def slice(self, waveform: np.ndarray
              ) -> List[Tuple[np.ndarray, int, int]]:
        """Returns [(chunk, start_sample, end_sample), ...]."""
        samples = waveform.mean(axis=0) if waveform.ndim > 1 else waveform
        if len(samples) <= self.min_length * self.hop_size:
            return [(waveform, 0, len(samples))]
        rms = frame_rms(samples, self.win_size, self.hop_size)

        sil_tags: List[Tuple[int, int]] = []
        silence_start = None
        clip_start = 0
        for i, r in enumerate(rms):
            if r < self.threshold:
                if silence_start is None:
                    silence_start = i
                continue
            if silence_start is None:
                continue
            leading = silence_start == 0 and i > self.max_sil_kept
            middle = (i - silence_start >= self.min_interval
                      and i - clip_start >= self.min_length)
            if not leading and not middle:
                silence_start = None
                continue
            if i - silence_start <= self.max_sil_kept:
                pos = int(rms[silence_start:i + 1].argmin()) + silence_start
                sil_tags.append((0, pos) if silence_start == 0 else (pos, pos))
                clip_start = pos
            elif i - silence_start <= self.max_sil_kept * 2:
                mid = int(rms[i - self.max_sil_kept:
                              silence_start + self.max_sil_kept + 1].argmin())
                mid += i - self.max_sil_kept
                pos_l = int(rms[silence_start:
                                silence_start + self.max_sil_kept + 1]
                            .argmin()) + silence_start
                pos_r = int(rms[i - self.max_sil_kept:i + 1].argmin()) \
                    + i - self.max_sil_kept
                if silence_start == 0:
                    sil_tags.append((0, pos_r))
                    clip_start = pos_r
                else:
                    sil_tags.append((min(pos_l, mid), max(pos_r, mid)))
                    clip_start = max(pos_r, mid)
            else:
                pos_l = int(rms[silence_start:
                                silence_start + self.max_sil_kept + 1]
                            .argmin()) + silence_start
                pos_r = int(rms[i - self.max_sil_kept:i + 1].argmin()) \
                    + i - self.max_sil_kept
                sil_tags.append((0, pos_r) if silence_start == 0
                                else (pos_l, pos_r))
                clip_start = pos_r
            silence_start = None

        total = len(rms)
        if silence_start is not None and total - silence_start >= self.min_interval:
            sil_end = min(total, silence_start + self.max_sil_kept)
            pos = int(rms[silence_start:sil_end + 1].argmin()) + silence_start
            sil_tags.append((pos, total + 1))

        if not sil_tags:
            return [(waveform, 0, int(total * self.hop_size))]
        chunks = []
        if sil_tags[0][0] > 0:
            chunks.append((self._cut(waveform, 0, sil_tags[0][0]), 0,
                           int(sil_tags[0][0] * self.hop_size)))
        for a, b in zip(sil_tags[:-1], sil_tags[1:]):
            chunks.append((self._cut(waveform, a[1], b[0]),
                           int(a[1] * self.hop_size),
                           int(b[0] * self.hop_size)))
        if sil_tags[-1][1] < total:
            chunks.append((self._cut(waveform, sil_tags[-1][1], total),
                           int(sil_tags[-1][1] * self.hop_size),
                           int(total * self.hop_size)))
        return chunks
