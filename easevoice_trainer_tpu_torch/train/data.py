"""Host-side datasets and static-shape bucket batching.

Rebuild of the reference data plumbing
(reference: src/easevoice/module/data_utils.py:14-324 for s2;
src/easevoice/soundstorm/auto_reg/data/{dataset,bucket_sampler}.py for s1),
with one TPU-critical change: batches are **padded to the bucket's upper
boundary**, so every bucket is one fixed XLA program shape (bounded
recompilation) instead of the reference's pad-to-longest (a new shape every
batch).

Artifact inputs are the reference formats exactly (SURVEY §1.2):
  2-name2text.txt        name\tphones\tword2ph\tnorm_text
  4-cnhubert/{wav}.pt    torch-saved (1, 768, T) SSL features
  5-wav32k/{wav}         int16 32 kHz wav
  6-name2semantic.tsv    item_name\tsemantic_audio ("t0 t1 ...")
``.npy`` twins of the ``.pt`` files are also accepted (native output of the
normalize pipeline here).

(The port's copy of the JAX package's ``train/data.py``: the s2 part and
the s1 ``GPTDataset`` / ``collate_gpt``.)
"""
from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import audio_io
from ..utils.logger import logger

S2_BOUNDARIES = (32, 300, 400, 500, 600, 700, 800, 900, 1000, 1100, 1200,
                 1300, 1400, 1500, 1600, 1700, 1800, 1900)


def _load_feature_file(base: str) -> Optional[np.ndarray]:
    """Load 4-cnhubert features saved either as .pt (torch) or .npy."""
    if os.path.exists(base + ".npy"):
        return np.load(base + ".npy")
    if os.path.exists(base + ".pt"):
        import torch

        t = torch.load(base + ".pt", map_location="cpu", weights_only=False)
        return t.detach().to(torch.float32).numpy()
    return None


def spectrogram_np(wav: np.ndarray, n_fft: int = 2048, hop: int = 640,
                   win: int = 2048) -> np.ndarray:
    """Numpy twin of ops.stft.spectrogram for the host data loader.

    (samples,) -> (frames, n_fft//2+1), same padding/window/eps semantics.
    """
    pad = (n_fft - hop) // 2
    y = np.pad(wav.astype(np.float32), (pad, pad), mode="reflect")
    num_frames = 1 + (len(y) - n_fft) // hop
    idx = (np.arange(num_frames)[:, None] * hop + np.arange(n_fft)[None, :])
    frames = y[idx]
    n = np.arange(win, dtype=np.float32)
    window = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)).astype(np.float32)
    spec = np.fft.rfft(frames * window, n=n_fft, axis=-1)
    return np.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6).astype(np.float32)


@dataclasses.dataclass
class S2Example:
    name: str
    phoneme_ids: np.ndarray  # (Tt,) int32
    frames: int              # spec frames (= wav samples // hop)


class S2Dataset:
    """Joins 2-name2text / 4-cnhubert / 5-wav32k (data_utils.py:14-130)."""

    def __init__(self, exp_dir: str, hop_length: int = 640,
                 sampling_rate: int = 32000, n_fft: int = 2048,
                 win_length: int = 2048, val: bool = False,
                 min_items: int = 100):
        self.exp_dir = exp_dir
        self.hop = hop_length
        self.sr = sampling_rate
        self.n_fft = n_fft
        self.win = win_length
        self.path2 = os.path.join(exp_dir, "2-name2text.txt")
        self.path4 = os.path.join(exp_dir, "4-cnhubert")
        self.path5 = os.path.join(exp_dir, "5-wav32k")
        for p in (self.path2, self.path4, self.path5):
            if not os.path.exists(p):
                raise FileNotFoundError(p)

        phoneme_data: Dict[str, List[int]] = {}
        with open(self.path2, encoding="utf8") as f:
            for line in f.read().strip("\n").split("\n"):
                parts = line.split("\t")
                if len(parts) != 4:
                    continue
                phoneme_data[parts[0]] = parts[1].split(" ")

        names4 = {n[:-4] if n.endswith(".npy") else n[:-3]
                  for n in os.listdir(self.path4)}
        names5 = set(os.listdir(self.path5))
        names = sorted(set(phoneme_data) & names4 & names5)

        # tiny datasets are replicated up to >= min_items items
        # (data_utils.py:44-48)
        if 0 < len(names) < min_items:
            names = names * max(2, min_items // len(names))

        from ..text.symbols import cleaned_text_to_sequence

        examples: List[S2Example] = []
        skipped = 0
        for name in names:
            phones = phoneme_data.get(name)
            if phones is None:
                skipped += 1
                continue
            try:
                ids = np.asarray(cleaned_text_to_sequence(phones), np.int32)
            except Exception:
                skipped += 1
                continue
            size = os.path.getsize(os.path.join(self.path5, name))
            duration = size / self.sr / 2
            if not (val or 0.6 < duration < 54):
                skipped += 1
                continue
            examples.append(S2Example(name, ids, int(size // (2 * self.hop))))
        if len(examples) <= 1:
            raise ValueError(f"data in {exp_dir} is all skipped")
        if skipped:
            logger.info("S2Dataset: skipped %d items", skipped)
        self.examples = examples

    def __len__(self):
        return len(self.examples)

    @property
    def lengths(self) -> List[int]:
        return [e.frames for e in self.examples]

    def load_item(self, i: int) -> Dict[str, np.ndarray]:
        e = self.examples[i]
        wav, sr = audio_io.read_wav(os.path.join(self.path5, e.name))
        wav = wav.astype(np.float32)
        spec = spectrogram_np(wav, self.n_fft, self.hop, self.win)
        ssl = _load_feature_file(os.path.join(self.path4, e.name))
        if ssl is None:
            raise FileNotFoundError(f"missing SSL features for {e.name}")
        ssl = np.squeeze(ssl)          # (C, T) or (T, C)
        T = spec.shape[0]
        if ssl.ndim == 2 and ssl.shape[0] != T and abs(ssl.shape[1] - T) <= 1:
            ssl = ssl.T                 # stored channels-first -> (T, C)
        # pad/trim ssl to the spec frame count (data_utils.py:106-108)
        if ssl.shape[0] < T:
            ssl = np.concatenate(
                [ssl, np.repeat(ssl[-1:], T - ssl.shape[0], axis=0)], axis=0)
        ssl = ssl[:T]
        return {"name": e.name, "ssl": ssl.astype(np.float32), "spec": spec,
                "wav": wav, "text": e.phoneme_ids}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class BucketBatcher:
    """Length-bucketed batches padded to static per-bucket shapes.

    The reference DistributedBucketSampler (data_utils.py:229-324) groups by
    spec length between ``boundaries``; here each bucket additionally fixes
    the padded time length to its upper boundary so XLA compiles once per
    bucket, and fixes the padded text length to a dataset-wide cap.
    """

    def __init__(self, lengths: Sequence[int], batch_size: int,
                 boundaries: Sequence[int] = S2_BOUNDARIES,
                 seed: int = 1234, drop_incomplete: bool = False):
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.seed = seed
        self.drop_incomplete = drop_incomplete
        self.buckets: List[List[int]] = [[] for _ in
                                         range(len(self.boundaries) - 1)]
        for idx, length in enumerate(lengths):
            b = self._bisect(length)
            if b is not None:
                self.buckets[b].append(idx)

    def _bisect(self, length: int) -> Optional[int]:
        lo, hi = 0, len(self.boundaries) - 1
        if not (self.boundaries[0] < length <= self.boundaries[-1]):
            return None
        while hi > lo + 1:
            mid = (lo + hi) // 2
            if self.boundaries[lo] < length <= self.boundaries[mid]:
                hi = mid
            else:
                lo = mid
        return lo

    def epoch_batches(self, epoch: int) -> List[Tuple[int, List[int]]]:
        """[(bucket_id, [dataset indices])], shuffled with an epoch seed."""
        rng = random.Random(self.seed + epoch)
        batches = []
        for b, bucket in enumerate(self.buckets):
            if not bucket:
                continue
            order = bucket[:]
            rng.shuffle(order)
            # pad the tail by wrapping so every batch is full & static
            rem = len(order) % self.batch_size
            if rem and not self.drop_incomplete:
                order += order[: self.batch_size - rem]
            elif rem:
                order = order[: len(order) - rem]
            for i in range(0, len(order), self.batch_size):
                batches.append((b, order[i:i + self.batch_size]))
        rng.shuffle(batches)
        return batches

    def padded_frames(self, bucket_id: int) -> int:
        # even (25 Hz semantic rate needs pairs), bucket upper bound
        return _round_up(self.boundaries[bucket_id + 1], 2)


def collate_s2(items: List[Dict[str, np.ndarray]], frames: int,
               text_len: int, hop: int = 640) -> Dict[str, np.ndarray]:
    """Pad a list of loaded items into one static-shape s2 batch."""
    B = len(items)
    n_freq = items[0]["spec"].shape[1]
    ssl_dim = items[0]["ssl"].shape[1]
    batch = {
        "ssl": np.zeros((B, frames, ssl_dim), np.float32),
        "spec": np.zeros((B, frames, n_freq), np.float32),
        "spec_lengths": np.zeros((B,), np.int32),
        "wav": np.zeros((B, frames * hop), np.float32),
        "text": np.zeros((B, text_len), np.int32),
        "text_lengths": np.zeros((B,), np.int32),
    }
    for i, it in enumerate(items):
        T = min(it["spec"].shape[0], frames)
        batch["spec"][i, :T] = it["spec"][:T]
        batch["ssl"][i, :T] = it["ssl"][:T]
        w = it["wav"][: T * hop]
        batch["wav"][i, : len(w)] = w
        batch["spec_lengths"][i] = T
        L = min(len(it["text"]), text_len)
        batch["text"][i, :L] = it["text"][:L]
        batch["text_lengths"][i] = L
    return batch


# ---------------------------------------------------------------------------
# s1 GPT dataset
# ---------------------------------------------------------------------------


class GPTDataset:
    """6-name2semantic.tsv + 2-name2text.txt -> (phonemes, semantic, bert).

    Filters follow the reference (auto_reg/data/dataset.py:103-190):
    semantic length <= max_sec * hz; phoneme length < semantic * 2.5 / hz-ish;
    3 <= phonemes-per-second <= 25; tiny sets replicated to >= 100 items.
    BERT features (3-bert/{name}.pt|npy, 1024 x Tt) are attached for zh text
    when present, else zeros.
    """

    PAD = 1024

    def __init__(self, exp_dir: str, max_sec: int = 54, hz: int = 25,
                 min_items: int = 100):
        self.exp_dir = exp_dir
        self.hz = hz
        path_sem = os.path.join(exp_dir, "6-name2semantic.tsv")
        path_txt = os.path.join(exp_dir, "2-name2text.txt")
        self.path_bert = os.path.join(exp_dir, "3-bert")
        phoneme_data: Dict[str, List[str]] = {}
        with open(path_txt, encoding="utf8") as f:
            for line in f.read().strip("\n").split("\n"):
                parts = line.split("\t")
                if len(parts) == 4:
                    phoneme_data[parts[0]] = parts[1].split(" ")

        from ..text.symbols import cleaned_text_to_sequence

        items = []
        with open(path_sem, encoding="utf8") as f:
            lines = f.read().strip("\n").split("\n")
        for line in lines[0:]:
            parts = line.split("\t")
            if len(parts) != 2 or parts[0] == "item_name":
                continue
            name, semantic_str = parts
            phones = phoneme_data.get(name)
            if phones is None:
                continue
            semantic = np.asarray([int(t) for t in semantic_str.split(" ")],
                                  np.int32)
            try:
                ph = np.asarray(cleaned_text_to_sequence(phones), np.int32)
            except Exception:
                continue
            sec = len(semantic) / hz
            if sec > max_sec:                       # dataset.py:127-131
                continue
            if len(ph) > len(semantic) * 2.5 * (25 / hz):  # dataset.py:141-144
                continue
            pps = len(ph) / max(sec, 1e-6)
            if not (3 < pps < 25):                  # dataset.py:147-153
                continue
            items.append((name, ph, semantic))
        if not items:
            raise ValueError(f"no usable items in {exp_dir}")
        if len(items) < min_items:
            items = items * max(2, min_items // len(items))
        self.items = items

    def __len__(self):
        return len(self.items)

    @property
    def lengths(self) -> List[int]:
        return [len(s) for (_, _, s) in self.items]

    def load_item(self, i: int):
        name, ph, semantic = self.items[i]
        bert = _load_feature_file(os.path.join(self.path_bert, name))
        if bert is not None:
            bert = np.squeeze(bert)
            if bert.shape[0] == 1024 and bert.ndim == 2:
                bert = bert.T          # (Tt, 1024)
            if bert.shape[0] != len(ph):
                bert = None
        if bert is None:
            bert = np.zeros((len(ph), 1024), np.float32)
        return {"name": name, "phoneme_ids": ph, "semantic_ids": semantic,
                "bert": bert.astype(np.float32)}


def collate_gpt(items, max_ph: int, max_sem: int) -> Dict[str, np.ndarray]:
    B = len(items)
    batch = {
        "phoneme_ids": np.zeros((B, max_ph), np.int32),
        "phoneme_ids_len": np.zeros((B,), np.int32),
        "semantic_ids": np.full((B, max_sem), 0, np.int32),
        "semantic_ids_len": np.zeros((B,), np.int32),
        "bert_feature": np.zeros((B, max_ph, 1024), np.float32),
    }
    for i, it in enumerate(items):
        lp = min(len(it["phoneme_ids"]), max_ph)
        ls = min(len(it["semantic_ids"]), max_sem)
        batch["phoneme_ids"][i, :lp] = it["phoneme_ids"][:lp]
        batch["phoneme_ids_len"][i] = lp
        batch["semantic_ids"][i, :ls] = it["semantic_ids"][:ls]
        batch["semantic_ids_len"][i] = ls
        batch["bert_feature"][i, :lp] = it["bert"][:lp]
    return batch
