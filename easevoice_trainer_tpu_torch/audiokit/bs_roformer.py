"""BS-Roformer and Mel-Band Roformer source separators (JAX:
audiokit/bs_roformer.py), in plain torch with their attention on K1.

A centered STFT (n_fft 2048, hop 441) whose bins, stereo folded into the
frequency axis (index f * S + s), are grouped into bands (62 fixed bands
for BS-Roformer, 60 overlapping mel bands for Mel-Band), each band
projected to a shared width; ``depth`` axial blocks alternate a time
transformer (one row a band, T = 801 frames for an 8 s chunk) and a
frequency transformer (one row a frame, over the bands), both RMSNorm
pre-norm with interleaved rotary positions and per-head sigmoid output
gates; per-band GLU MLPs estimate a complex mask that multiplies the STFT.

The attention's softmax(QK^T / sqrt(dk)) V runs on K1's dk-64 instance
through ``ops/attention.py encoder_attention`` with every key valid (no
padding).  Rotary, the gates, the projections, the norms and the MLPs are
plain torch: the JAX package computes them with XLA.  q and k are rotated
in K1's (B, T, H, dk) layout; v goes to K1 as a view of the fused qkv
projection, with no copy.

Modules carry the reference's torch names (``band_split.to_features.{i}``,
``layers.{L}.{0,1}.layers.{d}.{0,1}``, ``final_norm``,
``mask_estimators.0.to_freqs.{i}``), the keys the JAX converters read.  A
released checkpoint also holds each attention's ``rotary_embed.freqs``
(the rotary angles, recomputed here); ``read_roformer_state`` drops them,
and the rest loads with ``load_state_dict(strict=True)``.

The separators keep the JAX package's host numpy for the STFT, the 8 s
chunks (352,800 samples) with linear fades over a tenth of a chunk, and
the overlap-add; the net runs on the device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import encoder_attention
from ..utils import audio_io
from ..utils.device import resolve_device

DEFAULT_FREQS_PER_BANDS = (
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    12, 12, 12, 12, 12, 12, 12, 12,
    24, 24, 24, 24, 24, 24, 24, 24,
    48, 48, 48, 48, 48, 48, 48, 48,
    128, 129,
)


@dataclasses.dataclass(frozen=True)
class BSRoformerConfig:
    """The released Bs_Roformer checkpoint config (JAX: bs_roformer.py:38)."""

    dim: int = 512
    depth: int = 12
    stereo: bool = True
    num_stems: int = 1
    time_transformer_depth: int = 1
    freq_transformer_depth: int = 1
    freqs_per_bands: Tuple[int, ...] = DEFAULT_FREQS_PER_BANDS
    dim_head: int = 64
    heads: int = 8
    stft_n_fft: int = 2048
    stft_hop_length: int = 441
    stft_win_length: int = 2048
    mask_estimator_depth: int = 2

    @property
    def audio_channels(self) -> int:
        return 2 if self.stereo else 1


@dataclasses.dataclass(frozen=True)
class MelBandRoformerConfig:
    """The mel-banded variant (JAX: bs_roformer.py:410): overlapping
    mel-filter bands, a trailing RMSNorm in each transformer, no final
    norm, depth + 1 linears in each mask MLP."""

    dim: int = 384
    depth: int = 6
    stereo: bool = True
    num_stems: int = 1
    time_transformer_depth: int = 1
    freq_transformer_depth: int = 1
    num_bands: int = 60
    dim_head: int = 64
    heads: int = 8
    sample_rate: int = 44100
    stft_n_fft: int = 2048
    stft_hop_length: int = 441
    stft_win_length: int = 2048
    mask_estimator_depth: int = 1

    @property
    def audio_channels(self) -> int:
        return 2 if self.stereo else 1


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return F.normalize(x, dim=-1, eps=1e-12) * self.scale * self.gamma


def rotary_freqs(dim_head: int, length: int) -> np.ndarray:
    """Interleaved rotary angles (T, dim_head), rotary_embedding_torch's
    'lang' convention, built in float64 and cast to float32."""
    inv = 1.0 / (10000.0 ** (np.arange(0, dim_head, 2,
                                       dtype=np.float64) / dim_head))
    t = np.arange(length, dtype=np.float64)
    freqs = np.einsum("t,d->td", t, inv)          # (T, dim/2)
    return np.repeat(freqs, 2, axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _rotary_cos_sin(dim_head: int, length: int, device: str):
    """cos and sin of the angles as (T, 1, dim_head) on ``device``."""
    freqs = torch.from_numpy(rotary_freqs(dim_head, length)).to(device)
    return freqs.cos()[:, None], freqs.sin()[:, None]


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved pairs of x's last axis; cos / sin broadcast
    against x (for (B, T, H, d): (T, 1, d))."""
    pairs = x.unflatten(-1, (-1, 2))
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], -1).flatten(-2)
    return x * cos + rotated * sin


class RoformerAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_gates = nn.Linear(dim, heads)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, bias=False))

    def forward(self, x):
        """x: (B, N, dim)."""
        b, n, _ = x.shape
        h, dk = self.heads, self.dim_head
        y = self.norm(x)
        q, k, v = self.to_qkv(y).view(b, n, 3, h, dk).unbind(2)
        cos, sin = _rotary_cos_sin(dk, n, str(x.device))
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        full = torch.full((b,), n, dtype=torch.int32, device=x.device)
        out = encoder_attention(q, k, v, full)              # (B, N, H, dk)
        out = out * torch.sigmoid(self.to_gates(y))[..., None]
        return self.to_out(out.reshape(b, n, h * dk))


class RoformerFFN(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(RMSNorm(dim), nn.Linear(dim, dim * mult),
                                 nn.GELU(), nn.Identity(),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class RoformerTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 norm_output: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([RoformerAttention(dim, heads, dim_head),
                           RoformerFFN(dim)])
            for _ in range(depth))
        self.norm = RMSNorm(dim) if norm_output else None

    def forward(self, x):
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        return x if self.norm is None else self.norm(x)


class BandSplit(nn.Module):
    def __init__(self, dim: int, dim_inputs: Tuple[int, ...]):
        super().__init__()
        self.dim_inputs = tuple(dim_inputs)
        self.to_features = nn.ModuleList(
            nn.Sequential(RMSNorm(d), nn.Linear(d, dim)) for d in dim_inputs)

    def forward(self, x):
        """(B, T, sum(dim_inputs)) -> (B, T, n_bands, dim)."""
        chunks = torch.split(x, self.dim_inputs, dim=-1)
        return torch.stack([f(c) for f, c in zip(self.to_features, chunks)],
                           dim=-2)


class MaskEstimator(nn.Module):
    """One MLP a band (``n_linear`` linears, tanh between, the last
    2 * d_in wide), then a GLU; (B, T, n_bands, dim) -> (B, T,
    sum(dim_inputs))."""

    def __init__(self, dim: int, dim_inputs: Tuple[int, ...], n_linear: int,
                 expansion: int = 4):
        super().__init__()
        hidden = dim * expansion
        self.to_freqs = nn.ModuleList()
        for d_in in dim_inputs:
            dims = [dim] + [hidden] * (n_linear - 1) + [d_in * 2]
            mlp = []
            for j in range(n_linear):
                mlp.append(nn.Linear(dims[j], dims[j + 1]))
                if j < n_linear - 1:
                    mlp.append(nn.Tanh())
            self.to_freqs.append(nn.Sequential(nn.Sequential(*mlp),
                                               nn.GLU(dim=-1)))

    def forward(self, x):
        return torch.cat([f(x[..., i, :]) for i, f in
                          enumerate(self.to_freqs)], dim=-1)


class _AxialRoformer(nn.Module):
    """The band split, the ``depth`` time / frequency transformer pairs and
    the mask estimator shared by both nets."""

    def _axial(self, x):
        """(B, T, NB, D) through the time and frequency transformers."""
        b, t, nb, d = x.shape
        for time_t, freq_t in self.layers:
            y = x.permute(0, 2, 1, 3).reshape(b * nb, t, d)
            x = time_t(y).reshape(b, nb, t, d).permute(0, 2, 1, 3)
            x = freq_t(x.reshape(b * t, nb, d)).reshape(b, t, nb, d)
        return x

    def _transformers(self, c, norm_output: bool):
        self.layers = nn.ModuleList(
            nn.ModuleList([
                RoformerTransformer(c.dim, c.time_transformer_depth, c.heads,
                                    c.dim_head, norm_output),
                RoformerTransformer(c.dim, c.freq_transformer_depth, c.heads,
                                    c.dim_head, norm_output)])
            for _ in range(c.depth))


class BSRoformer(_AxialRoformer):
    def __init__(self, cfg: BSRoformerConfig = BSRoformerConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.bands = tuple(2 * f * c.audio_channels
                           for f in c.freqs_per_bands)
        self.band_split = BandSplit(c.dim, self.bands)
        self._transformers(c, False)
        self.final_norm = RMSNorm(c.dim)
        self.mask_estimators = nn.ModuleList(
            [MaskEstimator(c.dim, self.bands, c.mask_estimator_depth)])

    def forward(self, spec_in: torch.Tensor) -> torch.Tensor:
        """spec_in: (B, F*S, T, 2) real / imag STFT, stereo folded into the
        frequency axis (index f * S + s).  Returns the complex mask of the
        same shape."""
        b, fs, t, _ = spec_in.shape
        x = spec_in.permute(0, 2, 1, 3).reshape(b, t, fs * 2)
        x = self._axial(self.band_split(x))
        mask = self.mask_estimators[0](self.final_norm(x))   # (B, T, FS*2)
        return mask.reshape(b, t, fs, 2).permute(0, 2, 1, 3)


def mel_band_membership(cfg: MelBandRoformerConfig):
    """(freq_indices, dim_inputs, num_bands_per_freq) from the Slaney mel
    bank, corner bins pinned (JAX: bs_roformer.py:436)."""
    from ..ops.mel import mel_filterbank

    fb = mel_filterbank(cfg.sample_rate, cfg.stft_n_fft, cfg.num_bands)
    fb = fb.copy()
    fb[0, 0] = 1.0
    fb[-1, -1] = 1.0
    member = fb > 0                                   # (bands, freqs)
    assert member.any(axis=0).all(), "every freq must belong to some band"
    idx_rows = [np.nonzero(row)[0] for row in member]
    flat = np.concatenate(idx_rows)
    if cfg.stereo:
        flat = (np.repeat(flat, 2) * 2
                + np.tile(np.arange(2), len(flat)))   # (f s) fold
    dim_inputs = tuple(2 * len(r) * cfg.audio_channels for r in idx_rows)
    num_bands_per_freq = member.sum(axis=0).astype(np.float32)
    return flat.astype(np.int32), dim_inputs, num_bands_per_freq


class MelBandRoformer(_AxialRoformer):
    def __init__(self, cfg: MelBandRoformerConfig = MelBandRoformerConfig()):
        super().__init__()
        self.cfg = c = cfg
        freq_idx, self.bands, nbpf = mel_band_membership(c)
        self.register_buffer("freq_indices",
                             torch.from_numpy(freq_idx.astype(np.int64)),
                             persistent=False)
        self.register_buffer(
            "num_bands_per_freq",
            torch.from_numpy(np.repeat(nbpf, c.audio_channels)),
            persistent=False)
        self.band_split = BandSplit(c.dim, self.bands)
        self._transformers(c, True)
        self.mask_estimators = nn.ModuleList(
            [MaskEstimator(c.dim, self.bands, c.mask_estimator_depth + 1)])

    def forward(self, spec_in: torch.Tensor) -> torch.Tensor:
        """spec_in: (B, F*S, T, 2), folded as BSRoformer's.  Returns the
        band-averaged complex mask, same shape."""
        b, fs, t, _ = spec_in.shape
        gathered = spec_in.index_select(1, self.freq_indices)
        x = gathered.permute(0, 2, 1, 3).reshape(b, t, -1)
        x = self._axial(self.band_split(x))
        masks = self.mask_estimators[0](x)                  # (B, T, M*2)
        m = masks.reshape(b, t, -1, 2).permute(2, 0, 1, 3)  # (M, B, T, 2)
        # scatter-add the overlapping band masks onto their bins, average
        summed = m.new_zeros((fs, b, t, 2)).index_add_(0, self.freq_indices,
                                                       m)
        denom = self.num_bands_per_freq.clamp(min=1e-8)
        return summed.permute(1, 0, 2, 3) / denom[None, :, None, None]


def read_roformer_state(model_path: str) -> Dict[str, torch.Tensor]:
    """A released Roformer checkpoint as the port's state dict: fp32,
    without the attentions' ``rotary_embed.freqs`` (recomputed)."""
    from .uvr5 import read_state

    return {k: v for k, v in read_state(model_path).items()
            if not k.endswith("rotary_embed.freqs")}


# ---------------------------------------------------------------------------
# separators (the reference's windowed demix; JAX: bs_roformer.py:291-402)
# ---------------------------------------------------------------------------


class BSRoformerSeparator:
    """The BS-Roformer separator, its net on ``device`` (the card unless
    the caller asks for the CPU).  A checkpoint that does not load
    raises."""

    CHUNK = 352800
    FADE = CHUNK // 10
    SR = 44100
    NET, CONFIG = BSRoformer, BSRoformerConfig

    def __init__(self, model_path: str, device="cuda"):
        self._init(read_roformer_state(model_path), self.CONFIG(), device)

    def _init(self, state, cfg, device) -> None:
        from .uvr5 import load_net

        self.device = resolve_device(device, type(self).__name__)
        self.cfg = cfg
        self.net = load_net(self.NET(cfg), state, self.device)

    @classmethod
    def from_state(cls, state: Dict[str, torch.Tensor], cfg, device="cuda"):
        """A separator over a state dict and an explicit config (tests,
        custom configs)."""
        self = cls.__new__(cls)
        self._init(state, cfg, device)
        return self

    # centered stft / istft (torch.stft's default center=True)
    def _stft(self, wav: np.ndarray) -> np.ndarray:
        c = self.cfg
        pad = c.stft_n_fft // 2
        out = []
        for ch in wav:
            y = np.pad(ch, (pad, pad), mode="reflect")
            frames = 1 + (len(y) - c.stft_n_fft) // c.stft_hop_length
            idx = (np.arange(frames)[:, None] * c.stft_hop_length
                   + np.arange(c.stft_n_fft)[None, :])
            win = np.hanning(c.stft_n_fft + 1)[:-1]
            out.append(np.fft.rfft(y[idx] * win, axis=-1).T)
        return np.stack(out)                       # (S, F, T) complex

    def _istft(self, spec: np.ndarray, length: int) -> np.ndarray:
        c = self.cfg
        hop = c.stft_hop_length
        n_fft = c.stft_n_fft
        win = np.hanning(n_fft + 1)[:-1]
        out = []
        for ch in spec:
            frames = np.fft.irfft(ch.T, n=n_fft, axis=-1)
            total = n_fft + hop * (frames.shape[0] - 1)
            y = np.zeros(total)
            norm = np.zeros(total)
            for i in range(frames.shape[0]):
                y[i * hop:i * hop + n_fft] += frames[i] * win
                norm[i * hop:i * hop + n_fft] += win ** 2
            y /= np.maximum(norm, 1e-8)
            out.append(y[n_fft // 2:n_fft // 2 + length])
        return np.stack(out).astype(np.float32)

    @torch.no_grad()
    def _mask(self, x: np.ndarray) -> np.ndarray:
        """The net's complex mask (as re / im) of one folded chunk."""
        return self.net(torch.from_numpy(x).to(self.device)).cpu().numpy()

    def _run_chunk(self, chunk: np.ndarray) -> np.ndarray:
        """(S, CHUNK) -> separated (S, CHUNK)."""
        spec = self._stft(chunk)                                   # (S,F,T)
        s, f, t = spec.shape
        folded = spec.transpose(1, 0, 2).reshape(1, f * s, t)     # (f s)
        x = np.stack([folded.real, folded.imag], axis=-1).astype(np.float32)
        mask = self._mask(x)
        sep = folded * (mask[..., 0] + 1j * mask[..., 1])
        return self._istft(sep.reshape(f, s, t).transpose(1, 0, 2),
                           chunk.shape[-1])

    def separate(self, wav: np.ndarray, sr: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(vocal, instrumental), stereo at 44.1 kHz: 8 s chunks overlapping
        by a fifth, faded linearly and averaged; instrumental = mix -
        vocal."""
        if sr != self.SR:
            wav = audio_io.resample(wav, sr, self.SR)
        if wav.ndim == 1:
            wav = np.stack([wav, wav])
        n = wav.shape[-1]
        step = self.CHUNK - 2 * self.FADE
        out = np.zeros_like(wav)
        weight = np.zeros(n, np.float32)
        window = np.ones(self.CHUNK, np.float32)
        window[:self.FADE] = np.linspace(0, 1, self.FADE)
        window[-self.FADE:] = np.linspace(1, 0, self.FADE)
        pos = 0
        while pos < n:
            chunk = wav[:, pos:pos + self.CHUNK]
            valid = chunk.shape[-1]
            if valid < self.CHUNK:
                chunk = np.pad(chunk, ((0, 0), (0, self.CHUNK - valid)))
            sep = self._run_chunk(chunk)[:, :valid]
            out[:, pos:pos + valid] += sep * window[:valid]
            weight[pos:pos + valid] += window[:valid]
            pos += step
        out /= np.maximum(weight, 1e-8)
        vocal = out
        inst = wav[:, :vocal.shape[-1]] - vocal
        return vocal, inst


class MelBandRoformerSeparator(BSRoformerSeparator):
    """The same windowed demix over the Mel-Band Roformer (whose net emits
    the already-averaged mask)."""

    NET, CONFIG = MelBandRoformer, MelBandRoformerConfig
