"""s2 SoVITS synthesizer (JAX: models/sovits/synthesizer.py).

``decode`` (semantic codes -> waveform) and ``extract_latent`` (SSL features
-> codes) serve synthesis; ``forward`` is the training forward.  The
posterior encoder ``enc_q`` belongs to training: it is built only with
``with_enc_q=True``, so the inference build's state dict is that of a
deployable export (no ``enc_q.*``, see ``inference/tts.py``).  Public
layouts are the JAX package's: codes (B, Tc), SSL features (B, T, D),
spectrograms (B, frames, bins), waveforms (B, samples, 1), latents
(B, frames, C).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
from torch import nn

from ...nn.layers import compute_dtype, conv_in, rand_slice_starts, \
    sequence_mask, set_compute_dtype, slice_segments
from .flow import ResidualCouplingBlock
from .generator import Generator
from .mel_style import MelStyleEncoder
from .posterior import PosteriorEncoder
from .quantize import ResidualVectorQuantizer
from .text_encoder import TextEncoder


@dataclasses.dataclass(frozen=True)
class SovitsConfig:
    """Model hyperparameters (mirrors configs/s2.json "model" + "data")."""

    spec_channels: int = 1025          # n_fft // 2 + 1
    segment_size: int = 20480          # samples per GAN slice
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock: str = "1"
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3
    upsample_rates: Sequence[int] = (10, 8, 2, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (16, 16, 8, 2, 2)
    gin_channels: int = 512
    ssl_dim: int = 768
    semantic_frame_rate: str = "25hz"
    freeze_quantizer: bool = True
    n_symbols: int = 732
    sampling_rate: int = 32000
    hop_length: int = 640

    @property
    def segment_frames(self) -> int:
        return self.segment_size // self.hop_length

    @classmethod
    def from_json_dict(cls, d: dict) -> "SovitsConfig":
        model = d.get("model", {})
        data = d.get("data", {})
        kw: dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            if f.name in model:
                kw[f.name] = model[f.name]
        if "filter_length" in data:
            kw["spec_channels"] = data["filter_length"] // 2 + 1
        if "sampling_rate" in data:
            kw["sampling_rate"] = data["sampling_rate"]
        if "hop_length" in data:
            kw["hop_length"] = data["hop_length"]
        if "segment_size" in d.get("train", {}):
            kw["segment_size"] = d["train"]["segment_size"]
        for seq_key in ("resblock_kernel_sizes", "upsample_rates",
                        "upsample_kernel_sizes"):
            if seq_key in kw:
                kw[seq_key] = tuple(kw[seq_key])
        if "resblock_dilation_sizes" in kw:
            kw["resblock_dilation_sizes"] = tuple(
                tuple(x) for x in kw["resblock_dilation_sizes"])
        return cls(**kw)


class SynthesizerTrn(nn.Module):
    def __init__(self, cfg: SovitsConfig = SovitsConfig(),
                 with_enc_q: bool = False,
                 dtype: Optional[torch.dtype] = None):
        """``dtype``: the JAX module's compute dtype (None: fp32; bf16: the
        s2 fine-tune under ``is_half``, parameters still fp32)."""
        super().__init__()
        c = self.cfg = cfg
        self.enc_p = TextEncoder(
            c.inter_channels, c.hidden_channels, c.filter_channels, c.n_heads,
            c.n_layers, c.kernel_size, c.p_dropout, n_symbols=c.n_symbols,
            ssl_dim=c.ssl_dim, gin_channels=c.gin_channels)
        self.dec = Generator(
            c.inter_channels, c.resblock, tuple(c.resblock_kernel_sizes),
            tuple(tuple(d) for d in c.resblock_dilation_sizes),
            tuple(c.upsample_rates), c.upsample_initial_channel,
            tuple(c.upsample_kernel_sizes), gin_channels=c.gin_channels)
        self.flow = ResidualCouplingBlock(
            c.inter_channels, c.hidden_channels, 5, 1, 4,
            gin_channels=c.gin_channels)
        self.ref_enc = MelStyleEncoder(704, out_dim=c.gin_channels)
        if c.semantic_frame_rate == "25hz":
            self.ssl_proj = nn.Conv1d(c.ssl_dim, c.ssl_dim, 2, stride=2)
        else:
            self.ssl_proj = nn.Conv1d(c.ssl_dim, c.ssl_dim, 1)
        self.quantizer = ResidualVectorQuantizer(dim=c.ssl_dim, n_q=1,
                                                 bins=1024)
        if with_enc_q:
            self.enc_q = PosteriorEncoder(
                c.spec_channels, c.inter_channels, c.hidden_channels, 5, 1,
                16, gin_channels=c.gin_channels)
        if c.freeze_quantizer:
            # as the reference: the frozen projection gets no gradient and
            # no optimizer state (the codebook is a buffer)
            self.ssl_proj.requires_grad_(False)
        set_compute_dtype(self, dtype)

    def _style(self, spec: torch.Tensor,
               spec_mask: torch.Tensor) -> torch.Tensor:
        """Global style vector from the first 704 spectrogram bins (v2)."""
        return self.ref_enc(spec[..., :704] * spec_mask, spec_mask)

    def forward(self, ssl: torch.Tensor, spec: torch.Tensor,
                spec_lengths: torch.Tensor, text: torch.Tensor,
                text_lengths: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                ids_slice: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None):
        """Training forward (JAX synthesizer.py:141-168); needs
        ``with_enc_q``.

        ssl: (B, T, ssl_dim) and spec: (B, T, spec_channels) with T even,
        as ``train/data.py collate_s2`` pads them; text: (B, Tt).  The slice
        starts ``ids_slice`` (B,) and the posterior noise ``eps``
        (B, T, inter_channels) are given, or drawn from ``generator``, which
        also draws the dropout masks in training mode.

        Returns (y_hat (B, segment_size, 1), commit_loss, ids_slice,
        y_mask (B, T, 1), (z, z_p, m_p, logs_p, m_q, logs_q) each
        (B, T, inter_channels)).
        """
        c = self.cfg
        dtype = compute_dtype(self)     # JAX: self.dtype or spec.dtype
        spec_mask = sequence_mask(spec_lengths, spec.shape[1])[
            :, :, None].to(dtype or spec.dtype)
        ge = self._style(spec, spec_mask).transpose(1, 2)   # (B, gin, 1)
        h = conv_in(self.ssl_proj, ssl.transpose(1, 2), dtype).transpose(1, 2)
        if c.freeze_quantizer:
            h = h.detach()
        quantized, _, commit_loss = self.quantizer(h, n_layers=1)
        if c.semantic_frame_rate == "25hz":
            quantized = torch.repeat_interleave(quantized, 2, dim=1)

        _, m_p, logs_p, y_mask = self.enc_p(
            quantized.transpose(1, 2), spec_lengths, text, text_lengths, ge,
            generator=generator)
        z, m_q, logs_q, mask = self.enc_q(
            spec.transpose(1, 2), spec_lengths, g=ge,
            eps=eps.transpose(1, 2) if eps is not None else None,
            generator=generator)
        z_p = self.flow(z, mask, g=ge)

        if ids_slice is None:
            ids_slice = rand_slice_starts(spec_lengths, c.segment_frames,
                                          generator)
        z_slice = slice_segments(z, ids_slice, c.segment_frames)
        y_hat = self.dec(z_slice, g=ge)
        latents = tuple(t.transpose(1, 2)
                        for t in (z, z_p, m_p, logs_p, m_q, logs_q))
        return (y_hat.transpose(1, 2), commit_loss, ids_slice,
                y_mask.transpose(1, 2), latents)

    def decode(self, codes: torch.Tensor, text: torch.Tensor,
               text_lengths: torch.Tensor, refer_spec: torch.Tensor,
               refer_lengths: torch.Tensor, speed: float = 1.0,
               codes_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Synthesis from semantic codes.

        codes: (B, Tc) (padding masked by ``codes_lengths``); text: (B, Tt);
        refer_spec: (R, Tr, 1025) reference spectrograms whose style vectors
        are averaged.  The flow starts from the prior mean: the JAX TTS
        decodes with no posterior noise (``rng=None``) as well.  Returns
        (B, samples, 1).
        """
        refer_mask = sequence_mask(refer_lengths, refer_spec.shape[1])[
            :, :, None].to(refer_spec.dtype)
        ges = self._style(refer_spec, refer_mask)           # (R, 1, gin)
        ge = ges.mean(dim=0, keepdim=True).transpose(1, 2)  # (1, gin, 1)

        quantized = self.quantizer.decode(codes[None])       # (B, Tc, D)
        if self.cfg.semantic_frame_rate == "25hz":
            quantized = torch.repeat_interleave(quantized, 2, dim=1)
        if codes_lengths is None:
            y_lengths = torch.full((codes.shape[0],), quantized.shape[1],
                                   dtype=torch.int64, device=codes.device)
        else:
            y_lengths = codes_lengths * 2

        _, m_p, _, y_mask = self.enc_p(
            quantized.transpose(1, 2), y_lengths, text, text_lengths, ge,
            speed=speed)
        z = self.flow(m_p, y_mask, g=ge, reverse=True)
        return self.dec(z * y_mask, g=ge).transpose(1, 2)

    def extract_latent(self, ssl: torch.Tensor) -> torch.Tensor:
        """SSL features (B, T50, D) -> semantic codes (B, T25)."""
        h = self.ssl_proj(ssl.transpose(1, 2)).transpose(1, 2)
        return self.quantizer.encode(h, n_layers=1)[0]
