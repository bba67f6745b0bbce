"""Posterior spectrogram encoder ``enc_q`` (JAX: models/sovits/posterior.py):
1x1 pre-projection -> 16-layer WaveNet conditioned on the detached style
vector -> 1x1 projection to (m, logs); z = (m + eps * exp(logs)) * mask.
Used by training only."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...nn.layers import compute_dtype, conv_in, sequence_mask
from ...nn.wavenet import WaveNet


class PosteriorEncoder(nn.Module):
    def __init__(self, in_channels: int = 1025, out_channels: int = 192,
                 hidden_channels: int = 192, kernel_size: int = 5,
                 dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 512):
        super().__init__()
        self.out_channels = out_channels
        self.pre = nn.Conv1d(in_channels, hidden_channels, 1)
        self.enc = WaveNet(hidden_channels, kernel_size, dilation_rate,
                           n_layers, gin_channels=gin_channels)
        self.proj = nn.Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """x: (B, in, T); g: (B, gin, 1).  The noise ``eps`` (B, out, T) is
        given, or drawn from ``generator``.  Returns (z, m, logs, x_mask
        (B, 1, T))."""
        dtype = compute_dtype(self)
        x_mask = sequence_mask(x_lengths, x.shape[2])[:, None].to(
            dtype or x.dtype)
        if g is not None:
            g = g.detach()  # the reference detaches the style vector here
        h = conv_in(self.pre, x, dtype) * x_mask
        h = self.enc(h, x_mask, g=g)
        stats = conv_in(self.proj, h, dtype) * x_mask
        m, logs = stats[:, :self.out_channels], stats[:, self.out_channels:]
        if eps is None:
            if generator is None:
                raise ValueError("PosteriorEncoder: give eps or a "
                                 "torch.Generator to draw it from")
            eps = torch.randn(m.shape, generator=generator, device=m.device,
                              dtype=m.dtype)
        # JAX draws the noise in the compute dtype
        z = (m + eps.to(m.dtype) * torch.exp(logs)) * x_mask
        return z, m, logs, x_mask
