"""Normalizing flow between prior and posterior latents (JAX:
models/sovits/flow.py): mean-only affine couplings interleaved with channel
flips.  Flows sit at even indices of ``flows`` and the parameter-free flips
at odd ones, as in the reference state dict."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...nn.wavenet import WaveNet


class ResidualCouplingLayer(nn.Module):
    def __init__(self, channels: int = 192, hidden_channels: int = 192,
                 kernel_size: int = 5, dilation_rate: int = 1,
                 n_layers: int = 4, gin_channels: int = 512):
        super().__init__()
        self.half = channels // 2
        self.pre = nn.Conv1d(self.half, hidden_channels, 1)
        self.enc = WaveNet(hidden_channels, kernel_size, dilation_rate,
                           n_layers, gin_channels=gin_channels)
        self.post = nn.Conv1d(hidden_channels, self.half, 1)
        # zero-initialized as in the reference: identity coupling at init
        nn.init.zeros_(self.post.weight)
        nn.init.zeros_(self.post.bias)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g=g)
        m = self.post(h) * x_mask
        x1 = (m + x1) * x_mask if not reverse else (x1 - m) * x_mask
        return torch.cat([x0, x1], dim=1)


class Flip(nn.Module):
    def forward(self, x, *args, **kwargs):
        return torch.flip(x, dims=[1])


class ResidualCouplingBlock(nn.Module):
    def __init__(self, channels: int = 192, hidden_channels: int = 192,
                 kernel_size: int = 5, dilation_rate: int = 1,
                 n_layers: int = 4, n_flows: int = 4,
                 gin_channels: int = 512):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate,
                n_layers, gin_channels))
            self.flows.append(Flip())

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                reverse: bool = False) -> torch.Tensor:
        """x: (B, C, T); x_mask: (B, 1, T); g: (B, gin, 1)."""
        flows = self.flows if not reverse else reversed(self.flows)
        for flow in flows:
            x = flow(x, x_mask, g=g, reverse=reverse)
        return x
