"""Non-causal WaveNet stack on ``(B, C, T)`` (JAX: nn/wavenet.py): per layer
a weight-normed dilated conv to 2*hidden channels, gated tanh/sigmoid with
additive global conditioning, then a 1x1 res/skip projection."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import WNConv1d


def gated_activation(x: torch.Tensor, g: torch.Tensor,
                     channels: int) -> torch.Tensor:
    a = x + g
    return torch.tanh(a[:, :channels]) * torch.sigmoid(a[:, channels:])


class WaveNet(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.n_layers = n_layers
        hc = hidden_channels
        if gin_channels > 0:
            self.cond_layer = WNConv1d(gin_channels, 2 * hc * n_layers, 1)
        else:
            self.cond_layer = None
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            self.in_layers.append(WNConv1d(hc, 2 * hc, kernel_size,
                                           dilation=dilation_rate ** i))
            out = 2 * hc if i < n_layers - 1 else hc
            self.res_skip_layers.append(WNConv1d(hc, out, 1))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, hidden, T); x_mask: (B, 1, T); g: (B, gin, 1) or None."""
        hc = self.hidden_channels
        output = torch.zeros_like(x)
        g_all = (self.cond_layer(g)
                 if g is not None and self.cond_layer is not None else None)
        for i, (in_layer, res_skip_layer) in enumerate(
                zip(self.in_layers, self.res_skip_layers)):
            x_in = in_layer(x)
            g_l = (g_all[:, i * 2 * hc:(i + 1) * 2 * hc]
                   if g_all is not None else torch.zeros_like(x_in))
            acts = gated_activation(x_in, g_l, hc)
            res_skip = res_skip_layer(acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :hc]) * x_mask
                output = output + res_skip[:, hc:]
            else:
                output = output + res_skip
        return output * x_mask
