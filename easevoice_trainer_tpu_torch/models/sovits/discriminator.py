"""Multi-period + multi-scale waveform discriminators (JAX:
models/sovits/discriminator.py), in the reference torch layout and names:
``discriminators.0`` is the scale discriminator (grouped strided
weight-normed Conv1d), ``discriminators.1..5`` the period discriminators
(periods 2/3/5/7/11, weight-normed (k, 1) Conv2d over a
(time / period, period) view).  Every conv is plain torch: the JAX package's
space-to-depth folds (``_PConv`` / ``_SConv``) lay data out for the TPU and
are not ported.  Inputs are waveforms (B, 1, T); the leaky relus use the JAX
convention (derivative 1 at 0).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import WNConv1d, WNConv2d, leaky_relu


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        chans = [(1, 32), (32, 128), (128, 512), (512, 1024)]
        self.convs = nn.ModuleList(
            WNConv2d(cin, cout, (kernel_size, 1), (stride, 1), (pad, 0))
            for cin, cout in chans)
        self.convs.append(WNConv2d(1024, 1024, (kernel_size, 1), (1, 1),
                                   (pad, 0)))
        self.conv_post = WNConv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x: torch.Tensor):
        """x: (B, 1, T) -> (logits (B, N), feature maps)."""
        b, c, t = x.shape
        if t % self.period != 0:
            n_pad = self.period - t % self.period
            x = F.pad(x, (0, n_pad), mode="reflect")
            t += n_pad
        x = x.view(b, c, t // self.period, self.period)
        fmap: List[torch.Tensor] = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


class DiscriminatorS(nn.Module):
    # (cin, cout, k, stride, groups, padding)
    SPECS = ((1, 16, 15, 1, 1, 7), (16, 64, 41, 4, 4, 20),
             (64, 256, 41, 4, 16, 20), (256, 1024, 41, 4, 64, 20),
             (1024, 1024, 41, 4, 256, 20), (1024, 1024, 5, 1, 1, 2))

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(
            WNConv1d(cin, cout, k, stride=s, groups=g, padding=p)
            for cin, cout, k, s, g, p in self.SPECS)
        self.conv_post = WNConv1d(1024, 1, 3, padding=1)

    def forward(self, x: torch.Tensor):
        fmap: List[torch.Tensor] = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [DiscriminatorS()] + [DiscriminatorP(p) for p in periods])

    def run(self, x: torch.Tensor) -> Tuple[list, list]:
        """One waveform batch (B, 1, T) -> (logits per discriminator,
        feature maps per discriminator)."""
        outs = [d(x) for d in self.discriminators]
        return [o[0] for o in outs], [o[1] for o in outs]

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat: (B, 1, T).  Returns (real logits, fake logits, real
        feature maps, fake feature maps), one entry per discriminator."""
        real_l, real_f = self.run(y)
        fake_l, fake_f = self.run(y_hat)
        return real_l, fake_l, real_f, fake_f
