"""HiFi-GAN waveform generator (JAX: models/sovits/generator.py) on
(B, C, T).

conv_pre, the style conditioning, the transposed-conv upsamples and conv_post
are plain torch.  Every ResBlock conv runs on kernel K3
(:func:`~easevoice_trainer_tpu_torch.ops.mrf_conv`), which applies the leaky
relu as it loads the input and adds the bias and the residual as it stores.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...nn.layers import WNConv1d, WNConvTranspose1d, compute_dtype, \
    conv_in, leaky_relu
from ...ops import mrf_conv


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size) for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = compute_dtype(self)
        for c1, c2, d in zip(self.convs1, self.convs2, self.dilations):
            xt = mrf_conv(x, c1.weight_as(dtype), c1.bias_as(dtype), d)
            x = mrf_conv(xt, c2.weight_as(dtype), c2.bias_as(dtype), 1,
                         residual=x)
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d)
            for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = compute_dtype(self)
        for c, d in zip(self.convs, self.dilations):
            x = mrf_conv(x, c.weight_as(dtype), c.bias_as(dtype), d,
                         residual=x)
        return x


class Generator(nn.Module):
    def __init__(self, initial_channel: int = 192, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = (
                     (1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (10, 8, 2, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 8, 2, 2),
                 gin_channels: int = 512):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        block = ResBlock1 if resblock == "1" else ResBlock2
        self.conv_pre = nn.Conv1d(initial_channel, upsample_initial_channel,
                                  7, padding=3)
        self.cond = (nn.Conv1d(gin_channels, upsample_initial_channel, 1)
                     if gin_channels > 0 else None)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates,
                                       upsample_kernel_sizes)):
            ch_out = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(WNConvTranspose1d(ch, ch_out, k, u,
                                              padding=(k - u) // 2))
            ch = ch_out
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(block(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, x: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, initial_channel, T) latent; g: (B, gin, 1).
        Returns (B, 1, T * prod(upsample_rates))."""
        dtype = compute_dtype(self)
        x = conv_in(self.conv_pre, x, dtype)
        if g is not None and self.cond is not None:
            x = x + conv_in(self.cond, g, dtype)
        n = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x))
            xs = None
            for block in self.resblocks[i * n:(i + 1) * n]:
                y = block(x)
                xs = y if xs is None else xs + y
            x = xs / n
        x = conv_in(self.conv_post, leaky_relu(x, 0.01), dtype)
        return torch.tanh(x)
