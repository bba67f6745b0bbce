"""Global style encoder over the reference spectrogram (JAX:
models/sovits/mel_style.py): spectral MLP (Mish) -> two Conv1dGLU blocks ->
self-attention with temperature sqrt(hidden) -> linear -> masked temporal
mean.  Module names follow the reference state dict (``spectral.0.fc``,
``temporal.0.conv1.conv``, ``slf_attn.w_qs`` ...)."""
from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class _Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class _LinearNorm(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, out_dim)

    def forward(self, x):
        return self.fc(x)


class _ConvNorm(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.pads = ((kernel_size - 1) // 2, kernel_size // 2)
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size)

    def forward(self, x):
        return self.conv(F.pad(x, self.pads))


class Conv1dGLU(nn.Module):
    """Residual gated conv on (B, C, T)."""

    def __init__(self, channels: int, kernel_size: int = 5):
        super().__init__()
        self.channels = channels
        self.conv1 = _ConvNorm(channels, 2 * channels, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x)
        a, b = y[:, :self.channels], y[:, self.channels:]
        return x + a * torch.sigmoid(b)


class _SelfAttention(nn.Module):
    def __init__(self, n_heads: int, d_model: int):
        super().__init__()
        self.n_heads = n_heads
        self.d_model = d_model
        self.w_qs = nn.Linear(d_model, d_model)
        self.w_ks = nn.Linear(d_model, d_model)
        self.w_vs = nn.Linear(d_model, d_model)
        self.fc = nn.Linear(d_model, d_model)

    def forward(self, y: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        """y: (B, T, d); x_mask: (B, T, 1)."""
        b, t, d = y.shape
        h = self.n_heads
        split = lambda z: z.view(b, t, h, d // h).transpose(1, 2)
        q, k, v = split(self.w_qs(y)), split(self.w_ks(y)), split(self.w_vs(y))
        scores = q @ k.transpose(2, 3) / math.sqrt(self.d_model)
        valid = x_mask[:, None, None, :, 0] > 0
        scores = scores.masked_fill(~valid, -math.inf)
        attn = torch.softmax(scores, dim=-1) @ v
        return self.fc(attn.transpose(1, 2).reshape(b, t, d))


class MelStyleEncoder(nn.Module):
    def __init__(self, in_dim: int = 704, hidden_dim: int = 128,
                 out_dim: int = 512, kernel_size: int = 5, n_heads: int = 2):
        super().__init__()
        # Identity slots stand where the reference keeps its dropouts, so the
        # Linear layers sit at indices 0 and 3
        self.spectral = nn.Sequential(
            _LinearNorm(in_dim, hidden_dim), _Mish(), nn.Identity(),
            _LinearNorm(hidden_dim, hidden_dim), _Mish(), nn.Identity())
        self.temporal = nn.Sequential(Conv1dGLU(hidden_dim, kernel_size),
                                      Conv1dGLU(hidden_dim, kernel_size))
        self.slf_attn = _SelfAttention(n_heads, hidden_dim)
        self.fc = _LinearNorm(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        """x: (B, T, in_dim) frames; x_mask: (B, T, 1).  -> (B, 1, out)."""
        y = self.spectral(x)
        y = self.temporal(y.transpose(1, 2)).transpose(1, 2) * x_mask
        y = y + self.slf_attn(y, x_mask)
        y = self.fc(y) * x_mask
        denom = x_mask.sum(dim=1, keepdim=True).clamp_min(1.0)
        return y.sum(dim=1, keepdim=True) / denom
