"""s2 prior text/SSL encoder with multi-reference timbre cross-attention
(JAX: models/sovits/text_encoder.py), on (B, C, T).

Dropout (``p_dropout``) runs in the three rel-pos encoders in training, as
in the JAX package; MRTE's cross-attention has none there (its
``MultiHeadAttention`` keeps the default p=0), so it has none here."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...nn.attention import MultiHeadAttention, RelPosEncoder
from ...nn.layers import cast, compute_dtype, conv_in, sequence_mask


class MRTE(nn.Module):
    """Multi-reference timbre encoder (cross-attention content -> text)."""

    def __init__(self, content_channels: int = 192, hidden_size: int = 512,
                 out_channels: int = 192, n_heads: int = 4):
        super().__init__()
        self.cross_attention = MultiHeadAttention(hidden_size, hidden_size,
                                                  n_heads)
        self.c_pre = nn.Conv1d(content_channels, hidden_size, 1)
        self.text_pre = nn.Conv1d(content_channels, hidden_size, 1)
        self.c_post = nn.Conv1d(hidden_size, out_channels, 1)

    def forward(self, ssl_enc, ssl_mask, text, text_mask, ge):
        """ssl_enc: (B, C, Ts); text: (B, C, Tt); masks (B, 1, T);
        ge: (B|1, hidden, 1)."""
        dtype = compute_dtype(self)
        attn_mask = ssl_mask.unsqueeze(-1) * text_mask.unsqueeze(2)
        c = conv_in(self.c_pre, ssl_enc * ssl_mask, dtype)
        t = conv_in(self.text_pre, text * text_mask, dtype)
        x = self.cross_attention(c * ssl_mask, t * text_mask, attn_mask)
        x = x + c + ge
        return conv_in(self.c_post, x * ssl_mask, dtype)


class TextEncoder(nn.Module):
    def __init__(self, out_channels: int = 192, hidden_channels: int = 192,
                 filter_channels: int = 768, n_heads: int = 2,
                 n_layers: int = 6, kernel_size: int = 3,
                 p_dropout: float = 0.0, n_symbols: int = 732,
                 ssl_dim: int = 768, gin_channels: int = 512):
        super().__init__()
        self.out_channels = out_channels
        self.ssl_proj = nn.Conv1d(ssl_dim, hidden_channels, 1)
        self.encoder_ssl = RelPosEncoder(hidden_channels, filter_channels,
                                         n_heads, n_layers // 2, kernel_size,
                                         p_dropout)
        self.text_embedding = nn.Embedding(n_symbols, hidden_channels)
        self.encoder_text = RelPosEncoder(hidden_channels, filter_channels,
                                          n_heads, n_layers, kernel_size,
                                          p_dropout)
        self.mrte = MRTE(hidden_channels, gin_channels, hidden_channels)
        self.encoder2 = RelPosEncoder(hidden_channels, filter_channels,
                                      n_heads, n_layers // 2, kernel_size,
                                      p_dropout)
        self.proj = nn.Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, y, y_lengths, text, text_lengths, ge,
                speed: float = 1.0,
                generator: Optional[torch.Generator] = None):
        """y: quantized SSL (B, ssl_dim, Ts); text: (B, Tt) int;
        ge: (B, gin, 1); ``generator`` draws the dropout masks in training.
        Returns (encoded (B, C, Ts), m_p, logs_p, y_mask (B, 1, Ts))."""
        dtype = compute_dtype(self)
        mask_dtype = dtype or y.dtype
        y_mask = sequence_mask(y_lengths, y.shape[2])[:, None].to(mask_dtype)
        text_mask = sequence_mask(text_lengths, text.shape[1])[:, None].to(
            mask_dtype)
        y = conv_in(self.ssl_proj, y * y_mask, dtype) * y_mask
        y = self.encoder_ssl(y * y_mask, y_mask, generator)
        t = cast(self.text_embedding(text), dtype).transpose(1, 2)
        t = self.encoder_text(t * text_mask, text_mask, generator)
        y = self.mrte(y, y_mask, t, text_mask, ge)
        y = self.encoder2(y * y_mask, y_mask, generator)

        if speed != 1.0:
            new_len = int(y.shape[2] / speed) + 1
            y = _linear_resize_time(y, new_len)
            y_mask = _nearest_resize_time(y_mask, new_len)

        stats = conv_in(self.proj, y, dtype) * y_mask
        m, logs = stats[:, :self.out_channels], stats[:, self.out_channels:]
        return y, m, logs, y_mask


def _linear_resize_time(x: torch.Tensor, new_len: int) -> torch.Tensor:
    """torch F.interpolate(mode='linear', align_corners=False) on the last
    axis, written as the JAX package computes it."""
    t = x.shape[-1]
    pos = ((torch.arange(new_len, dtype=torch.float32, device=x.device) + 0.5)
           * (t / new_len) - 0.5)
    lo = pos.floor().to(torch.int64).clamp(0, t - 1)
    hi = (lo + 1).clamp(0, t - 1)
    w = (pos - lo.to(torch.float32)).clamp(0.0, 1.0)
    return x[..., lo] * (1.0 - w) + x[..., hi] * w


def _nearest_resize_time(x: torch.Tensor, new_len: int) -> torch.Tensor:
    t = x.shape[-1]
    idx = ((torch.arange(new_len, device=x.device) * t) // new_len).clamp(
        0, t - 1)
    return x[..., idx]
