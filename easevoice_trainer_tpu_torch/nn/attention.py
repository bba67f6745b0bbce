"""Attention blocks of the VITS-side encoders on ``(B, C, T)``.

Counterparts of ``easevoice_trainer_tpu/nn/attention.py``: multi-head
attention with learned relative key/value embeddings over a +-window (shared
across heads, Music-Transformer skew), a -1e4 mask value, the conv FFN and
the post-norm rel-pos encoder.  Projections are 1x1 convs named as in the
reference (``conv_q`` ... ``conv_o``).  In training, dropout applies where
the JAX modules apply it (attention probabilities, the FFN's hidden
activation, each sub-block's output), with masks from the ``generator``
passed to ``forward``.

In a bf16 compute dtype (``nn/layers.py set_compute_dtype``) they follow the
JAX modules (nn/attention.py:89-144, :159-166): bf16 projections, the
scores in fp32 from the bf16 q and k (and the bf16 relative embeddings),
the softmax in fp32 with the probabilities rounded to bf16, P V in fp32
rounded to bf16, and the relative-value term added in bf16.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm, cast, compute_dtype, conv_in, dropout, \
    weak_scalar, wide

MASK_VALUE = -1e4


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, 2L-1) relative logits -> (B, H, L, L) absolute logits."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1))
    x = F.pad(x.reshape(b, h, l * 2 * l), (0, l - 1))
    return x.reshape(b, h, l + 1, 2 * l - 1)[:, :, :l, l - 1:]


def _abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, L) attention weights -> (B, H, L, 2L-1) relative layout."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1))
    x = F.pad(x.reshape(b, h, l * l + l * (l - 1)), (l, 0))
    return x.reshape(b, h, l, 2 * l)[:, :, :, 1:]


def _window_embeddings(emb: torch.Tensor, length: int,
                       window: int) -> torch.Tensor:
    """Slice/pad (1, 2w+1, d) learned embeddings to (1, 2L-1, d)."""
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start:start + 2 * length - 1]


class MultiHeadAttention(nn.Module):
    """MHA with optional windowed relative positions; (B, C, T) in/out.

    ``window_size`` requires self-attention (query length == key length).
    """

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: Optional[int] = None, p_dropout: float = 0.0):
        super().__init__()
        self.n_heads = n_heads
        self.window_size = window_size
        self.p_dropout = p_dropout
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, out_channels, 1)
        if window_size is not None:
            dk = channels // n_heads
            std = dk ** -0.5
            self.emb_rel_k = nn.Parameter(
                torch.randn(1, 2 * window_size + 1, dk) * std)
            self.emb_rel_v = nn.Parameter(
                torch.randn(1, 2 * window_size + 1, dk) * std)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dtype = compute_dtype(self)
        q = conv_in(self.conv_q, x, dtype)
        k = conv_in(self.conv_k, c, dtype)
        v = conv_in(self.conv_v, c, dtype)
        b, d, t_t = q.shape
        t_s = k.shape[2]
        h = self.n_heads
        dk = d // h
        q = q.view(b, h, dk, t_t).transpose(2, 3)  # (B, H, Tq, dk)
        k = k.view(b, h, dk, t_s).transpose(2, 3)
        v = v.view(b, h, dk, t_s).transpose(2, 3)

        # products of bf16 operands are taken in fp32 and rounded back to
        # the compute dtype where JAX rounds
        qs = q * weak_scalar(1.0 / math.sqrt(dk), q.dtype)
        scores = wide(qs) @ wide(k).transpose(2, 3)
        if self.window_size is not None:
            if t_s != t_t:
                raise ValueError("relative attention requires self-attention")
            rel_k = _window_embeddings(cast(self.emb_rel_k, dtype), t_s,
                                       self.window_size)
            rel_logits = torch.einsum("bhqd,xmd->bhqm", wide(qs),
                                      wide(rel_k))
            scores = scores + _rel_to_abs(rel_logits)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, MASK_VALUE)
        probs = dropout(cast(torch.softmax(scores, dim=-1), dtype),
                        self.p_dropout, self.training, generator)
        out = (wide(probs) @ wide(v)).to(probs.dtype)
        if self.window_size is not None:
            rel_v = _window_embeddings(cast(self.emb_rel_v, dtype), t_s,
                                       self.window_size)
            out = out + torch.einsum("bhqm,xmd->bhqd",
                                     wide(_abs_to_rel(probs)),
                                     wide(rel_v)).to(out.dtype)
        out = out.transpose(2, 3).reshape(b, d, t_t)
        return conv_in(self.conv_o, out, dtype)


class ConvFFN(nn.Module):
    """Conv feed-forward with masked same-padding."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.pads = ((kernel_size - 1) // 2, kernel_size // 2)
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = nn.Conv1d(filter_channels, out_channels, kernel_size)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dtype = compute_dtype(self)
        y = torch.relu(conv_in(self.conv_1, F.pad(x * x_mask, self.pads),
                               dtype))
        y = dropout(y, self.p_dropout, self.training, generator)
        y = conv_in(self.conv_2, F.pad(y * x_mask, self.pads), dtype)
        return y * x_mask


class RelPosEncoder(nn.Module):
    """Stack of post-norm rel-pos attention + conv-FFN blocks (the
    reference ``attentions.Encoder``)."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 p_dropout: float = 0.0, window_size: int = 4):
        super().__init__()
        self.p_dropout = p_dropout
        self.attn_layers = nn.ModuleList()
        self.norm_layers_1 = nn.ModuleList()
        self.ffn_layers = nn.ModuleList()
        self.norm_layers_2 = nn.ModuleList()
        for _ in range(n_layers):
            self.attn_layers.append(MultiHeadAttention(
                hidden_channels, hidden_channels, n_heads,
                window_size=window_size, p_dropout=p_dropout))
            self.norm_layers_1.append(LayerNorm(hidden_channels))
            self.ffn_layers.append(ConvFFN(
                hidden_channels, hidden_channels, filter_channels,
                kernel_size, p_dropout))
            self.norm_layers_2.append(LayerNorm(hidden_channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, C, T); x_mask: (B, 1, T)."""
        attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)
        x = x * x_mask
        for attn, norm1, ffn, norm2 in zip(self.attn_layers,
                                           self.norm_layers_1,
                                           self.ffn_layers,
                                           self.norm_layers_2):
            y = attn(x, x, attn_mask, generator)
            x = norm1(x + dropout(y, self.p_dropout, self.training,
                                  generator))
            y = ffn(x, x_mask, generator)
            x = norm2(x + dropout(y, self.p_dropout, self.training,
                                  generator))
        return x * x_mask
