"""HuBERT-base SSL encoder (chinese-hubert-base), plain torch (JAX:
models/cnhubert.py).

Module names are HF ``HubertModel``'s, so its ``pytorch_model.bin`` loads
with ``load_state_dict(strict=True)`` once :func:`hf_state_for_load` has
dropped the training-only ``masked_spec_embed`` and normalized the weight-norm
key spelling.  Input: raw 16 kHz waveform (B, samples); output
(B, frames, hidden).  With ``lengths`` the first conv's group norm and the
attention ignore padded samples, so a padded batch gives the same frames as
an unpadded one.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import WNConv1d, weight_norm_key


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    layer_norm_eps: float = 1e-5


def feat_output_lengths(lengths, cfg: Optional[HubertConfig] = None):
    """Exact frame count out of the conv frontend (HF
    ``_get_feat_extract_output_lengths``)."""
    cfg = cfg or HubertConfig()
    out = lengths
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        out = (out - k) // s + 1
    return out


class _TimePerChannelNorm(nn.Module):
    """GroupNorm(num_groups=C) on (B, C, T) with optional valid-frame
    statistics (HF ``layer_norm`` of conv layer 0)."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, h: torch.Tensor,
                valid: Optional[torch.Tensor]) -> torch.Tensor:
        if valid is None:
            mean = h.mean(dim=2, keepdim=True)
            var = (h - mean).square().mean(dim=2, keepdim=True)
        else:
            v = valid[:, None, :]
            cnt = v.sum(dim=2, keepdim=True).clamp_min(1.0)
            mean = (h * v).sum(dim=2, keepdim=True) / cnt
            var = ((h - mean).square() * v).sum(dim=2, keepdim=True) / cnt
        out = (h - mean) * torch.rsqrt(var + self.eps)
        return out * self.weight[None, :, None] + self.bias[None, :, None]


class _ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int,
                 norm: Optional[_TimePerChannelNorm]):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, stride=s, bias=False)
        if norm is not None:
            self.layer_norm = norm


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        layers = []
        cin = 1
        for i, (dim, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel,
                                            cfg.conv_stride)):
            norm = (_TimePerChannelNorm(dim, cfg.layer_norm_eps)
                    if i == 0 else None)
            layers.append(_ConvLayer(cin, dim, k, s, norm))
            cin = dim
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, wav: torch.Tensor,
                lengths: Optional[torch.Tensor]) -> torch.Tensor:
        h = wav[:, None]
        for i, layer in enumerate(self.conv_layers):
            h = layer.conv(h)
            if i == 0:
                valid = None
                if lengths is not None:
                    k, s = self.cfg.conv_kernel[0], self.cfg.conv_stride[0]
                    t1 = (lengths - k) // s + 1
                    valid = (torch.arange(h.shape[2], device=h.device)[None]
                             < t1[:, None]).to(h.dtype)
                h = layer.layer_norm(h, valid)
            h = F.gelu(h)
        return h  # (B, C, frames)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1],
                                       eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)


class _PosConv(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        k = cfg.pos_conv_kernel
        # HF weight-norms the positional conv over dim=2 (per kernel tap)
        self.conv = WNConv1d(cfg.hidden_size, cfg.hidden_size, k,
                             padding=k // 2, groups=cfg.pos_conv_groups,
                             dim=2)
        self.trim = k % 2 == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        if self.trim:
            h = h[:, :, :-1]
        return F.gelu(h)


class _Attention(nn.Module):
    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor,
                pad_bias: Optional[torch.Tensor]) -> torch.Tensor:
        b, t, d = x.shape
        h = self.n_heads
        split = lambda z: z.view(b, t, h, d // h).transpose(1, 2)
        q = split(self.q_proj(x)) / math.sqrt(d // h)
        scores = q @ split(self.k_proj(x)).transpose(2, 3)
        if pad_bias is not None:
            scores = scores + pad_bias
        attn = torch.softmax(scores, dim=-1) @ split(self.v_proj(x))
        return self.out_proj(attn.transpose(1, 2).reshape(b, t, d))


class _FeedForward(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(d, inner)
        self.output_dense = nn.Linear(inner, d)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.attention = _Attention(d, cfg.num_heads)
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(d, cfg.intermediate_size)
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x, pad_bias):
        x = self.layer_norm(x + self.attention(x, pad_bias))
        return self.final_layer_norm(x + self.feed_forward(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.pos_conv_embed = _PosConv(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_EncoderLayer(cfg)
                                    for _ in range(cfg.num_layers))


class CNHubert(nn.Module):
    def __init__(self, cfg: HubertConfig = HubertConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureExtractor(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    @torch.no_grad()
    def forward(self, wav: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """wav: (B, samples) 16 kHz -> (B, frames, hidden)."""
        feats = self.feature_extractor(wav, lengths).transpose(1, 2)
        fp = self.feature_projection
        h = fp.projection(fp.layer_norm(feats))
        pad_bias = None
        if lengths is not None:
            frame_lens = feat_output_lengths(lengths, self.cfg)
            valid = (torch.arange(h.shape[1], device=h.device)[None]
                     < frame_lens[:, None])
            zero = torch.zeros((), dtype=h.dtype, device=h.device)
            pad_bias = torch.where(valid, zero, -math.inf)[:, None, None, :]
            h = h * valid[..., None].to(h.dtype)
        enc = self.encoder
        h = h + enc.pos_conv_embed(h.transpose(1, 2)).transpose(1, 2)
        h = enc.layer_norm(h)
        for layer in enc.layers:
            h = layer(h, pad_bias)
        return h


def hf_state_for_load(state: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """HF HubertModel state dict -> this module's: drop the training-only
    ``masked_spec_embed`` and read the parametrized weight-norm spelling."""
    return {weight_norm_key(k): v for k, v in state.items()
            if k != "masked_spec_embed"}


def config_from_hf(model_dir: str) -> HubertConfig:
    """Build a HubertConfig from an HF config.json when present."""
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        return HubertConfig()
    with open(path, encoding="utf8") as f:
        c = json.load(f)
    return HubertConfig(
        conv_dim=tuple(c.get("conv_dim", (512,) * 7)),
        conv_kernel=tuple(c.get("conv_kernel", (10, 3, 3, 3, 3, 2, 2))),
        conv_stride=tuple(c.get("conv_stride", (5, 2, 2, 2, 2, 2, 2))),
        hidden_size=c.get("hidden_size", 768),
        num_layers=c.get("num_hidden_layers", 12),
        num_heads=c.get("num_attention_heads", 12),
        intermediate_size=c.get("intermediate_size", 3072),
        pos_conv_kernel=c.get("num_conv_pos_embeddings", 128),
        pos_conv_groups=c.get("num_conv_pos_embedding_groups", 16),
        layer_norm_eps=c.get("layer_norm_eps", 1e-5),
    )


def load_cnhubert(model_dir: str, device="cuda") -> Optional[CNHubert]:
    """CNHubert with weights from an HF checkpoint directory on ``device``,
    or None when the directory holds no weights."""
    path = os.path.join(model_dir, "pytorch_model.bin")
    if not os.path.exists(path):
        return None
    raw = torch.load(path, map_location="cpu", weights_only=True)
    state = {k: v.to(torch.float32) for k, v in raw.items()
             if isinstance(v, torch.Tensor)}
    model = CNHubert(config_from_hf(model_dir))
    model.load_state_dict(hf_state_for_load(state), strict=True)
    return model.to(device).eval()

