"""Residual vector quantizer (JAX: models/sovits/quantize.py).  Module names
follow the reference state dict: ``vq.layers.{i}._codebook.embed`` of shape
(bins, dim).

The codebook is a buffer, as in the reference: the s2 fine-tune freezes the
quantizer (``freeze_quantizer``), so it never receives a gradient and the
EMA update of from-scratch training is not ported."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def nearest_code(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_k ||x - c_k||^2 for x (..., D), codebook (K, D) -> (...,)."""
    flat = x.reshape(-1, x.shape[-1]).float()   # in fp32, as in JAX
    scores = 2.0 * flat @ codebook.T - (codebook * codebook).sum(-1)[None, :]
    return scores.argmax(dim=-1).reshape(x.shape[:-1])


class _Codebook(nn.Module):
    def __init__(self, bins: int, dim: int):
        super().__init__()
        self.register_buffer("embed", torch.rand(bins, dim))


class _VQLayer(nn.Module):
    def __init__(self, bins: int, dim: int):
        super().__init__()
        self._codebook = _Codebook(bins, dim)


class _VQ(nn.Module):
    def __init__(self, n_q: int, bins: int, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(_VQLayer(bins, dim) for _ in range(n_q))


class ResidualVectorQuantizer(nn.Module):
    def __init__(self, dim: int = 768, n_q: int = 1, bins: int = 1024):
        super().__init__()
        self.n_q = n_q
        self.vq = _VQ(n_q, bins, dim)

    def codebook(self, q: int) -> torch.Tensor:
        return self.vq.layers[q]._codebook.embed

    def forward(self, x: torch.Tensor, n_layers: Optional[int] = None):
        """Training forward (JAX quantize.py:62-83).  x: (B, T, D) ->
        (quantized (B, T, D) through the straight-through estimator, codes
        (n_layers, B, T) int64, commit loss)."""
        residual = x
        quantized = torch.zeros_like(x)
        codes = []
        commit = x.new_zeros((), dtype=torch.float32)
        for q in range(n_layers or self.n_q):
            cb = self.codebook(q)
            idx = nearest_code(residual.detach(), cb)
            quant = cb[idx].detach().to(x.dtype)
            codes.append(idx)
            commit = commit + ((residual - quant).float() ** 2).mean()
            quantized = quantized + residual + (quant - residual).detach()
            residual = residual - quant
        return quantized, torch.stack(codes, dim=0), commit

    def encode(self, x: torch.Tensor,
               n_layers: Optional[int] = None) -> torch.Tensor:
        """(B, T, D) -> codes (n_layers, B, T) int64."""
        residual = x
        codes = []
        for q in range(n_layers or self.n_q):
            cb = self.codebook(q)
            idx = nearest_code(residual, cb)
            codes.append(idx)
            residual = residual - cb[idx]
        return torch.stack(codes, dim=0)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (n_layers, B, T) -> (B, T, D)."""
        out = 0.0
        for q in range(codes.shape[0]):
            out = out + self.codebook(q)[codes[q]]
        return out
