"""s1 GPT: autoregressive text -> semantic-token transformer, inference half
(JAX: models/gpt/t2s.py).

Phoneme embedding + projected BERT features + sine positions for the text,
token embedding + sine positions for the semantic tokens, a post-norm
transformer over ``[x; y]`` with the hybrid mask, and a bias-free projection
to the vocabulary.  Module names follow the reference state dict
(``h.layers.{i}.self_attn.in_proj_weight`` ...).  The prefill attention runs
on kernel K1 and each decode step's attention on kernel K2; the projections
around them are torch matmuls.  The hybrid mask's plain form,
``build_hybrid_mask_bias``, lives beside K1 in ``ops/attention.py``.  The
LayerNorms use the JAX package's epsilon (1e-6, flax's default), which the
parity tests hold the port to.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import decode_attention, prefill_attention

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class T2SConfig:
    """Mirrors configs/gpt.yaml "model"."""

    vocab_size: int = 1025
    phoneme_vocab_size: int = 732
    embedding_dim: int = 512
    hidden_dim: int = 512
    n_heads: int = 16
    n_layers: int = 24
    ffn_dim: int = 2048
    dropout: float = 0.0
    eos_id: int = 1024
    max_position: int = 4000

    @classmethod
    def from_yaml_dict(cls, d: dict) -> "T2SConfig":
        m = d.get("model", d)
        return cls(
            vocab_size=m.get("vocab_size", 1025),
            phoneme_vocab_size=m.get("phoneme_vocab_size", 732),
            embedding_dim=m.get("embedding_dim", 512),
            hidden_dim=m.get("hidden_dim", 512),
            n_heads=m.get("head", m.get("n_heads", 16)),
            n_layers=m.get("n_layer", m.get("n_layers", 24)),
            ffn_dim=m.get("linear_units", m.get("ffn_dim", 2048)),
            dropout=m.get("dropout", 0.0),
            eos_id=m.get("EOS", m.get("eos_id", 1024)),
        )


def sine_positions(length: int, dim: int) -> torch.Tensor:
    """(length, dim) sinusoidal table (sin on even, cos on odd channels)."""
    pos = np.arange(length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * -(np.log(10000.0) / dim))
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)


class SinePositionalEmbedding(nn.Module):
    """x + alpha * PE[offset : offset + T]; alpha is a learned scalar."""

    def __init__(self, dim: int, max_len: int = 4000):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1))
        self.register_buffer("pe", sine_positions(max_len, dim),
                             persistent=False)

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        return x + self.alpha * self.pe[offset:offset + x.shape[1]]


class TokenEmbedding(nn.Module):
    def __init__(self, dim: int, vocab_size: int):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.word_embeddings(x)


class _SelfAttention(nn.Module):
    """Fused qkv projection + output projection (nn.MultiheadAttention's
    parameter names)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = nn.Linear(d_model, d_model)


class TransformerLayer(nn.Module):
    """Post-norm encoder layer for the full (prefill) and incremental
    (decode) passes."""

    def __init__(self, d_model: int, n_heads: int, ffn_dim: int):
        super().__init__()
        self.d_model = d_model
        self.n_heads = n_heads
        self.self_attn = _SelfAttention(d_model)
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def qkv(self, x: torch.Tensor):
        """(B, T, D) -> q, k, v as (B, T, H, dk) views of one projection."""
        b, t, _ = x.shape
        qkv = F.linear(x, self.self_attn.in_proj_weight,
                       self.self_attn.in_proj_bias)
        dk = self.d_model // self.n_heads
        return [z.view(b, t, self.n_heads, dk)
                for z in qkv.split(self.d_model, dim=-1)]

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(torch.relu(self.linear1(x)))

    def attention(self, x, x_len: int, x_lens, y_lens):
        """Full self-attention under the hybrid mask (kernel K1).
        Returns (out (B, T, D), (k, v) each (B, T, H, dk))."""
        q, k, v = self.qkv(x)
        o = prefill_attention(q, k, v, x_len, x_lens, y_lens)
        return self.self_attn.out_proj(o.reshape(x.shape)), (k, v)

    def forward(self, x, x_len: int, x_lens, y_lens):
        y, kv = self.attention(x, x_len, x_lens, y_lens)
        x = self.norm1(x + y)
        x = self.norm2(x + self.ffn(x))
        return x, kv


class _Layers(nn.Module):
    def __init__(self, cfg: T2SConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerLayer(cfg.hidden_dim, cfg.n_heads, cfg.ffn_dim)
            for _ in range(cfg.n_layers))


class Text2SemanticDecoder(nn.Module):
    def __init__(self, cfg: T2SConfig = T2SConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.bert_proj = nn.Linear(1024, c.embedding_dim)
        self.ar_text_embedding = TokenEmbedding(c.embedding_dim,
                                                c.phoneme_vocab_size)
        self.ar_audio_embedding = TokenEmbedding(c.embedding_dim,
                                                 c.vocab_size)
        self.ar_text_position = SinePositionalEmbedding(c.embedding_dim,
                                                        c.max_position)
        self.ar_audio_position = SinePositionalEmbedding(c.embedding_dim,
                                                         c.max_position)
        self.h = _Layers(c)
        self.ar_predict_layer = nn.Linear(c.hidden_dim, c.vocab_size,
                                          bias=False)

    def embed_text(self, x, bert_feature):
        """x: (B, Tx) phoneme ids; bert_feature: (B, Tx, 1024)."""
        h = self.ar_text_embedding(x) + self.bert_proj(bert_feature)
        return self.ar_text_position(h)

    def embed_audio(self, y, offset: int = 0):
        return self.ar_audio_position(self.ar_audio_embedding(y), offset)

    @torch.no_grad()
    def prefill(self, x, x_lens, prompts, bert_feature, cache_len: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Run text + audio prompt and build the KV cache.

        Returns (first_logits (B, V), k_caches, v_caches
        (L, B, cache_len, H, dk)); slots [0, x_len + prompt_len) are filled.
        """
        c = self.cfg
        b, x_len = x.shape
        y_len = prompts.shape[1]
        t = x_len + y_len
        h = torch.cat([self.embed_text(x, bert_feature),
                       self.embed_audio(prompts)], dim=1)
        y_lens = torch.full((b,), y_len, dtype=torch.int32, device=x.device)
        dk = c.hidden_dim // c.n_heads
        shape = (c.n_layers, b, cache_len, c.n_heads, dk)
        k_caches = torch.zeros(shape, dtype=h.dtype, device=h.device)
        v_caches = torch.zeros(shape, dtype=h.dtype, device=h.device)
        for i, layer in enumerate(self.h.layers):
            h, (k, v) = layer(h, x_len, x_lens, y_lens)
            k_caches[i, :, :t] = k
            v_caches[i, :, :t] = v
        return self.ar_predict_layer(h[:, -1]), k_caches, v_caches

    @torch.no_grad()
    def decode_step(self, token, step: int, k_caches, v_caches, x_len: int,
                    x_lens, prompt_len: int) -> torch.Tensor:
        """token: (B,) the step-th generated token, at y-stream position
        prompt_len + step and cache slot x_len + prompt_len + step.  Writes
        its K/V into the caches in place and returns the next logits
        (B, V)."""
        h = self.embed_audio(token[:, None], offset=prompt_len + step)
        for i, layer in enumerate(self.h.layers):
            q, k, v = layer.qkv(h)
            o = decode_attention(q, k, v, k_caches[i], v_caches[i], x_len,
                                 x_lens, prompt_len, step)
            h = layer.norm1(h + layer.self_attn.out_proj(o.reshape(h.shape)))
            h = layer.norm2(h + layer.ffn(h))
        return self.ar_predict_layer(h[:, 0])
