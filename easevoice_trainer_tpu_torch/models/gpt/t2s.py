"""s1 GPT: autoregressive text -> semantic-token transformer (JAX:
models/gpt/t2s.py).

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

``Text2SemanticDecoder.forward`` is the training forward (the JAX
``__call__``): every layer's attention goes through
``ops.attention.self_attention``, K1 forward and K5 backward on the card.
With ``T2SConfig.dropout > 0`` (``configs/gpt.yaml`` ships 0) a module in
training mode drops where the JAX layer does with ``deterministic=False``
(t2s.py:128, :155, :160, :162), in its order: the attention probabilities
inside K1 (K5 draws the same mask again; the twins on the CPU), then the
attention output, the FFN's hidden layer and the FFN output through
``nn.layers.dropout``.  One host integer ``seed`` a forward draws them
all: the probabilities' masks are Philox of (seed ^ ATTENTION_KEY, layer,
batch row, head, query, key) (``ops/philox.py``), the other three sites'
come from a ``torch.Generator`` on the model's device seeded with
``seed``.  The same seed gives the same masks for sequences of one shape,
which DPO's chosen and rejected passes are (JAX's shared ``rngs``).  In
eval mode, at rate 0 and in the serving passes nothing is drawn.  A rank of
a data-parallel step passes ``rows`` (``nn.layers.BatchRows``): the
probabilities' masks are keyed by the global batch row (``row0`` of
``AttentionDropout``) and the other sites' are drawn at the global batch's
shape, of which the rank keeps its rows, so a world of ranks draws exactly
what one process draws on the global batch.

Tensor parallelism (``parallel/gpt_sharding.py``): a model built with
``tp=(m, n_model)`` holds shard m of each layer's qkv and FFN projections
(``TransformerLayer``), under the whole model's parameter names, and its
training forward runs the layer's heads ``m * H / n_model ..`` and FFN
columns on this rank, joined to the model group's other ranks by
Megatron's f and g.  Its dropout draws the whole model's masks: K1 / K5
key the probabilities' bits by the layer's head (``h0`` of
``AttentionDropout``), the FFN hidden layer's mask is drawn at the whole
width and the rank keeps its column block (``RankGenerator.column_block``),
and the two other sites act on tensors that every rank of the group holds
whole.  The serving passes (``prefill``, ``decode_step``) run whole models
only.

``dtype`` (the JAX module's): None computes in fp32; bfloat16 is the s1
fine-tune under ``is_half`` (JAX ``train/gpt.py:162-163``).  Parameters stay
fp32.  As flax computes the JAX module then: the dense layers (``bert_proj``,
``qkv``, ``out``, ``linear1`` / ``linear2``, ``ar_predict_layer``) cast their
input and weight to bf16 and return bf16; the embeddings and LayerNorms
return fp32, so every layer boundary and residual sum (fp32 + bf16) is
fp32; the attention is K1 / K5's bf16 instances (``ops/attention.py``); the
loss and accuracy take the logits in fp32.  The serving passes
(``prefill``, ``decode_step``) are fp32, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import BatchRows, RankGenerator, compute_dtype, \
    dropout, linear_in, set_compute_dtype
from ...ops import decode_attention, prefill_attention, self_attention
from ...ops.attention import AttentionDropout
from ...parallel.gpt_sharding import copy_to_model, row_parallel_linear

# (model index, n_model) of a tensor-parallel shard; None: the whole model
TP = Optional[Tuple[int, int]]

LN_EPS = 1e-6
# XORed into a forward's seed for the Philox key of the attention masks, so
# that they never share a key with the generator of the other sites (torch's
# CUDA generator is a Philox keyed by its seed)
ATTENTION_KEY = 0x9E3779B97F4A7C15


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
    parameter names), of ``width`` projected channels (d_model, or its
    shard's d_model / n_model)."""

    def __init__(self, d_model: int, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = nn.Linear(width, d_model)


@dataclasses.dataclass(frozen=True)
class LayerRng:
    """What one layer's dropout draws from in a training forward: the
    forward's seed, the layer's index, the forward's generator (a
    ``RankGenerator`` on a data-parallel rank) and the global batch row of
    the forward's batch row 0."""

    seed: int
    layer: int
    generator: Union[torch.Generator, RankGenerator]
    row0: int = 0


class TransformerLayer(nn.Module):
    """Post-norm encoder layer for the full (prefill) and incremental
    (decode) passes; ``dropout`` is the JAX layer's rate, taken by
    ``train_forward`` alone.  With ``tp=(m, n_model)`` it is shard m
    (``parallel/gpt_sharding.py``): ``in_proj_weight`` (3D / n_model, D)
    holding the q, k and v rows of heads ``m * H / n_model ..``, with its
    bias; ``out_proj.weight`` (D, D / n_model); ``linear1`` (F / n_model,
    D); ``linear2.weight`` (D, F / n_model); ``out_proj`` and ``linear2``
    keep their whole biases, and the norms are whole."""

    def __init__(self, d_model: int, n_heads: int, ffn_dim: int,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.0,
                 tp: TP = None):
        super().__init__()
        n = tp[1] if tp is not None else 1
        if n_heads % n or ffn_dim % n:
            raise ValueError(f"TransformerLayer: {n_heads} heads and FFN "
                             f"{ffn_dim} do not split over {n} model ranks")
        self.d_model = d_model
        self.n_heads = n_heads
        self.dropout = dropout
        self.tp = tp
        self.self_attn = _SelfAttention(d_model, d_model // n)
        self.linear1 = nn.Linear(d_model, ffn_dim // n)
        self.linear2 = nn.Linear(ffn_dim // n, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        set_compute_dtype(self, dtype)

    def qkv(self, x: torch.Tensor):
        """(B, T, D) -> q, k, v as (B, T, H, dk) views of one projection."""
        if self.tp is not None:
            raise ValueError("TransformerLayer: a tensor-parallel shard "
                             "trains; serving runs the whole model")
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

    def train_forward(self, x, x_len: int, x_lens, y_lens,
                      rng: Optional[LayerRng] = None):
        """The layer under autograd: attention on the fused projection
        through ``self_attention`` (K1 forward, K5 backward), in the compute
        dtype (the layer's input and output stay fp32).  With ``rng`` and a
        rate above 0 it drops at the JAX layer's four sites, in its order:
        the probabilities (K1 / K5 keyed by ``rng.seed`` and
        ``rng.layer``), then the attention output, the FFN's hidden layer
        and the FFN output (from ``rng.generator``).  A shard (``tp``) runs
        its heads and FFN columns between f and g (the module note)."""
        split = self.tp is not None
        m, n = self.tp if split else (0, 1)
        heads = self.n_heads // n
        p = self.dropout if rng is not None else 0.0
        attn_drop = AttentionDropout(p, rng.seed, rng.layer, rng.row0,
                                     m * heads) if p else None
        gen = rng.generator if p else None
        dtype = compute_dtype(self)
        xin = copy_to_model(x) if split else x
        if dtype is None:
            qkv = F.linear(xin, self.self_attn.in_proj_weight,
                           self.self_attn.in_proj_bias)
        else:   # flax DenseGeneral(dtype=bf16): bf16 product, bf16 bias add
            qkv = F.linear(xin.to(dtype),
                           self.self_attn.in_proj_weight.to(dtype)) \
                + self.self_attn.in_proj_bias.to(dtype)
        o = self_attention(qkv, heads, x_len, x_lens, y_lens, attn_drop)
        # the row-parallel products end in g and add their biases after it
        out = row_parallel_linear if split else linear_in
        y = out(self.self_attn.out_proj, o.reshape(*x.shape[:2], -1), dtype)
        x = self.norm1(x + dropout(y, p, True, gen))
        hidden = torch.relu(linear_in(
            self.linear1, copy_to_model(x) if split else x, dtype))
        # a shard's hidden layer is its column block of the whole one
        hidden_gen = gen.column_block() if split and gen is not None \
            else gen
        ffn = out(self.linear2, dropout(hidden, p, True, hidden_gen), dtype)
        return self.norm2(x + dropout(ffn, p, True, gen))


class _Layers(nn.Module):
    def __init__(self, cfg: T2SConfig, tp: TP = None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerLayer(cfg.hidden_dim, cfg.n_heads, cfg.ffn_dim,
                             dropout=cfg.dropout, tp=tp)
            for _ in range(cfg.n_layers))


class Text2SemanticDecoder(nn.Module):
    """The s1 GPT; ``tp=(m, n_model)`` builds model index m's shard of it
    for a tensor-parallel step (the module note), whose state dict is
    ``parallel.gpt_sharding.shard_state_dict`` of the whole model's."""

    def __init__(self, cfg: T2SConfig = T2SConfig(),
                 dtype: Optional[torch.dtype] = None, tp: TP = None):
        super().__init__()
        c = self.cfg = cfg
        self.tp = tp
        self.bert_proj = nn.Linear(1024, c.embedding_dim)
        self.ar_text_embedding = TokenEmbedding(c.embedding_dim,
                                                c.phoneme_vocab_size)
        self.ar_audio_embedding = TokenEmbedding(c.embedding_dim,
                                                 c.vocab_size)
        self.ar_text_position = SinePositionalEmbedding(c.embedding_dim,
                                                        c.max_position)
        self.ar_audio_position = SinePositionalEmbedding(c.embedding_dim,
                                                         c.max_position)
        self.h = _Layers(c, tp)
        self.ar_predict_layer = nn.Linear(c.hidden_dim, c.vocab_size,
                                          bias=False)
        set_compute_dtype(self, dtype)

    def embed_text(self, x, bert_feature):
        """x: (B, Tx) phoneme ids; bert_feature: (B, Tx, 1024)."""
        h = self.ar_text_embedding(x) + linear_in(
            self.bert_proj, bert_feature, compute_dtype(self))
        return self.ar_text_position(h)

    def embed_audio(self, y, offset: int = 0):
        return self.ar_audio_position(self.ar_audio_embedding(y), offset)

    def forward(self, x, x_lens, y, y_lens, bert_feature,
                seed: Optional[int] = None,
                rows: Optional[BatchRows] = None):
        """Training forward with the CE loss and top-3 accuracy (JAX:
        t2s.py:256-303).

        x: (B, Tx) phonemes; y: (B, Ty) semantic tokens (0-padded); bert:
        (B, Tx, 1024).  The inputs are the codes with EOS in every pad slot;
        the targets the codes shifted by one with EOS from ``len - 1`` on.
        The CE is a sum over all B x Ty positions (pad rows see only the
        valid prefix through the mask, so they learn to emit EOS); the
        accuracy is over the non-EOS targets.  Returns dict(loss, acc,
        logits (B, Ty, V), targets, num_targets, hits: the accuracy's
        numerator).

        ``seed``: a host integer that draws this forward's dropout masks
        (the module note), needed in training mode when ``cfg.dropout >
        0`` and not read otherwise; ``rows``: where this batch sits in a
        data-parallel step's global batch (the module note)."""
        c = self.cfg
        drops = self.training and c.dropout > 0
        if drops and seed is None:
            raise ValueError(f"Text2SemanticDecoder: dropout {c.dropout} in "
                             f"training needs a seed")
        b, x_len = x.shape
        y_len = y.shape[1]
        pos = torch.arange(y_len, device=y.device)
        y_valid = pos[None, :] < y_lens[:, None]
        codes = torch.where(y_valid, y, torch.zeros_like(y))
        y_in = torch.where(y_valid, codes, torch.full_like(codes, c.eos_id))
        shifted = torch.cat([codes[:, 1:], torch.zeros_like(codes[:, :1])],
                            dim=1)
        targets = torch.where(pos[None, :] + 1 < y_lens[:, None], shifted,
                              torch.full_like(shifted, c.eos_id))

        h = torch.cat([self.embed_text(x, bert_feature),
                       self.embed_audio(y_in)], dim=1)
        gen = None
        if drops:
            seed %= 2 ** 64
            gen = torch.Generator(device=h.device)
            gen.manual_seed(seed)
            if rows is not None:
                gen = RankGenerator(gen, rows)
        row0 = rows.row0 if rows is not None else 0
        for i, layer in enumerate(self.h.layers):
            rng = LayerRng(seed ^ ATTENTION_KEY, i, gen, row0) if drops \
                else None
            h = layer.train_forward(h, x_len, x_lens, y_lens, rng)

        logits = linear_in(self.ar_predict_layer, h[:, x_len:],
                           compute_dtype(self))           # (B, Ty, V)
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -logp.gather(-1, targets[..., None].long())[..., 0].sum()
        with torch.no_grad():
            topk = logits.float().topk(3, dim=-1).indices
            hit = (topk == targets[..., None]).any(dim=-1)
            acc_mask = (targets != c.eos_id).float()
            num = acc_mask.sum()
            hits = (hit.float() * acc_mask).sum()
            acc = hits / torch.clamp(num, min=1.0)
        return {"loss": loss, "acc": acc, "logits": logits,
                "targets": targets, "num_targets": num, "hits": hits}

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
