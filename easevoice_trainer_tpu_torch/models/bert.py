"""BERT encoder (chinese-roberta-wwm-ext-large) and the phone-level BERT
features of Chinese text (JAX: models/bert.py).

Module names are HF ``BertModel``'s (``embeddings.word_embeddings``,
``encoder.layer.{i}.attention.self.query``, ...), so a released
``pytorch_model.bin`` or ``model.safetensors`` loads with
``load_state_dict(strict=True)`` once :func:`hf_state_for_load` has taken
the ``bert.`` prefix off and dropped what the encoder does not use (the
pooler, a masked-LM head, the ``position_ids`` buffer).  Each layer is
post-norm; its attention runs on K1's head-width-64 instance
(``ops.attention.encoder_attention``), the projections and the FFN (exact
erf GELU) are plain torch, as the JAX package leaves them to XLA.

``BertFeatureExtractor.phone_features`` follows the JAX extractor
(bert.py:209-225): tokenize, run, take ``hidden_states[-3]``, drop [CLS]
and [SEP], repeat each token's vector ``word2ph[i]`` times ->
(hidden, n_phones); zeros when the directory lacks weights or a
tokenizer.  It reads no file with ``transformers`` or ``safetensors``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import encoder_attention
from ..text.bert_tokenizer import BertTokenizer, loadable
from ..utils import safetensors_io
from ..utils.device import resolve_device

WEIGHTS = ("pytorch_model.bin", "model.safetensors")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 21128
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.LayerNorm(self.word_embeddings(input_ids)
                              + self.position_embeddings(pos)[None]
                              + self.token_type_embeddings(token_type_ids))


class _SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.n_heads = cfg.num_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)

    def forward(self, x, valid_lens):
        b, t, d = x.shape
        split = lambda z: z.view(b, t, self.n_heads, d // self.n_heads)
        o = encoder_attention(split(self.query(x)), split(self.key(x)),
                              split(self.value(x)), valid_lens)
        return o.reshape(b, t, d)


class _DenseNorm(nn.Module):
    """dense, then LayerNorm over the residual sum (HF ``BertSelfOutput`` /
    ``BertOutput``)."""

    def __init__(self, d_in: int, d: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d)
        self.LayerNorm = nn.LayerNorm(d, eps=eps)

    def forward(self, y, residual):
        return self.LayerNorm(residual + self.dense(y))


class _Attention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = _SelfAttention(cfg)
        self.output = _DenseNorm(cfg.hidden_size, cfg.hidden_size,
                                 cfg.layer_norm_eps)


class _Intermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Intermediate(cfg)
        self.output = _DenseNorm(cfg.intermediate_size, cfg.hidden_size,
                                 cfg.layer_norm_eps)

    def forward(self, x, valid_lens):
        att = self.attention
        x = att.output(att.self(x, valid_lens), x)
        return self.output(F.gelu(self.intermediate.dense(x)), x)


class _Encoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_layers))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig = BertConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> List[torch.Tensor]:
        """input_ids (B, T) -> the hidden states (embeddings, then every
        layer), each (B, T, hidden).  ``attention_mask`` (B, T) must be a
        prefix of ones on each row (a tokenizer pads on the right); each
        row's keys are the positions it marks."""
        b, t = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            valid_lens = torch.full((b,), t, dtype=torch.int32,
                                    device=input_ids.device)
        else:
            valid_lens = (attention_mask > 0).sum(1).to(torch.int32)
            prefix = (torch.arange(t, device=input_ids.device)[None]
                      < valid_lens[:, None])
            if not torch.equal(prefix, attention_mask > 0):
                raise ValueError("BertModel: attention_mask must be a prefix "
                                 "of ones on each row")
        h = self.embeddings(input_ids, token_type_ids)
        hidden_states = [h]
        for layer in self.encoder.layer:
            h = layer(h, valid_lens)
            hidden_states.append(h)
        return hidden_states


def hf_state_for_load(state: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """An HF BERT checkpoint's state dict -> :class:`BertModel`'s: the
    ``bert.`` prefix taken off (as the JAX ``convert_hf_bert`` reads it,
    bert.py:103-107), the embeddings and encoder kept, everything else (the
    pooler, an MLM head, ``embeddings.position_ids``) dropped, fp32."""
    out = {}
    for key, value in state.items():
        if key.startswith("bert."):
            key = key[len("bert."):]
        if (key.startswith(("embeddings.", "encoder."))
                and key != "embeddings.position_ids"):
            out[key] = value.to(torch.float32)
    return out


def config_from_hf(model_dir: str) -> BertConfig:
    """Build a BertConfig from an HF config.json when present."""
    path = os.path.join(model_dir, "config.json") if model_dir else ""
    if not path or not os.path.exists(path):
        return BertConfig()
    with open(path, encoding="utf8") as f:
        c = json.load(f)
    return BertConfig(
        vocab_size=c.get("vocab_size", 21128),
        hidden_size=c.get("hidden_size", 1024),
        num_layers=c.get("num_hidden_layers", 24),
        num_heads=c.get("num_attention_heads", 16),
        intermediate_size=c.get("intermediate_size", 4096),
        max_position=c.get("max_position_embeddings", 512),
        type_vocab_size=c.get("type_vocab_size", 2),
        layer_norm_eps=c.get("layer_norm_eps", 1e-12),
    )


def load_hf_state(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``pytorch_model.bin`` or ``model.safetensors``."""
    if path.endswith(".safetensors"):
        return safetensors_io.load_file(path)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in raw.items() if isinstance(v, torch.Tensor)}


class BertFeatureExtractor:
    """Tokenizer + model + phone-level feature repeat on ``device``.

    ``available`` when ``model_dir`` holds weights (``pytorch_model.bin``,
    else ``model.safetensors``) and a BERT tokenizer, as the JAX extractor
    needs; otherwise ``phone_features`` gives zeros, as there (the JAX
    preprocessor then gets no extractor at all, tts.py:153-160).  Raises
    when ``device`` is the card and there is none.
    """

    def __init__(self, model_dir: str, device="cuda",
                 cfg: Optional[BertConfig] = None):
        self.device = resolve_device(device, "BertFeatureExtractor")
        self.cfg = cfg or config_from_hf(model_dir)
        self.model: Optional[BertModel] = None
        self.tokenizer: Optional[BertTokenizer] = None
        if not (model_dir and os.path.isdir(model_dir)):
            return
        if loadable(model_dir):
            self.tokenizer = BertTokenizer.from_pretrained(model_dir)
        for fname in WEIGHTS:
            path = os.path.join(model_dir, fname)
            if os.path.exists(path):
                model = BertModel(self.cfg)
                model.load_state_dict(hf_state_for_load(load_hf_state(path)),
                                      strict=True)
                self.model = model.to(self.device).eval()
                break

    @property
    def available(self) -> bool:
        return self.model is not None and self.tokenizer is not None

    def hidden_states(self, text: str) -> List[torch.Tensor]:
        """Every hidden state of ``text``'s tokens, [CLS] and [SEP]
        included, each (1, n_tokens + 2, hidden) on the device."""
        enc = self.tokenizer(text)
        ids = torch.tensor([enc["input_ids"]], device=self.device)
        mask = torch.tensor([enc["attention_mask"]], device=self.device)
        return self.model(ids, mask)

    def phone_features(self, text: str, word2ph: List[int]) -> np.ndarray:
        """(hidden, n_phones) phone-level features (JAX bert.py:209-225)."""
        n_phones = sum(word2ph)
        if not self.available:
            return np.zeros((self.cfg.hidden_size, n_phones), np.float32)
        res = self.hidden_states(text)[-3][0, 1:-1]   # drop [CLS] / [SEP]
        assert len(word2ph) == res.shape[0], (len(word2ph), res.shape)
        reps = torch.as_tensor(word2ph, device=res.device)
        phone_level = torch.repeat_interleave(res, reps, dim=0)
        return phone_level.T.cpu().numpy().astype(np.float32)
