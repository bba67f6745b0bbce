"""CT-Transformer punctuation restoration (JAX: audiokit/punc_ct.py),
FunASR's ``ct-punc`` after Paraformer.

Host copies of the JAX package's, under the same names: ``CTPuncConfig``,
``code_mix_split_words`` and ``_join``, and the chunked ``restore`` (20-word
mini-sentences, the tail after the last sentence-final mark carried into
the next chunk, a trailing non-final mark promoted to 。).  The net runs on
the restorer's device: a 272,727 x 256 embedding, the Paraformer port's
SAN-M encoder (4 layers at d 256, 8 heads of 32, FSMN kernel 11; the first
layer keeps its residual, since its input is 256 wide too) and a 6-way
linear head.  Its self-attention runs on K1's dk-32 instance
(``ops.attention.encoder_attention``) with the valid words as the key
prefix: 4 launches a ``_predict_puncs`` call.

Module names are FunASR's CTTransformer's (``embed.weight``,
``encoder.encoders0.0.*``, ``encoder.encoders.{i}.*``,
``encoder.after_norm``, ``decoder``), the source side of the JAX
``convert_ct_punc_weights``.  A directory with no checkpoint gives
``available=False``; a checkpoint that is present and does not load raises
(the JAX class logs it and reports ``available=False``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.attention import encoder_attention
from ..utils.device import resolve_device
from .asr_paraformer import (SANMEncoder, bucket, find_weights,
                             load_checkpoint, read_config, read_tokens)

_SENTENCE_END = ("。", "？", "?", "！", "!")
_CACHE_POP_TRIGGER_LIMIT = 200
_SPLIT_SIZE = 20


@dataclasses.dataclass(frozen=True)
class CTPuncConfig:
    vocab_size: int = 272727
    embed_unit: int = 256
    d_model: int = 256
    n_heads: int = 8
    ffn_dim: int = 1024
    num_blocks: int = 4
    fsmn_kernel: int = 11
    punc_list: Tuple[str, ...] = ("<unk>", "_", "，", "。", "？", "、")

    @classmethod
    def from_yaml(cls, cfg: dict) -> "CTPuncConfig":
        enc = cfg.get("encoder_conf", {})
        mdl = cfg.get("model_conf", {})
        return cls(
            vocab_size=cfg.get("vocab_size", mdl.get("vocab_size", 272727)),
            embed_unit=mdl.get("embed_unit", 256),
            d_model=enc.get("output_size", mdl.get("att_unit", 256)),
            n_heads=enc.get("attention_heads", 8),
            ffn_dim=enc.get("linear_units", 1024),
            num_blocks=enc.get("num_blocks", 4),
            fsmn_kernel=enc.get("kernel_size", 11),
            punc_list=tuple(mdl.get("punc_list",
                                    ["<unk>", "_", "，", "。", "？", "、"])),
        )


# ---------------------------------------------------------------------------
# Torch net (embedding + SAN-M encoder on K1 + linear head)
# ---------------------------------------------------------------------------

class CTTransformer(nn.Module):
    def __init__(self, cfg: CTPuncConfig = CTPuncConfig()):
        super().__init__()
        c = cfg
        self.embed = nn.Embedding(c.vocab_size, c.embed_unit)
        self.encoder = SANMEncoder(c.embed_unit, c.d_model, c.n_heads,
                                   c.ffn_dim, c.fsmn_kernel, c.num_blocks,
                                   encoder_attention)
        self.decoder = nn.Linear(c.d_model, len(c.punc_list))

    def forward(self, ids, mask):
        """ids (B, T) int, mask (B, T, 1) a prefix of ones -> punctuation
        logits (B, T, len(punc_list))."""
        valid = mask[..., 0].sum(1).to(torch.int32)
        return self.decoder(self.encoder(self.embed(ids), mask, valid))


# ---------------------------------------------------------------------------
# Tokenization + chunked inference (host-side)
# ---------------------------------------------------------------------------

_CJK = re.compile(r"[一-鿿㐀-䶿]")


def code_mix_split_words(text: str) -> List[str]:
    """CJK chars become single tokens, contiguous latin/digit runs stay
    whole words (FunASR ``code_mix_split_words``)."""
    words: List[str] = []
    for piece in text.split():
        cur = ""
        for ch in piece:
            if _CJK.match(ch):
                if cur:
                    words.append(cur)
                    cur = ""
                words.append(ch)
            else:
                cur += ch
        if cur:
            words.append(cur)
    return words


def _join(words: List[str], puncs: List[str]) -> str:
    """Assemble words + per-word punctuation ("_" = none); latin words are
    space-separated unless a punctuation mark already separates them."""
    out: List[str] = []
    prev_plain_ascii = False
    for w, p in zip(words, puncs):
        is_ascii = w.isascii() and bool(w)
        if prev_plain_ascii and is_ascii:
            out.append(" ")
        out.append(w)
        if p not in ("_", "<unk>", ""):
            out.append(p)
            prev_plain_ascii = False
        else:
            prev_plain_ascii = is_ascii
    return "".join(out)


class CTPunc:
    """Filesystem-checkpoint CT-Transformer punctuation restorer on
    ``device`` (the card unless the caller asks for the CPU).

    ``model_dir`` holds ``model.pt`` + ``config.yaml`` + ``tokens.json`` —
    the layout ``tools/fetch_pretrained.py`` produces from the modelscope
    repo ``iic/punc_ct-transformer_zh-cn-common-vocab272727-pytorch``.
    """

    def __init__(self, model_dir: str, device="cuda"):
        self.device = resolve_device(device, "CTPunc")
        self.model_dir = model_dir
        self.available = False
        model_path = find_weights(model_dir)
        if model_path is None:
            return
        self.cfg = CTPuncConfig.from_yaml(read_config(model_dir))
        tokens = read_tokens(model_dir)
        self.vocab: Dict[str, int] = {tok: i for i, tok in enumerate(tokens)}
        if not self.vocab:
            raise FileNotFoundError("tokens.json/tokens.txt is empty")
        self.unk_id = self.vocab.get("<unk>", 0)
        self.model = CTTransformer(self.cfg)
        self.model.load_state_dict(load_checkpoint(model_path), strict=True)
        self.model.to(self.device).eval()
        self.available = True

    # -- prediction ---------------------------------------------------------

    @torch.no_grad()
    def _logits(self, words: List[str]) -> torch.Tensor:
        """(t, len(punc_list)) logits of ``words``, the ids padded to the
        JAX bucket ``max(16, next power of 2)`` (the pads are masked keys,
        so the bucket does not reach the valid words)."""
        t = len(words)
        ids = torch.zeros((1, bucket(t, 16)), dtype=torch.long)
        ids[0, :t] = torch.tensor([self.vocab.get(w, self.unk_id)
                                   for w in words])
        mask = torch.zeros((1, ids.shape[1], 1))
        mask[0, :t] = 1.0
        return self.model(ids.to(self.device), mask.to(self.device))[0, :t]

    def _predict_puncs(self, words: List[str]) -> List[str]:
        logits = self._logits(words).cpu().numpy()
        # "<unk>" (id 0) is never a valid output mark
        logits[:, 0] = -np.inf
        return [self.cfg.punc_list[int(i)] for i in logits.argmax(axis=-1)]

    def restore(self, text: str) -> str:
        """Insert punctuation into unpunctuated ASR output."""
        words = code_mix_split_words(text)
        if not words:
            return text
        out = ""
        cache: List[str] = []
        chunks = [words[i:i + _SPLIT_SIZE]
                  for i in range(0, len(words), _SPLIT_SIZE)]
        for ci, chunk in enumerate(chunks):
            cur = cache + chunk
            puncs = self._predict_puncs(cur)
            last = ci == len(chunks) - 1
            if not last and len(cur) <= _CACHE_POP_TRIGGER_LIMIT:
                # carry the unfinished sentence tail into the next chunk
                end = -1
                for i, p in enumerate(puncs):
                    if p in _SENTENCE_END:
                        end = i
                if end >= 0:
                    cache = cur[end + 1:]
                    cur, puncs = cur[:end + 1], puncs[:end + 1]
                else:
                    cache = cur
                    cur, puncs = [], []
            else:
                cache = []
            out += _join(cur, puncs)
        if out:
            if out[-1] in ("，", "、", ","):
                out = out[:-1] + "。"
            elif out[-1] not in _SENTENCE_END:
                out += "。"
        return out
