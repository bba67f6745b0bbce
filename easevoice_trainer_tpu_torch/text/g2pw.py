"""G2PW polyphone classifier on PyTorch (JAX: text/g2pw.py).

* ``G2PWModel``: the port's BERT (attention on K1's head-width-64
  instance), the hidden state at each query's position, then the
  conditional weighted softmax head of the g2pW default config
  (``classifier`` + ``descriptor_bias`` + ``char_descriptor``, masked by the
  query character's allowed phonemes).
* ``convert_g2pw_weights``: a torch or ONNX state (HF BERT names + head
  tensors, the names JAX g2pw.py:91-132 reads) -> ``G2PWModel``'s state
  dict.  ``g2pW.onnx`` is read with the copied protobuf reader of
  ``audiokit/mdxnet.py``.
* ``G2PWPredictor``: loads a G2PWModel directory (the character tables,
  the bopomofo dictionaries, a BERT tokenizer, the weights), makes one
  batch per segment as the JAX predictor does (one row per polyphonic
  character, tokens padded to a power of two) and gives per-character
  TONE3 readings for ``chinese.py``.

The host functions (``wordize_and_map``, ``tokenize_and_map``,
``get_phoneme_labels``, the predictor's batch and reading rules) are copies
of the JAX module's; ``tests/test_torch_host.py`` holds them to it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.bert import BertConfig, BertModel, hf_state_for_load
from ..utils.device import resolve_device
from ..utils.logger import logger
from .bert_tokenizer import BertTokenizer

# g2pW taxonomy (onnx_api.py:117-143)
NON_POLYPHONIC = {
    "一", "不", "和", "咋", "嗲", "剖", "差", "攢", "倒", "難", "奔", "勁",
    "拗", "肖", "瘙", "誒", "泊", "听", "噢",
}
NON_MONOPHONIC = {"似", "攢"}
WEIGHTS = ("g2pW.pth", "g2pW.ckpt", "best_accuracy.pth")


@dataclasses.dataclass(frozen=True)
class G2PWConfig:
    n_labels: int = 1
    n_chars: int = 1
    use_conditional: bool = True
    conditional_bias: bool = True
    char_linear: bool = True


class G2PWModel(nn.Module):
    def __init__(self, bert_cfg: BertConfig, cfg: G2PWConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(bert_cfg)
        self.classifier = nn.Linear(bert_cfg.hidden_size, cfg.n_labels)
        if cfg.use_conditional and cfg.conditional_bias:
            self.descriptor_bias = nn.Parameter(torch.zeros(cfg.n_labels))
        if cfg.use_conditional and cfg.char_linear:
            self.char_descriptor = nn.Embedding(cfg.n_chars, cfg.n_labels)

    @torch.no_grad()
    def forward(self, input_ids, token_type_ids, attention_mask,
                phoneme_mask, char_ids, position_ids) -> torch.Tensor:
        """-> per-label probabilities (B, n_labels), 0 outside each row's
        phoneme mask."""
        h = self.bert(input_ids, attention_mask, token_type_ids)[-1]
        q = h[torch.arange(h.shape[0], device=h.device), position_ids]
        logits = self.classifier(q)
        if self.cfg.use_conditional:
            if self.cfg.conditional_bias:
                logits = logits + self.descriptor_bias
            if self.cfg.char_linear:
                logits = logits + self.char_descriptor(char_ids)
        logits = logits.masked_fill(phoneme_mask <= 0, -torch.inf)
        return torch.softmax(logits, dim=-1)


def convert_g2pw_weights(state: Dict[str, torch.Tensor], cfg: G2PWConfig
                         ) -> Dict[str, torch.Tensor]:
    """torch/ONNX state (HF BERT names + head tensors) -> G2PWModel's
    state dict (the choices of JAX ``convert_g2pw_weights``)."""
    def find(*cands):
        for c in cands:
            if c in state:
                return torch.as_tensor(state[c], dtype=torch.float32)
        return None

    bert_state = {re.sub(r"^(encoder|bert)\.", "", k): torch.as_tensor(v)
                  for k, v in state.items()
                  if ".layer." in k or "embeddings." in k}
    out = {"bert." + k: v for k, v in hf_state_for_load(bert_state).items()}
    w = find("classifier.weight", "out.weight")
    if w is None:
        raise KeyError("g2pw state lacks a classifier.weight tensor; "
                       f"have: {sorted(state)[:8]}...")
    out["classifier.weight"] = w
    b = find("classifier.bias", "out.bias")
    if b is not None:
        out["classifier.bias"] = b
    if cfg.use_conditional:
        if cfg.conditional_bias:
            db = find("descriptor_bias.weight", "descriptor_bias")
            if db is not None:
                out["descriptor_bias"] = db.reshape(-1)
        if cfg.char_linear:
            ce = find("char_descriptor.weight", "char_emb.weight")
            if ce is not None:
                out["char_descriptor.weight"] = ce
    return out


# ---------------------------------------------------------------------------
# tokenize-and-map (g2pw/utils.py:22-84 semantics)
# ---------------------------------------------------------------------------


def wordize_and_map(text: str):
    words, text2word, word2text = [], [], []
    while text:
        m = re.match(r"^ +", text)
        if m:
            text2word += [None] * len(m.group(0))
            text = text[len(m.group(0)):]
            continue
        m = re.match(r"^[a-zA-Z0-9]+", text)
        chunk = m.group(0) if m else text[0]
        start = len(text2word)
        word2text.append((start, start + len(chunk)))
        text2word += [len(words)] * len(chunk)
        words.append(chunk)
        text = text[len(chunk):]
    return words, text2word, word2text


def tokenize_and_map(tokenizer, text: str):
    words, text2word, word2text = wordize_and_map(text)
    tokens, token2text = [], []
    for word, (start, end) in zip(words, word2text):
        word_tokens = tokenizer.tokenize(word)
        if not word_tokens or word_tokens == ["[UNK]"]:
            token2text.append((start, end))
            tokens.append("[UNK]")
        else:
            cur = start
            for tok in word_tokens:
                ln = len(re.sub(r"^##", "", tok))
                token2text.append((cur, cur + ln))
                cur += ln
                tokens.append(tok)
    text2token = list(text2word)
    for i, (s, e) in enumerate(token2text):
        for pos in range(s, e):
            text2token[pos] = i
    return tokens, text2token, token2text


# ---------------------------------------------------------------------------
# predictor
# ---------------------------------------------------------------------------


class G2PWPredictor:
    """Model-backed per-char pinyin on ``device``, mirroring the JAX
    predictor.  ``available`` is false when the directory is missing or
    does not load (the JAX predictor's rule: a warning, then the
    dictionary); a card asked for and absent raises."""

    def __init__(self, model_dir: str, device="cuda",
                 tokenizer: Optional[BertTokenizer] = None,
                 max_len: int = 512):
        self.device = resolve_device(device, "G2PWPredictor")
        self.available = False
        self.max_len = max_len
        if not model_dir or not os.path.isdir(model_dir):
            return
        try:
            self._load(model_dir, tokenizer)
            self.available = True
        except Exception as exc:  # the JAX predictor's rule: the dictionary
            logger.warning("g2pw model not loaded from %s: %s", model_dir, exc)

    def _load(self, model_dir: str, tokenizer):
        self.polyphonic_chars = [
            line.split("\t") for line in open(
                os.path.join(model_dir, "POLYPHONIC_CHARS.txt"),
                encoding="utf8").read().strip().split("\n")]
        self.monophonic_chars = dict(
            line.split("\t") for line in open(
                os.path.join(model_dir, "MONOPHONIC_CHARS.txt"),
                encoding="utf8").read().strip().split("\n"))
        for ch in NON_MONOPHONIC:
            self.monophonic_chars.pop(ch, None)
        self.labels, self.char2phonemes = get_phoneme_labels(
            self.polyphonic_chars)
        self.chars = sorted(self.char2phonemes)
        self.poly_set = set(self.chars) - NON_POLYPHONIC
        with open(os.path.join(model_dir,
                               "bopomofo_to_pinyin_wo_tune_dict.json"),
                  encoding="utf8") as f:
            self.bopomofo_to_pinyin = json.load(f)
        char_bopomofo = os.path.join(model_dir, "char_bopomofo_dict.json")
        self.char_bopomofo = (json.load(open(char_bopomofo, encoding="utf8"))
                              if os.path.exists(char_bopomofo) else {})

        if tokenizer is None:
            for cand in (os.path.join(model_dir, "tokenizer"), model_dir):
                try:
                    tokenizer = BertTokenizer.from_pretrained(cand)
                    break
                except (OSError, ValueError, KeyError):
                    tokenizer = None
        if tokenizer is None:
            raise FileNotFoundError("no tokenizer for g2pw")
        self.tokenizer = tokenizer

        state = self._load_state(model_dir)

        def emb_rows(suffix):
            return next(int(v.shape[0]) for k, v in state.items()
                        if k.endswith(suffix))

        hidden = int(state["classifier.weight"].shape[1])
        inter = next(int(v.shape[0]) for k, v in state.items()
                     if k.endswith("layer.0.intermediate.dense.weight"))
        n_layers = 0
        while any(f"encoder.layer.{n_layers}." in k for k in state):
            n_layers += 1
        heads = max(1, hidden // 64)
        hf_cfg = os.path.join(model_dir, "config.json")
        if os.path.exists(hf_cfg):
            with open(hf_cfg, encoding="utf8") as f:
                heads = json.load(f).get("num_attention_heads", heads)
        bert_cfg = BertConfig(
            vocab_size=emb_rows("embeddings.word_embeddings.weight"),
            hidden_size=hidden, num_layers=n_layers, num_heads=heads,
            intermediate_size=inter,
            max_position=emb_rows("embeddings.position_embeddings.weight"),
            type_vocab_size=emb_rows("embeddings.token_type_embeddings.weight"))
        self.cfg = G2PWConfig(
            n_labels=len(self.labels), n_chars=len(self.chars),
            use_conditional=any("char_descriptor" in k for k in state)
            or any("descriptor_bias" in k for k in state),
            conditional_bias=any("descriptor_bias" in k for k in state),
            char_linear=any("char_descriptor" in k for k in state))
        model = G2PWModel(bert_cfg, self.cfg)
        model.load_state_dict(convert_g2pw_weights(state, self.cfg),
                              strict=True)
        self.model = model.to(self.device).eval()

    @staticmethod
    def _load_state(model_dir: str) -> Dict[str, torch.Tensor]:
        onnx = os.path.join(model_dir, "g2pW.onnx")
        if os.path.exists(onnx):
            from ..audiokit.mdxnet import load_onnx_initializers

            state = load_onnx_initializers(onnx)
            if not any("embeddings.word_embeddings" in k for k in state):
                raise ValueError(
                    "g2pW.onnx initializers are anonymized; cannot map")
            return {k: torch.from_numpy(np.array(v, np.float32))
                    for k, v in state.items()}
        for cand in WEIGHTS:
            path = os.path.join(model_dir, cand)
            if os.path.exists(path):
                raw = torch.load(path, map_location="cpu", weights_only=True)
                if isinstance(raw, dict) and "state_dict" in raw:
                    raw = raw["state_dict"]
                return {k: v.detach().to(torch.float32)
                        for k, v in raw.items() if hasattr(v, "detach")}
        raise FileNotFoundError(f"no g2pw weights in {model_dir}")

    # -- inference -----------------------------------------------------------

    def _prepare_batch(self, texts: List[str], query_ids: List[int]):
        """dataset.prepare_onnx_input semantics, tokens padded to a power of
        two as the JAX predictor pads them: numpy arrays."""
        rows = []
        for text, query_id in zip(texts, query_ids):
            text = text.lower()
            tokens, text2token, token2text = tokenize_and_map(
                self.tokenizer, text)
            tokens = tokens[:self.max_len - 2]
            ids = self.tokenizer.convert_tokens_to_ids(
                ["[CLS]"] + tokens + ["[SEP]"])
            query_char = text[query_id]
            phoneme_mask = np.zeros(len(self.labels), np.float32)
            phoneme_mask[self.char2phonemes[query_char]] = 1.0
            rows.append((np.asarray(ids, np.int32),
                         phoneme_mask,
                         self.chars.index(query_char),
                         int(text2token[query_id]) + 1))
        longest = max(len(r[0]) for r in rows)
        pad_to = 1 << (longest - 1).bit_length()
        b = len(rows)
        input_ids = np.zeros((b, pad_to), np.int32)
        attention = np.zeros((b, pad_to), np.int32)
        for i, (ids, _, _, _) in enumerate(rows):
            input_ids[i, :len(ids)] = ids
            attention[i, :len(ids)] = 1
        return dict(
            input_ids=input_ids,
            token_type_ids=np.zeros_like(input_ids),
            attention_mask=attention,
            phoneme_mask=np.stack([r[1] for r in rows]),
            char_ids=np.asarray([r[2] for r in rows], np.int32),
            position_ids=np.asarray([r[3] for r in rows], np.int32))

    def probabilities(self, texts: List[str], query_ids: List[int]
                      ) -> np.ndarray:
        """(rows, n_labels) label probabilities, one row per query."""
        batch = self._prepare_batch(texts, query_ids)
        args = {k: torch.from_numpy(v).to(
            self.device, torch.long if v.dtype == np.int32 else torch.float32)
            for k, v in batch.items()}
        return self.model(**args).cpu().numpy()

    def predict(self, texts: List[str], query_ids: List[int]) -> List[str]:
        preds = self.probabilities(texts, query_ids).argmax(axis=1)
        return [self.labels[p] for p in preds]

    def _bopomofo_to_tone3(self, bopomofo: str) -> Optional[str]:
        tone = bopomofo[-1]
        body = self.bopomofo_to_pinyin.get(bopomofo[:-1])
        return (body + tone) if body else None

    def lazy_pinyin(self, seg: str, fallback) -> List[str]:
        """Per-char TONE3 readings for one segment.

        ``fallback(char) -> reading`` supplies non-model chars (the
        reference uses pypinyin there: onnx_api.py:226-240).
        """
        readings: List[Optional[str]] = [None] * len(seg)
        texts, query_ids = [], []
        for i, ch in enumerate(seg):
            if ch in self.poly_set:
                texts.append(seg)
                query_ids.append(i)
            elif ch in self.monophonic_chars:
                readings[i] = self._bopomofo_to_tone3(
                    self.monophonic_chars[ch]) or fallback(ch)
            else:
                readings[i] = fallback(ch)
        if texts:
            for qid, label in zip(query_ids,
                                  self.predict(texts, query_ids)):
                readings[qid] = (self._bopomofo_to_tone3(label)
                                 or fallback(seg[qid]))
        return [r if r is not None else seg[i]
                for i, r in enumerate(readings)]


def get_phoneme_labels(polyphonic_chars: Sequence[Sequence[str]]
                       ) -> Tuple[List[str], Dict[str, List[int]]]:
    labels = sorted({ph for _, ph in polyphonic_chars})
    index = {ph: i for i, ph in enumerate(labels)}
    char2phonemes: Dict[str, List[int]] = {}
    for char, ph in polyphonic_chars:
        char2phonemes.setdefault(char, []).append(index[ph])
    return labels, char2phonemes
