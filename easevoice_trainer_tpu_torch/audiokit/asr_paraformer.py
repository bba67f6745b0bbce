"""Paraformer-large, the zh ASR net (JAX: audiokit/asr_paraformer.py).

The host parts are copies of the JAX package's, under the same names: the
kaldi-compatible 80-mel log-fbank, LFR 7/6 stacking and the ``am.mvn`` CMVN
(``kaldi_fbank``, ``kaldi_fbank_mats``, ``apply_lfr``, ``load_cmvn``),
``ParaformerConfig``, the continuous integrate-and-fire loop over the
device-computed alphas (``cif_fire``, ``tail_alphas``; data-dependent scalar
work, host-side as in JAX) and ``tokens_to_text``.

The net runs on the ASR's device.  Module names are FunASR's (the source
side of the JAX ``convert_paraformer_weights``): ``encoder.encoders0.0.*``,
``encoder.encoders.{i}.*``, ``decoder.decoders.{i}.*``,
``decoder.decoders3.0.*``, ``predictor.cif_conv1d``,
``predictor.cif_output``, so a released ``model.pt`` loads with
``load_state_dict(strict=True)`` once the tensors only training reads are
dropped (:data:`TRAINING_ONLY`).  The SAN-M encoder layer (self-attention
whose value path carries a depthwise FSMN memory, pre-norm) is shared with
CT-punc (:mod:`.punc_ct`).  Paraformer's attention is 4 heads of 128: no
hand-written kernel has that head width, so it is PyTorch's
``scaled_dot_product_attention`` with a boolean key mask, as the JAX package
leaves it to XLA (asr_paraformer.py:240-244, :338-343).  LayerNorms use
flax's eps 1e-6, as the JAX nets do.

``_infer`` pads the LFR frames to the JAX package's time bucket
(``max(16, next power of 2)``) because the bucket reaches the result: the
predictor's 3-tap conv reads the first padded frame for ``alpha[t-1]``, and
the tail firing mixes ``0.45 * enc[t]`` into the last token.  FunASR runs a
clip unpadded, so there the JAX package (and the port with it) differs from
FunASR.

A directory with no checkpoint gives ``available=False``; a checkpoint that
is present and does not load raises (the JAX class logs it and reports
``available=False``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import simple_yaml
from ..utils.device import resolve_device

SAMPLE_RATE = 16000
WEIGHTS = ("model.pt", "model.pb", "pytorch_model.bin")
# state-dict families of a released FunASR checkpoint that inference does
# not read: the decoder's token embedding (sampling during training) and a
# CTC head; they are dropped before the strict load
TRAINING_ONLY = ("decoder.embed.", "ctc.", "criterion_att.")
LN_EPS = 1e-6  # flax's LayerNorm default, which every JAX ASR net uses


# ---------------------------------------------------------------------------
# Frontend: kaldi fbank + LFR + CMVN (numpy — host-side, cheap)
# ---------------------------------------------------------------------------

def _mel_scale(freq: np.ndarray) -> np.ndarray:
    return 1127.0 * np.log(1.0 + freq / 700.0)


def kaldi_fbank_mats(n_fft: int = 512, n_mels: int = 80,
                     sample_rate: int = SAMPLE_RATE,
                     low_freq: float = 20.0,
                     high_freq: float = 0.0) -> np.ndarray:
    """Kaldi-style triangular mel filterbank over FFT bins (mel domain,
    low 20 Hz, high = nyquist + ``high_freq`` when non-positive)."""
    if high_freq <= 0:
        high_freq = sample_rate / 2.0 + high_freq
    n_bins = n_fft // 2 + 1
    fft_freqs = np.arange(n_bins) * sample_rate / n_fft
    mel_low, mel_high = _mel_scale(np.array([low_freq, high_freq]))
    mel_points = np.linspace(mel_low, mel_high, n_mels + 2)
    mel_f = _mel_scale(fft_freqs)
    bank = np.zeros((n_mels, n_bins), np.float32)
    for m in range(n_mels):
        left, center, right = mel_points[m], mel_points[m + 1], mel_points[m + 2]
        up = (mel_f - left) / (center - left)
        down = (right - mel_f) / (right - center)
        bank[m] = np.maximum(0.0, np.minimum(up, down))
    return bank


def kaldi_fbank(wav: np.ndarray, n_mels: int = 80, frame_length_ms: float = 25.0,
                frame_shift_ms: float = 10.0, dither: float = 0.0,
                preemphasis: float = 0.97,
                sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Kaldi-compatible log-mel fbank (snip-edges, hamming, power
    spectrum, natural log with flooring) of a float waveform in [-1, 1].

    Kaldi operates on int16-scaled samples; funasr's WavFrontend
    multiplies by 2**15 before fbank, reproduced here.
    """
    wav = np.asarray(wav, np.float32) * 32768.0
    frame_len = int(sample_rate * frame_length_ms / 1000.0)   # 400
    frame_shift = int(sample_rate * frame_shift_ms / 1000.0)  # 160
    if len(wav) < frame_len:
        return np.zeros((0, n_mels), np.float32)
    n_frames = 1 + (len(wav) - frame_len) // frame_shift      # snip_edges
    idx = (np.arange(frame_len)[None, :]
           + frame_shift * np.arange(n_frames)[:, None])
    frames = wav[idx].astype(np.float32)
    if dither > 0:
        frames = frames + dither * np.random.randn(*frames.shape).astype(np.float32)
    # remove DC offset per frame
    frames = frames - frames.mean(axis=1, keepdims=True)
    # preemphasis (kaldi: first sample subtracts itself)
    pre = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
    frames = frames - preemphasis * pre
    window = np.hamming(frame_len).astype(np.float32)
    frames = frames * window
    n_fft = 1
    while n_fft < frame_len:
        n_fft *= 2                                            # 512
    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    bank = kaldi_fbank_mats(n_fft, n_mels, sample_rate)
    mel = power @ bank.T
    return np.log(np.maximum(mel, 1.1920928955078125e-07)).astype(np.float32)


def apply_lfr(feats: np.ndarray, lfr_m: int = 7, lfr_n: int = 6) -> np.ndarray:
    """Low-frame-rate stacking: stack ``lfr_m`` frames every ``lfr_n``,
    left-padded by repeating the first frame (m-1)//2 times and
    right-padded by repeating the last (funasr WavFrontend.apply_lfr)."""
    t = feats.shape[0]
    if t == 0:
        return np.zeros((0, feats.shape[1] * lfr_m), np.float32)
    t_lfr = int(np.ceil(t / lfr_n))
    left = np.repeat(feats[:1], (lfr_m - 1) // 2, axis=0)
    feats = np.concatenate([left, feats], axis=0)
    total = feats.shape[0]
    rows = []
    for i in range(t_lfr):
        start = i * lfr_n
        if lfr_m <= total - start:
            rows.append(feats[start:start + lfr_m].reshape(-1))
        else:
            chunk = feats[start:]
            pad = np.repeat(feats[-1:], lfr_m - chunk.shape[0], axis=0)
            rows.append(np.concatenate([chunk, pad], axis=0).reshape(-1))
    return np.stack(rows).astype(np.float32)


def load_cmvn(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a kaldi-nnet ``am.mvn`` file -> (add_shift, rescale) vectors.

    The file carries an ``<AddShift> .. [ -means ]`` and a
    ``<Rescale> .. [ istds ]`` block; CMVN is x -> (x + shift) * scale.
    """
    with open(path, encoding="utf-8") as f:
        text = f.read()
    vectors = re.findall(r"\[([^\[\]]+)\]", text)
    arrays = []
    for vec in vectors:
        vals = [float(v) for v in vec.split()]
        if len(vals) > 1:
            arrays.append(np.asarray(vals, np.float32))
    if len(arrays) < 2:
        raise ValueError(f"unparseable am.mvn: {path}")
    return arrays[-2], arrays[-1]


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParaformerConfig:
    input_size: int = 560          # 80 mels * LFR 7
    d_model: int = 512
    n_heads: int = 4
    ffn_dim: int = 2048
    encoder_layers: int = 50
    decoder_layers: int = 16
    fsmn_kernel: int = 11
    vocab_size: int = 8404
    predictor_kernel: int = 3
    tail_threshold: float = 0.45
    cif_threshold: float = 1.0
    lfr_m: int = 7
    lfr_n: int = 6

    @classmethod
    def from_yaml(cls, cfg: dict) -> "ParaformerConfig":
        enc = cfg.get("encoder_conf", {})
        dec = cfg.get("decoder_conf", {})
        pred = cfg.get("predictor_conf", {})
        front = cfg.get("frontend_conf", {})
        n_mels = front.get("n_mels", 80)
        lfr_m = front.get("lfr_m", 7)
        return cls(
            input_size=n_mels * lfr_m,
            d_model=enc.get("output_size", 512),
            n_heads=enc.get("attention_heads", 4),
            ffn_dim=enc.get("linear_units", 2048),
            encoder_layers=enc.get("num_blocks", 50),
            decoder_layers=dec.get("num_blocks", 16),
            fsmn_kernel=enc.get("kernel_size", 11),
            vocab_size=cfg.get("vocab_size", 8404),
            predictor_kernel=pred.get("l_order", 1) + pred.get("r_order", 1) + 1,
            tail_threshold=pred.get("tail_threshold", 0.45),
            cif_threshold=pred.get("threshold", 1.0),
            lfr_m=lfr_m,
            lfr_n=front.get("lfr_n", 6),
        )


# ---------------------------------------------------------------------------
# Torch model (FunASR names)
# ---------------------------------------------------------------------------

def positions_from_one(t: int, d: int, device) -> torch.Tensor:
    """FunASR's SinusoidalPositionEncoder over width ``d``: positions 1..t,
    (t, d) fp32 (JAX: asr_paraformer.py:283-290, punc_ct.py:152-159)."""
    pos = torch.arange(1, t + 1, dtype=torch.float32, device=device)[:, None]
    log_timescale = math.log(10000.0) / (d // 2 - 1)
    inv = torch.exp(torch.arange(d // 2, dtype=torch.float32, device=device)
                    * -log_timescale)
    return torch.cat([torch.sin(pos * inv), torch.cos(pos * inv)], 1)[:, :d]


def depthwise_memory(x: torch.Tensor, conv: nn.Conv1d,
                     mask: torch.Tensor) -> torch.Tensor:
    """FSMN memory block: (x + depthwise_conv(x)) * mask over x * mask;
    x (B, T, C), mask (B, T, 1)."""
    x = x * mask
    mem = conv(x.transpose(1, 2)).transpose(1, 2)
    return (x + mem) * mask


def _dwconv(d: int, kernel: int) -> nn.Conv1d:
    return nn.Conv1d(d, d, kernel, padding=(kernel - 1) // 2, groups=d,
                     bias=False)


def _heads(z: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = z.shape
    return z.view(b, t, n_heads, d // n_heads)


def sdpa_attention(q, k, v, valid_lens: torch.Tensor) -> torch.Tensor:
    """Attention over the keys below ``valid_lens[b]`` by PyTorch's SDPA
    with a boolean key mask.  q (B, Tq, H, dk), k/v (B, Tk, H, dk) ->
    (B, Tq, H, dk)."""
    keys = torch.arange(k.shape[1], device=k.device)
    allowed = (keys[None] < valid_lens[:, None])[:, None, None, :]
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=allowed)
    return o.transpose(1, 2)


Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]


class SANMAttention(nn.Module):
    """FunASR MultiHeadedAttentionSANM: fused q/k/v, attention over the
    valid keys through ``attend``, plus the FSMN memory of v."""

    def __init__(self, in_size: int, d: int, n_heads: int, kernel: int,
                 attend: Attend):
        super().__init__()
        self.n_heads = n_heads
        self.attend = attend
        self.linear_q_k_v = nn.Linear(in_size, 3 * d)
        self.linear_out = nn.Linear(d, d)
        self.fsmn_block = _dwconv(d, kernel)

    def forward(self, x, mask, valid_lens):
        b, t, _ = x.shape
        q, k, v = self.linear_q_k_v(x).chunk(3, dim=-1)
        fsmn = depthwise_memory(v, self.fsmn_block, mask)
        o = self.attend(_heads(q, self.n_heads), _heads(k, self.n_heads),
                        _heads(v, self.n_heads), valid_lens)
        return self.linear_out(o.reshape(b, t, -1)) + fsmn


class FeedForward(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.w_1 = nn.Linear(d, hidden)
        self.w_2 = nn.Linear(hidden, d)

    def forward(self, x):
        return self.w_2(F.relu(self.w_1(x)))


class SANMEncoderLayer(nn.Module):
    """Pre-norm SAN-M layer; a first layer whose input is narrower or wider
    than the stream (Paraformer's 560 -> 512) has no attention residual."""

    def __init__(self, in_size: int, d: int, n_heads: int, ffn: int,
                 kernel: int, attend: Attend):
        super().__init__()
        self.residual = in_size == d
        self.norm1 = nn.LayerNorm(in_size, eps=LN_EPS)
        self.self_attn = SANMAttention(in_size, d, n_heads, kernel, attend)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.feed_forward = FeedForward(d, ffn)

    def forward(self, x, mask, valid_lens):
        y = self.self_attn(self.norm1(x), mask, valid_lens)
        x = x + y if self.residual else y
        return x + self.feed_forward(self.norm2(x))


class SANMEncoder(nn.Module):
    """Sinusoids from position 1 over the raw input width after x *
    sqrt(d_model), then ``encoders0`` (one layer from the input width) and
    ``encoders``, then ``after_norm``."""

    def __init__(self, in_size: int, d: int, n_heads: int, ffn: int,
                 kernel: int, n_layers: int, attend: Attend):
        super().__init__()
        self.d = d
        self.encoders0 = nn.ModuleList([SANMEncoderLayer(
            in_size, d, n_heads, ffn, kernel, attend)])
        self.encoders = nn.ModuleList(
            SANMEncoderLayer(d, d, n_heads, ffn, kernel, attend)
            for _ in range(n_layers - 1))
        self.after_norm = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, x, mask, valid_lens):
        t, width = x.shape[1], x.shape[2]
        x = x * self.d ** 0.5 + positions_from_one(t, width, x.device)[None]
        for layer in list(self.encoders0) + list(self.encoders):
            x = layer(x, mask, valid_lens)
        return self.after_norm(x)


class CifPredictor(nn.Module):
    """CifPredictorV2's alpha head: conv (k taps, same padding) -> relu ->
    Linear(d, 1) -> sigmoid, masked.  Returns (B, T)."""

    def __init__(self, d: int, kernel: int):
        super().__init__()
        self.cif_conv1d = nn.Conv1d(d, d, kernel, padding=(kernel - 1) // 2)
        self.cif_output = nn.Linear(d, 1)

    def forward(self, hidden, mask):
        q = self.cif_conv1d(hidden.transpose(1, 2)).transpose(1, 2)
        return (torch.sigmoid(self.cif_output(F.relu(q))) * mask)[..., 0]


class _DecoderFeedForward(nn.Module):
    """PositionwiseFeedForwardDecoderSANM: relu -> LN(ffn) -> w_2 without
    bias."""

    def __init__(self, d: int, ffn: int):
        super().__init__()
        self.w_1 = nn.Linear(d, ffn)
        self.norm = nn.LayerNorm(ffn, eps=LN_EPS)
        self.w_2 = nn.Linear(ffn, d, bias=False)

    def forward(self, x):
        return self.w_2(self.norm(F.relu(self.w_1(x))))


class _DecoderFsmn(nn.Module):
    def __init__(self, d: int, kernel: int):
        super().__init__()
        self.fsmn_block = _dwconv(d, kernel)

    def forward(self, x, mask):
        return depthwise_memory(x, self.fsmn_block, mask)


class _CrossAttention(nn.Module):
    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.linear_q = nn.Linear(d, d)
        self.linear_k_v = nn.Linear(d, 2 * d)
        self.linear_out = nn.Linear(d, d)

    def forward(self, x, memory, memory_lens):
        b, tq, d = x.shape
        k, v = self.linear_k_v(memory).chunk(2, dim=-1)
        o = sdpa_attention(_heads(self.linear_q(x), self.n_heads),
                           _heads(k, self.n_heads), _heads(v, self.n_heads),
                           memory_lens)
        return self.linear_out(o.reshape(b, tq, d))


class _DecoderLayer(nn.Module):
    """DecoderLayerSANM: feed-forward, then the FSMN "self-attention", then
    cross-attention, each pre-norm with a residual; ``decoders3``'s layer
    has the feed-forward only."""

    def __init__(self, c: "ParaformerConfig", has_attn: bool = True):
        super().__init__()
        d = c.d_model
        self.has_attn = has_attn
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.feed_forward = _DecoderFeedForward(d, c.ffn_dim)
        if has_attn:
            self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
            self.self_attn = _DecoderFsmn(d, c.fsmn_kernel)
            self.norm3 = nn.LayerNorm(d, eps=LN_EPS)
            self.src_attn = _CrossAttention(d, c.n_heads)

    def forward(self, x, mask, memory, memory_lens):
        x = x + self.feed_forward(self.norm1(x))
        if self.has_attn:
            x = x + self.self_attn(self.norm2(x), mask)
            x = x + self.src_attn(self.norm3(x), memory, memory_lens)
        return x


class ParaformerDecoder(nn.Module):
    def __init__(self, c: "ParaformerConfig"):
        super().__init__()
        self.decoders = nn.ModuleList(_DecoderLayer(c)
                                      for _ in range(c.decoder_layers))
        self.decoders3 = nn.ModuleList([_DecoderLayer(c, has_attn=False)])
        self.after_norm = nn.LayerNorm(c.d_model, eps=LN_EPS)
        self.output_layer = nn.Linear(c.d_model, c.vocab_size)

    def forward(self, embeds, token_mask, memory, memory_lens):
        x = embeds
        for layer in list(self.decoders) + list(self.decoders3):
            x = layer(x, token_mask, memory, memory_lens)
        return self.output_layer(self.after_norm(x))


class Paraformer(nn.Module):
    def __init__(self, cfg: "ParaformerConfig" = None):
        super().__init__()
        c = cfg or ParaformerConfig()
        self.cfg = c
        self.encoder = SANMEncoder(c.input_size, c.d_model, c.n_heads,
                                   c.ffn_dim, c.fsmn_kernel,
                                   c.encoder_layers, sdpa_attention)
        self.predictor = CifPredictor(c.d_model, c.predictor_kernel)
        self.decoder = ParaformerDecoder(c)

    def encode(self, feats, feat_mask):
        """feats (B, T, input_size), feat_mask (B, T, 1) a prefix of ones
        -> (enc (B, T, d), alphas (B, T))."""
        valid = feat_mask[..., 0].sum(1).to(torch.int32)
        enc = self.encoder(feats, feat_mask, valid)
        return enc, self.predictor(enc, feat_mask)

    def decode(self, enc, memory_lens, embeds, token_mask):
        """Logits (B, N, vocab) of the acoustic embeddings (B, N, d) over
        the encoder output's first ``memory_lens[b]`` frames."""
        return self.decoder(embeds, token_mask, enc, memory_lens)


# ---------------------------------------------------------------------------
# CIF integrate-and-fire (host-side numpy; loop is O(T) scalar work)
# ---------------------------------------------------------------------------

def cif_fire(hidden: np.ndarray, alphas: np.ndarray,
             threshold: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Continuous integrate-and-fire (funasr ``cif``): accumulate alphas
    along time; each crossing of ``threshold`` emits the alpha-weighted
    sum of hidden frames since the previous firing.

    hidden (B, T, C), alphas (B, T) -> (B, N_max, C) embeddings and (B,)
    token counts (= floor of total alpha mass per row).
    """
    b, t, c = hidden.shape
    token_num = np.floor(alphas.sum(axis=1)).astype(np.int32)
    n_max = max(int(token_num.max()), 1) if b else 1
    out = np.zeros((b, n_max, c), np.float32)
    for i in range(b):
        integrate = 0.0
        frame = np.zeros(c, np.float32)
        n = 0
        for ti in range(t):
            alpha = float(alphas[i, ti])
            completion = 1.0 - integrate
            integrate += alpha
            if integrate >= threshold:
                integrate -= 1.0
                frame = frame + completion * hidden[i, ti]
                if n < n_max:
                    out[i, n] = frame
                n += 1
                frame = (alpha - completion) * hidden[i, ti]
            else:
                frame = frame + alpha * hidden[i, ti]
    return out, token_num


def tail_alphas(alphas: np.ndarray, lengths: np.ndarray,
                tail_threshold: float = 0.45) -> np.ndarray:
    """CifPredictorV2 tail handling: add ``tail_threshold`` alpha mass at
    the first frame past each row's valid length (hidden there is zero),
    so trailing sub-threshold mass still fires a final token."""
    b, t = alphas.shape
    out = np.concatenate([alphas, np.zeros((b, 1), np.float32)], axis=1)
    for i in range(b):
        out[i, int(lengths[i])] += tail_threshold
    return out


_SPECIAL_TOKENS = {"<blank>", "<s>", "</s>", "<unk>", "<sos>", "<eos>"}


def tokens_to_text(ids: List[int], tokens: List[str]) -> str:
    """Map token ids to text: zh chars concatenate; English BPE pieces
    ending in ``@@`` merge with the next piece, others get a space."""
    parts: List[str] = []
    merge = False
    for tid in ids:
        if tid < 0 or tid >= len(tokens):
            continue
        tok = tokens[tid]
        if tok in _SPECIAL_TOKENS:
            continue
        if tok.endswith("@@"):
            piece = tok[:-2]
            if merge and parts:
                parts[-1] += piece
            else:
                parts.append(piece)
            merge = True
        elif merge and parts and tok.isascii():
            parts[-1] += tok
            merge = False
        else:
            parts.append(tok)
            merge = False
    out = []
    prev_ascii = False
    for p in parts:
        is_ascii = p.isascii() and p.isalnum()
        if prev_ascii and is_ascii:
            out.append(" ")
        out.append(p)
        prev_ascii = is_ascii
    return "".join(out)


# ---------------------------------------------------------------------------
# Runtime wrapper
# ---------------------------------------------------------------------------

def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A FunASR ``model.pt`` as a state dict (a ``{"state_dict": ...}``
    wrapper unwrapped), as the JAX loaders read it.  Read with
    ``weights_only=True``: a file holding other objects than tensors and
    containers raises instead of running its pickled code."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return state


def find_weights(model_dir: str) -> Optional[str]:
    for name in WEIGHTS:
        p = os.path.join(model_dir, name)
        if os.path.exists(p):
            return p
    return None


def read_config(model_dir: str) -> dict:
    """``config.yaml`` through the port's YAML reader ({} when absent)."""
    path = os.path.join(model_dir, "config.yaml")
    return (simple_yaml.load(path) or {}) if os.path.exists(path) else {}


def read_tokens(model_dir: str) -> List[str]:
    for name in ("tokens.json", "tokens.txt"):
        p = os.path.join(model_dir, name)
        if os.path.exists(p):
            with open(p, encoding="utf-8") as f:
                if name.endswith(".json"):
                    return json.load(f)
                return [line.split()[0] for line in f if line.strip()]
    raise FileNotFoundError("tokens.json/tokens.txt missing")


def bucket(n: int, least: int) -> int:
    """The JAX package's padded length: ``max(least, next power of 2)``."""
    return max(least, 1 << (n - 1).bit_length())


@dataclasses.dataclass
class ParaformerOutput:
    enc: torch.Tensor      # (1, t_pad, d) on the device
    alphas: torch.Tensor   # (1, t_pad)
    logits: Optional[torch.Tensor]   # (1, n, vocab), None with no token
    ids: List[int]


class ParaformerASR:
    """Filesystem-checkpoint Paraformer runner on ``device`` (the card
    unless the caller asks for the CPU).

    ``model_dir`` holds ``model.pt`` (torch state dict), ``config.yaml``,
    ``am.mvn`` and ``tokens.json``/``tokens.txt`` — the layout
    ``tools/fetch_pretrained.py`` produces from the modelscope repo
    ``iic/speech_paraformer-large_asr_nat-zh-cn-16k-common-vocab8404-pytorch``.
    """

    def __init__(self, model_dir: str, device="cuda"):
        self.device = resolve_device(device, "ParaformerASR")
        self.model_dir = model_dir
        self.available = False
        model_path = find_weights(model_dir)
        if model_path is None:
            return
        self.cfg = ParaformerConfig.from_yaml(read_config(model_dir))
        self.tokens = read_tokens(model_dir)
        mvn_path = os.path.join(model_dir, "am.mvn")
        if os.path.exists(mvn_path):
            self.cmvn_shift, self.cmvn_scale = load_cmvn(mvn_path)
        else:
            self.cmvn_shift = np.zeros(self.cfg.input_size, np.float32)
            self.cmvn_scale = np.ones(self.cfg.input_size, np.float32)
        state = {k: v for k, v in load_checkpoint(model_path).items()
                 if not k.startswith(TRAINING_ONLY)}
        self.model = Paraformer(self.cfg)
        self.model.load_state_dict(state, strict=True)
        self.model.to(self.device).eval()
        self.available = True

    # -- public API ---------------------------------------------------------

    def features(self, wav: np.ndarray) -> np.ndarray:
        """fbank -> LFR -> CMVN of a 16 kHz mono wave, (T_lfr, input_size)."""
        feats = kaldi_fbank(wav, n_mels=self.cfg.input_size // self.cfg.lfr_m)
        feats = apply_lfr(feats, self.cfg.lfr_m, self.cfg.lfr_n)
        return (feats + self.cmvn_shift) * self.cmvn_scale

    def transcribe(self, path_or_wav, language: Optional[str] = None) -> str:
        if isinstance(path_or_wav, str):
            from ..utils import audio_io
            wav = audio_io.load_audio(path_or_wav, SAMPLE_RATE, mono=True)
        else:
            wav = np.asarray(path_or_wav, np.float32)
        feats = self.features(wav)
        if feats.shape[0] == 0:
            return ""
        return tokens_to_text(self._infer_ids(feats), self.tokens)

    def _infer_ids(self, feats: np.ndarray) -> List[int]:
        return self._infer(feats).ids

    @torch.no_grad()
    def _infer(self, feats: np.ndarray) -> ParaformerOutput:
        """Encode, fire and decode one clip's features, as the JAX
        ``_infer_ids`` (asr_paraformer.py:765-798): the frames padded to
        the JAX bucket, the tail mass at frame t, the tokens padded to
        ``max(8, next power of 2)``."""
        dev = self.device
        t = feats.shape[0]
        t_pad = bucket(t, 16)
        x = torch.zeros((1, t_pad, feats.shape[1]), device=dev)
        x[0, :t] = torch.from_numpy(np.asarray(feats, np.float32)).to(dev)
        mask = torch.zeros((1, t_pad, 1), device=dev)
        mask[0, :t] = 1.0
        enc, alphas = self.model.encode(x, mask)
        enc_h, alphas_h = enc.cpu().numpy(), alphas.cpu().numpy()
        alphas_t = tail_alphas(alphas_h, np.array([t]),
                               self.cfg.tail_threshold)
        hidden = np.concatenate(
            [enc_h, np.zeros((1, 1, enc_h.shape[2]), np.float32)], axis=1)
        embeds, token_num = cif_fire(hidden, alphas_t,
                                     self.cfg.cif_threshold)
        n = int(token_num[0])
        if n <= 0:
            return ParaformerOutput(enc, alphas, None, [])
        n_pad = bucket(n, 8)
        emb = torch.zeros((1, n_pad, embeds.shape[2]), device=dev)
        emb[0, :n] = torch.from_numpy(embeds[0, :n]).to(dev)
        tmask = torch.zeros((1, n_pad, 1), device=dev)
        tmask[0, :n] = 1.0
        logits = self.model.decode(
            enc, torch.tensor([t], dtype=torch.int32, device=dev), emb,
            tmask)[:, :n]
        ids = logits[0].argmax(-1).tolist()
        return ParaformerOutput(enc, alphas, logits, ids)
