"""Whisper ASR for the languages other than zh (JAX: audiokit/asr_whisper.py).

Host copies of the JAX package's, under the same names: ``WhisperConfig``,
the log-mel frontend (``mel_filters``, ``log_mel_spectrogram``: n_fft 400,
hop 160, slaney mels, log10 with the max - 8 dB clamp) and the encoder's
``_sinusoids``.  The net runs on the ASR's device, with
``WhisperForConditionalGeneration``'s module names (the source side of the
JAX ``convert_whisper_weights``; a checkpoint's ``model.`` prefix is
optional):

* the encoder: two convs (the second of stride 2) with exact GELU, the
  computed sinusoids (the checkpoint's ``encoder.embed_positions`` is not
  read, as in JAX), pre-norm layers whose self-attention runs on K1's dk-64
  instance (``ops.attention.encoder_attention``, every one of the 1500
  frames valid): 12 launches a 30 s chunk at whisper-small's widths;
* the decoder, KV-cached and greedy: one prefill over the forced prompt
  under a causal mask over the 448 cache slots, then one token at a time up
  to ``max_new`` or ``<|endoftext|>``; the cross-attention K/V are computed
  once a chunk (the JAX ``CrossKV``).  Its attention (a prompt or one query
  over the cache, one query over 1500 frames) is PyTorch's
  ``scaled_dot_product_attention``, as the JAX package leaves it to XLA:
  K2, the port's decode kernel, is written for the GPT's dk 32 and its
  text / audio cache.  Logits are the final norm's output times the token
  embedding.

As in the JAX nets, q is scaled by ``dk ** -0.5`` before its product (K1
scales the scores instead: the two differ in rounding only), ``k_proj`` has
no bias, and the LayerNorms use flax's eps 1e-6.

``WhisperASR`` reads ``model.safetensors`` (through the port's reader) or
``pytorch_model.bin``, ``config.json`` and the tokenizer files (the port's
own byte-level BPE decoder, :mod:`..text.whisper_tokenizer`).  A directory
that is absent or holds no weights gives ``available=False``; weights that
are present and do not load raise (the JAX class logs a warning and reports
``available=False``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import encoder_attention
from ..text.whisper_tokenizer import WhisperTokenizer
from ..utils import safetensors_io
from ..utils.device import resolve_device

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
CHUNK_SECONDS = 30
CHUNK_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS          # 480000
N_FRAMES = CHUNK_SAMPLES // HOP                      # 3000


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    n_heads: int = 6
    ffn_dim: int = 1536
    vocab_size: int = 51865
    max_source_positions: int = 1500
    max_target_positions: int = 448

    @classmethod
    def from_hf(cls, cfg: dict) -> "WhisperConfig":
        return cls(
            n_mels=cfg.get("num_mel_bins", 80),
            d_model=cfg.get("d_model", 384),
            encoder_layers=cfg.get("encoder_layers", 4),
            decoder_layers=cfg.get("decoder_layers", 4),
            n_heads=cfg.get("encoder_attention_heads", 6),
            ffn_dim=cfg.get("encoder_ffn_dim", 1536),
            vocab_size=cfg.get("vocab_size", 51865),
            max_source_positions=cfg.get("max_source_positions", 1500),
            max_target_positions=cfg.get("max_target_positions", 448),
        )


# ---------------------------------------------------------------------------
# log-mel frontend (numpy, matches transformers.WhisperFeatureExtractor)
# ---------------------------------------------------------------------------


def _hz_to_mel(f):
    """Slaney mel scale (librosa default, whisper's filter bank)."""
    f = np.asarray(f, np.float64)
    mel = 3.0 * f / 200.0
    log_region = f >= 1000.0
    mel = np.where(log_region,
                   15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                   / np.log(6.4) * 27.0, mel)
    return mel


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f = 200.0 * m / 3.0
    log_region = m >= 15.0
    f = np.where(log_region, 1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0),
                 f)
    return f


def mel_filters(n_mels: int) -> np.ndarray:
    """(n_mels, 1 + n_fft/2) slaney-normalized triangular filter bank."""
    fft_freqs = np.fft.rfftfreq(N_FFT, 1.0 / SAMPLE_RATE)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(8000.0), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    return (fb * enorm[:, None]).astype(np.float32)


def log_mel_spectrogram(wav: np.ndarray, n_mels: int) -> np.ndarray:
    """(samples,) float32 @16 kHz -> (n_mels, frames); whisper semantics."""
    wav = np.asarray(wav, np.float32)
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float64)
    pad = N_FFT // 2
    y = np.pad(wav.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - N_FFT) // HOP
    idx = np.arange(n_frames)[:, None] * HOP + np.arange(N_FFT)[None, :]
    stft = np.fft.rfft(y[idx] * window, axis=-1)
    magnitudes = (np.abs(stft[:-1]) ** 2).T            # drop last frame
    mel = mel_filters(n_mels) @ magnitudes
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's encoder positional embedding."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# model (HF names)
# ---------------------------------------------------------------------------

LN_EPS = 1e-6  # flax's LayerNorm default, which the JAX Whisper uses
WEIGHTS = ("model.safetensors", "pytorch_model.bin")
# checkpoint entries the net does not read: the LM head tied to the token
# embedding, and the encoder's stored sinusoids (computed here, as in JAX)
NOT_READ = ("proj_out.weight", "encoder.embed_positions.weight")


class _Attention(nn.Module):
    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def split(self, z: torch.Tensor) -> torch.Tensor:
        b, t, d = z.shape
        return z.view(b, t, self.n_heads, d // self.n_heads)

    def query(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, T, dk) queries, scaled by dk ** -0.5 as in JAX."""
        q = self.split(self.q_proj(x))
        return (q * q.shape[-1] ** -0.5).transpose(1, 2)

    def keys_values(self, x: torch.Tensor):
        """(B, T, H, dk) keys and values of ``x``."""
        return self.split(self.k_proj(x)), self.split(self.v_proj(x))

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """o (B, H, T, dk) -> (B, T, d) through ``out_proj``."""
        b, _, t, _ = o.shape
        return self.out_proj(o.transpose(1, 2).reshape(b, t, -1))


class _EncoderLayer(nn.Module):
    def __init__(self, c: WhisperConfig):
        super().__init__()
        self.self_attn = _Attention(c.d_model, c.n_heads)
        self.self_attn_layer_norm = nn.LayerNorm(c.d_model, eps=LN_EPS)
        self.fc1 = nn.Linear(c.d_model, c.ffn_dim)
        self.fc2 = nn.Linear(c.ffn_dim, c.d_model)
        self.final_layer_norm = nn.LayerNorm(c.d_model, eps=LN_EPS)

    def forward(self, x, valid_lens):
        att = self.self_attn
        y = self.self_attn_layer_norm(x)
        k, v = att.keys_values(y)
        o = encoder_attention(att.split(att.q_proj(y)), k, v, valid_lens)
        x = x + att.out_proj(o.reshape(x.shape))
        y = self.final_layer_norm(x)
        return x + self.fc2(F.gelu(self.fc1(y)))


class WhisperEncoder(nn.Module):
    def __init__(self, c: WhisperConfig):
        super().__init__()
        self.conv1 = nn.Conv1d(c.n_mels, c.d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(c.d_model, c.d_model, 3, stride=2, padding=1)
        self.layers = nn.ModuleList(_EncoderLayer(c)
                                    for _ in range(c.encoder_layers))
        self.layer_norm = nn.LayerNorm(c.d_model, eps=LN_EPS)
        self.register_buffer("positions", torch.from_numpy(_sinusoids(
            c.max_source_positions, c.d_model)), persistent=False)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, n_mels, 2 * max_source_positions) -> (B, T, d)."""
        x = F.gelu(self.conv1(mel))
        x = F.gelu(self.conv2(x)).transpose(1, 2) + self.positions[None]
        valid = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                           device=x.device)
        for layer in self.layers:
            x = layer(x, valid)
        return self.layer_norm(x)


class _DecoderLayer(nn.Module):
    def __init__(self, c: WhisperConfig):
        super().__init__()
        self.self_attn = _Attention(c.d_model, c.n_heads)
        self.self_attn_layer_norm = nn.LayerNorm(c.d_model, eps=LN_EPS)
        self.encoder_attn = _Attention(c.d_model, c.n_heads)
        self.encoder_attn_layer_norm = nn.LayerNorm(c.d_model, eps=LN_EPS)
        self.fc1 = nn.Linear(c.d_model, c.ffn_dim)
        self.fc2 = nn.Linear(c.ffn_dim, c.d_model)
        self.final_layer_norm = nn.LayerNorm(c.d_model, eps=LN_EPS)


@dataclasses.dataclass
class DecoderState:
    """One chunk's decoder state: the self-attention caches (L, B, slots,
    H, dk) and the cross-attention K/V of each layer (B, H, frames, dk)."""
    k_cache: torch.Tensor
    v_cache: torch.Tensor
    cross: List[Tuple[torch.Tensor, torch.Tensor]]


class WhisperDecoder(nn.Module):
    def __init__(self, c: WhisperConfig):
        super().__init__()
        self.cfg = c
        self.embed_tokens = nn.Embedding(c.vocab_size, c.d_model)
        self.embed_positions = nn.Embedding(c.max_target_positions,
                                            c.d_model)
        self.layers = nn.ModuleList(_DecoderLayer(c)
                                    for _ in range(c.decoder_layers))
        self.layer_norm = nn.LayerNorm(c.d_model, eps=LN_EPS)

    def start(self, enc: torch.Tensor) -> DecoderState:
        """Empty caches of ``max_target_positions`` slots, and the cross
        K/V of ``enc`` (B, frames, d), once a chunk (the JAX CrossKV)."""
        c = self.cfg
        b = enc.shape[0]
        shape = (c.decoder_layers, b, c.max_target_positions, c.n_heads,
                 c.d_model // c.n_heads)
        cross = [tuple(z.transpose(1, 2) for z in
                       layer.encoder_attn.keys_values(enc))
                 for layer in self.layers]
        return DecoderState(enc.new_zeros(shape), enc.new_zeros(shape),
                            cross)

    def forward(self, tokens: torch.Tensor, pos0: int,
                state: DecoderState) -> torch.Tensor:
        """Logits (B, Tq, vocab) of ``tokens`` (B, Tq) at positions
        ``pos0 ..``, their K/V written into the caches at those slots; each
        query sees the cache slots up to its own position."""
        tq = tokens.shape[1]
        end = pos0 + tq
        x = (self.embed_tokens(tokens)
             + self.embed_positions.weight[pos0:end][None])
        mask = None
        if tq > 1:
            slots = torch.arange(end, device=x.device)
            mask = slots[None, :] <= (pos0 + torch.arange(
                tq, device=x.device))[:, None]
        for i, layer in enumerate(self.layers):
            att = layer.self_attn
            y = layer.self_attn_layer_norm(x)
            k, v = att.keys_values(y)
            state.k_cache[i, :, pos0:end] = k
            state.v_cache[i, :, pos0:end] = v
            o = F.scaled_dot_product_attention(
                att.query(y), state.k_cache[i, :, :end].transpose(1, 2),
                state.v_cache[i, :, :end].transpose(1, 2), attn_mask=mask,
                scale=1.0)
            x = x + att.out(o)
            cross = layer.encoder_attn
            ck, cv = state.cross[i]
            y = layer.encoder_attn_layer_norm(x)
            o = F.scaled_dot_product_attention(cross.query(y), ck, cv,
                                               scale=1.0)
            x = x + cross.out(o)
            y = layer.final_layer_norm(x)
            x = x + layer.fc2(F.gelu(layer.fc1(y)))
        return self.layer_norm(x) @ self.embed_tokens.weight.T


class Whisper(nn.Module):
    def __init__(self, cfg: WhisperConfig = WhisperConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = WhisperEncoder(cfg)
        self.decoder = WhisperDecoder(cfg)

    @torch.no_grad()
    def greedy(self, mel: torch.Tensor, forced: List[int], eos: int,
               max_new: int = 224) -> List[int]:
        """The JAX ``make_transcriber`` run (asr_whisper.py:357-412) on one
        chunk: encode, prefill the forced prompt, then greedy steps until
        ``eos`` or ``max_new`` tokens in all; the tokens, ``eos`` last
        where it came.  Raises where the prompt and ``max_new`` tokens
        would outgrow the cache (the JAX loop would clamp the slot)."""
        if len(forced) + max_new > self.cfg.max_target_positions:
            raise ValueError(f"{len(forced)} forced + {max_new} new tokens "
                             f"exceed the {self.cfg.max_target_positions} "
                             f"decoder positions")
        state = self.decoder.start(self.encoder(mel))
        forced_t = torch.tensor([forced], dtype=torch.long,
                                device=mel.device)
        last = int(self.decoder(forced_t, 0, state)[0, -1].argmax())
        tokens = [last]
        pos = len(forced)
        while last != eos and len(tokens) < max_new:
            step = torch.tensor([[last]], dtype=torch.long, device=mel.device)
            last = int(self.decoder(step, pos, state)[0, -1].argmax())
            tokens.append(last)
            pos += 1
        return tokens


def hf_state_for_load(state: dict) -> dict:
    """A ``WhisperForConditionalGeneration`` state dict as the port's
    names: the ``model.`` prefix off, :data:`NOT_READ` dropped, fp32."""
    out = {}
    for k, v in state.items():
        k = k[len("model."):] if k.startswith("model.") else k
        if k not in NOT_READ:
            out[k] = torch.as_tensor(v).to(torch.float32)
    return out


# ---------------------------------------------------------------------------
# runtime wrapper
# ---------------------------------------------------------------------------


class WhisperASR:
    """HF-checkpoint-backed transcriber on ``device`` (the card unless the
    caller asks for the CPU); ``available`` is False without a model
    directory or without weights in it."""

    LANG_TOKENS = {"zh": "<|zh|>", "en": "<|en|>", "ja": "<|ja|>",
                   "ko": "<|ko|>", "yue": "<|yue|>"}

    def __init__(self, model_dir: Optional[str], device="cuda"):
        self.device = resolve_device(device, "WhisperASR")
        self.available = False
        if not model_dir or not os.path.isdir(model_dir):
            return
        path = next((os.path.join(model_dir, n) for n in WEIGHTS
                     if os.path.exists(os.path.join(model_dir, n))), None)
        if path is None:
            return
        with open(os.path.join(model_dir, "config.json"),
                  encoding="utf8") as f:
            self.cfg = WhisperConfig.from_hf(json.load(f))
        if path.endswith(".safetensors"):
            state = safetensors_io.load_file(path)
        else:
            state = torch.load(path, map_location="cpu", weights_only=True)
        self.model = Whisper(self.cfg)
        self.model.load_state_dict(hf_state_for_load(state), strict=True)
        self.model.to(self.device).eval()
        self.tokenizer = WhisperTokenizer.from_pretrained(model_dir)
        self.available = True

    def _forced(self, language: Optional[str]) -> np.ndarray:
        sot = self.tokenizer.convert_tokens_to_ids("<|startoftranscript|>")
        ids = [sot]
        if language and language in self.LANG_TOKENS:
            lang_id = self.tokenizer.convert_tokens_to_ids(
                self.LANG_TOKENS[language])
            if lang_id is not None and lang_id >= 0:
                ids.append(lang_id)
        for tok in ("<|transcribe|>", "<|notimestamps|>"):
            tid = self.tokenizer.convert_tokens_to_ids(tok)
            if tid is not None and tid >= 0:
                ids.append(tid)
        return np.asarray(ids, np.int32)

    def chunk_mels(self, wav: np.ndarray) -> List[np.ndarray]:
        """(1, n_mels, 3000) log-mels of each 30 s chunk, zero-padded."""
        mels = []
        for start in range(0, max(len(wav), 1), CHUNK_SAMPLES):
            chunk = wav[start:start + CHUNK_SAMPLES]
            if not len(chunk):
                break
            padded = np.zeros(CHUNK_SAMPLES, np.float32)
            padded[:len(chunk)] = chunk
            mels.append(log_mel_spectrogram(padded, self.cfg.n_mels)[None])
        return mels

    def transcribe(self, path: str, language: Optional[str] = "zh") -> str:
        from ..utils import audio_io

        wav, sr = audio_io.read_wav(path)
        if wav.ndim > 1:
            wav = wav.mean(axis=0)
        if sr != SAMPLE_RATE:
            wav = audio_io.resample(wav, sr, SAMPLE_RATE)
        eos = self.tokenizer.convert_tokens_to_ids("<|endoftext|>")
        forced = self._forced(language).tolist()
        texts: List[str] = []
        for mel in self.chunk_mels(wav):
            tokens = self.model.greedy(
                torch.from_numpy(mel).to(self.device), forced, eos)
            texts.append(self.tokenizer.decode(
                [t for t in tokens if t != eos], skip_special_tokens=True))
        return "".join(texts).strip()
