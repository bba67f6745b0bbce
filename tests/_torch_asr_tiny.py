"""Tiny ASR model directories shared by ``tests/test_torch_asr.py`` and
``tests/test_torch_whisper.py``: FunASR's layouts for Paraformer, the
fsmn-VAD and CT-punc, HF's for Whisper, written by ``chip_smoke.py``'s own
writers (the ones its data prep phase uses at full width on the card) at
small widths, with seeded random weights."""
from __future__ import annotations

import os

import torch

from easevoice_trainer_tpu_torch.audiokit import asr_paraformer, \
    asr_whisper, punc_ct, vad_fsmn
from easevoice_trainer_tpu_torch.utils import paths

from _torch_bert_tiny import chip_smoke

# 2-3 layers at d 64, FunASR's kernels and LFR rates
PARA = asr_paraformer.ParaformerConfig(
    input_size=16 * 7, d_model=64, n_heads=2, ffn_dim=128, encoder_layers=3,
    decoder_layers=2, fsmn_kernel=11, vocab_size=60)
VAD = vad_fsmn.FsmnVadConfig(
    input_dim=16 * 5, input_affine_dim=24, fsmn_layers=2, linear_dim=32,
    proj_dim=16, lorder=20, output_affine_dim=24, output_dim=12)
# CT-punc's head width, 32, at d 64
PUNC = punc_ct.CTPuncConfig(vocab_size=200, embed_unit=64, d_model=64,
                            n_heads=2, ffn_dim=128, num_blocks=3)
CHARS = "我们都去了北京银行的行长今天还在重新调整数据"

# 2 + 2 layers at d 128, 2 heads of 64; a 300-piece byte-level BPE, four
# languages (no <|yue|>, as in whisper-small) and 51 timestamps
WHISPER_LANGS = ("en", "zh", "ja", "ko")
WHISPER_TOKENIZER = chip_smoke.whisper_tokenizer_json(300, WHISPER_LANGS, 51)
WHISPER = asr_whisper.WhisperConfig(
    n_mels=80, d_model=128, encoder_layers=2, decoder_layers=2, n_heads=2,
    ffn_dim=256, vocab_size=300 + 2 + len(WHISPER_LANGS) + 6 + 51,
    max_source_positions=1500, max_target_positions=448)


def write_zh_dirs(root, seed=0):
    """paraformer-zh, fsmn-vad and ct-punc under ``root``; their paths."""
    return chip_smoke.write_asr_dirs(
        torch, str(root), torch.Generator().manual_seed(seed), PARA, VAD,
        PUNC, CHARS)


def write_whisper_dir(root, seed=0, cfg=WHISPER, weights="model.safetensors"):
    """A Whisper directory; returns the port's state dict."""
    return chip_smoke.write_whisper_dir(
        torch, str(root), cfg, torch.Generator().manual_seed(seed),
        WHISPER_TOKENIZER, weights)


def write_clips(out_dir, seconds=(2.6, 4.1, 3.3), seed=7):
    """Speech-like 16 kHz clips in ``out_dir/denoises``; their paths."""
    den = os.path.join(str(out_dir), paths.DENOISES_OUTPUT)
    os.makedirs(den, exist_ok=True)
    out = []
    for i, s in enumerate(seconds):
        path = os.path.join(den, f"clip{i}.wav")
        chip_smoke.write_speech_source(path, seed + i, s, 16000)
        out.append(path)
    return out
