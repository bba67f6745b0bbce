"""Tiny models shared by the ``test_torch_*`` parity tests.

Weights are made once, as seeded random tensors for the PyTorch port
(``convert.random_state_dict``), carried into JAX parameter trees by the JAX
package's own checkpoint readers (``train/ckpt.py`` ``torch_to_flax`` and
``models/cnhubert.py`` ``convert_hf_hubert``), and carried back into the
port through ``easevoice_trainer_tpu_torch.convert``.  Sizes are those of
``tests/test_inference.py``'s tiny TTS.
"""
from __future__ import annotations

import numpy as np
import torch

from easevoice_trainer_tpu.models.cnhubert import convert_hf_hubert
from easevoice_trainer_tpu.train import ckpt
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch.models.cnhubert import CNHubert, HubertConfig
from easevoice_trainer_tpu_torch.models.gpt import T2SConfig, \
    Text2SemanticDecoder
from easevoice_trainer_tpu_torch.models.sovits import \
    MultiPeriodDiscriminator, SovitsConfig, SynthesizerTrn

SOVITS_KW = dict(
    spec_channels=1025, segment_size=2560, inter_channels=32,
    hidden_channels=32, filter_channels=64, n_heads=2, n_layers=2,
    upsample_initial_channel=32, gin_channels=32, ssl_dim=64,
    n_symbols=732, p_dropout=0.0)
T2S_KW = dict(vocab_size=1025, phoneme_vocab_size=732, embedding_dim=32,
              hidden_dim=32, n_heads=4, n_layers=2, ffn_dim=64, dropout=0.0,
              eos_id=1024)
HUBERT_KW = dict(conv_dim=(16,) * 7, hidden_size=64, num_layers=2,
                 num_heads=4, intermediate_size=128, pos_conv_kernel=16,
                 pos_conv_groups=4)


def _numpy_state(module: torch.nn.Module, seed: int):
    gen = torch.Generator().manual_seed(seed)
    return {k: v.numpy() for k, v in
            convert.random_state_dict(module, gen).items()}


def tiny_sovits(seed: int = 0):
    """-> (port SynthesizerTrn loaded via convert.py, JAX params tree,
    original numpy state)."""
    model = SynthesizerTrn(SovitsConfig(**SOVITS_KW))
    state = _numpy_state(model, seed)
    params, unmatched = ckpt.torch_to_flax(state,
                                           ckpt.sovits_generator_rules())
    assert not unmatched, unmatched
    model.load_state_dict(convert.sovits_state_dict(params), strict=True)
    return model.eval(), params, state


def tiny_sovits_train(seed: int = 3):
    """The training build (with ``enc_q``): -> (port module in train mode,
    JAX params tree with enc_q)."""
    model = SynthesizerTrn(SovitsConfig(**SOVITS_KW), with_enc_q=True)
    state = _numpy_state(model, seed)
    params, unmatched = ckpt.torch_to_flax(state,
                                           ckpt.sovits_generator_rules())
    assert not unmatched, unmatched
    model.load_state_dict(convert.sovits_state_dict(params, keep_enc_q=True),
                          strict=True)
    return model.train(), params


def tiny_mpd(periods=(2, 3, 5, 7, 11), seed: int = 4):
    """Full-width MultiPeriodDiscriminator: -> (port module in train mode,
    JAX params tree)."""
    model = MultiPeriodDiscriminator(periods)
    state = _numpy_state(model, seed)
    rules = ckpt.sovits_discriminator_rules(periods)
    params, unmatched = ckpt.torch_to_flax(state, rules)
    assert not unmatched, unmatched
    model.load_state_dict(convert.discriminator_state_dict(params, periods),
                          strict=True)
    return model.train(), params


def tiny_gpt(seed: int = 1, **cfg_kw):
    """-> (port Text2SemanticDecoder in eval mode, JAX params tree, original
    numpy state); ``cfg_kw`` overrides T2S_KW."""
    model = Text2SemanticDecoder(T2SConfig(**{**T2S_KW, **cfg_kw}))
    state = _numpy_state(model, seed)
    params, unmatched = ckpt.torch_to_flax(state, ckpt.gpt_rules())
    assert not unmatched, unmatched
    model.load_state_dict(convert.gpt_state_dict(params), strict=True)
    return model.eval(), params, state


def tiny_hubert(seed: int = 2):
    model = CNHubert(HubertConfig(**HUBERT_KW))
    state = _numpy_state(model, seed)
    params = convert_hf_hubert(state)
    model.load_state_dict(convert.hubert_state_dict(params), strict=True)
    return model.eval(), params, state


def assert_close(port, ref, rtol, name=""):
    """max |port - ref| <= rtol * max(1, max |ref|)."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    err = np.abs(port - ref).max() if ref.size else 0.0
    bound = rtol * max(1.0, np.abs(ref).max() if ref.size else 0.0)
    assert err <= bound, f"{name}: max|d|={err:.3g} > {bound:.3g}"
