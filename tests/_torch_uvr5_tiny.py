"""Tiny UVR5 nets, band configs and weight writers shared by
tests/test_torch_uvr5.py, tests/test_torch_separators.py and
tests/test_torch_host.py: seeded random torch weights in the released key
layouts (``chip_smoke.uvr5_random_state``), read by both packages."""
import dataclasses

import numpy as np
import torch

import chip_smoke
from easevoice_trainer_tpu_torch.audiokit import bs_roformer as pbs
from easevoice_trainer_tpu_torch.audiokit import mdxnet as pmdx
from easevoice_trainer_tpu_torch.audiokit import uvr5 as puvr5
from easevoice_trainer_tpu_torch.audiokit import uvr5_deecho as pdeecho

VR = dict(ch1=4, ch2=2, ch3=4)                 # tests/test_uvr5.py:32
DEECHO = dict(nout=8, nout_lstm=16)
N_FFT = 128

# tests/test_mdxnet.py:20's SMALL
MDX = pmdx.MDXConfig(num_blocks=5, g=8, k=3, l=2, bn=4, bias=False,
                     norm="group", dim_c=4, dim_f=64, dim_t=32, n_fft=512,
                     hop=128)
# tests/test_uvr5.py:100's tiny BS-Roformer (in stereo), and a Mel-Band
# Roformer of the same size
BS = pbs.BSRoformerConfig(dim=16, depth=2, stereo=True,
                          freqs_per_bands=(2, 3, 4), dim_head=8, heads=2,
                          stft_n_fft=16, stft_hop_length=8,
                          stft_win_length=16, mask_estimator_depth=2)
MEL = pbs.MelBandRoformerConfig(dim=16, depth=2, num_bands=6, dim_head=8,
                                heads=2, sample_rate=8000, stft_n_fft=32,
                                stft_hop_length=8, stft_win_length=32)


def band_params(agg_bins: int = 60) -> dict:
    """A 3-band config of 64 bins (a net at n_fft 128): 7350 / 14700 / 44100
    Hz at 367.5 frames a second, cropped 10 + 20 + 35 = 65 rows, with the
    low-, band- and high-pass fades and the pre-filter roll-off."""
    return {
        "bins": 64, "unstable_bins": 0, "reduction_bins": agg_bins,
        "band": {
            "1": {"sr": 7350, "hl": 20, "n_fft": 32, "crop_start": 0,
                  "crop_stop": 10, "lpf_start": 6, "lpf_stop": 9},
            "2": {"sr": 14700, "hl": 40, "n_fft": 64, "crop_start": 5,
                  "crop_stop": 25, "hpf_start": 9, "hpf_stop": 6,
                  "lpf_start": 18, "lpf_stop": 24},
            "3": {"sr": 44100, "hl": 120, "n_fft": 128, "crop_start": 30,
                  "crop_stop": 65, "hpf_start": 36, "hpf_stop": 31},
        },
        "sr": 44100, "pre_filter_start": 60, "pre_filter_stop": 64,
        "mid_side": False, "mid_side_b2": False, "reverse": False,
    }


def random_state(module, seed: int) -> dict:
    return chip_smoke.uvr5_random_state(
        torch, module, torch.Generator().manual_seed(seed))


def vr_state(seed: int = 0, enlarge: bool = False, n_fft: int = N_FFT):
    return random_state(puvr5.CascadedASPPNet(n_fft, enlarge=enlarge, **VR),
                        seed)


def deecho_state(seed: int = 0, n_fft: int = N_FFT):
    return random_state(pdeecho.CascadedNet(n_fft, **DEECHO), seed)


def numpy_state(state: dict) -> dict:
    return {k: v.numpy() for k, v in state.items()}


def jax_config(jax_cls, cfg):
    """The JAX package's config dataclass with the port's field values."""
    return jax_cls(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


class Reads(dict):
    """A state dict that records the keys read from it."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def stereo_clip(seconds: float, seed: int, sr: int = 44100) -> np.ndarray:
    """(2, n) float32: noise under a few tones, different in each channel."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    tones = sum(np.sin(2 * np.pi * f * t) / (i + 1)
                for i, f in enumerate((220.0, 330.0, 1250.0)))
    return np.stack([0.3 * tones, 0.2 * tones]).astype(np.float32) + \
        rng.normal(0, 0.05, (2, n)).astype(np.float32)
