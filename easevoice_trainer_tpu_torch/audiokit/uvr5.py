"""UVR5 vocal separation (JAX: audiokit/uvr5.py), in plain torch.

The VR-architecture separator: a multiband analysis (one STFT a band at the
band's rate, hop and size, cropped and stacked into one combined
spectrogram), a three-stage cascaded U-Net with ASPP predicting a sigmoid
vocal mask over 512-frame windows (run as one batch, overlapping by a
128-frame offset), and a progressive multiband synthesis with the bands'
low- and high-pass fades.  The analysis, the windowing and the synthesis
are the JAX package's numpy, copied; only the net runs on the device.  Its
convolutions and BatchNorms are cuDNN calls: the JAX package computes them
with XLA, outside any Pallas kernel.

Modules are NCHW (batch, channels, bins, frames) and carry the reference's
torch names (``stg1_low_band_net.enc1.conv1.conv.0.weight``, ...), so a
released ``.pth`` loads with ``load_state_dict(strict=True)`` (BatchNorm's
``num_batches_tracked`` counters are not read).  The band configs are the
port's own copies in ``uvr5_params/``.

``get_separator`` dispatches by model name as the JAX one does: "roformer"
-> BS-Roformer (``bs_roformer.py``, "mel" -> Mel-Band Roformer), "mdx" or
"onnx" -> MDX-Net (``mdxnet.py``), "DeEcho" -> the DeEcho / DeReverb net
(``uvr5_deecho.py``), anything else -> the VR net.  Weights are read from
``<base>/models/uvr5_weights``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import audio_io, paths
from ..utils.device import resolve_device

PARAMS_DIR = os.path.join(os.path.dirname(__file__), "uvr5_params")


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), bilinear with align_corners=True."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def crop_to(skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Center-crop ``skip`` to ``x``'s bins and frames (crop_center)."""
    th, tw = x.shape[2], x.shape[3]
    top = (skip.shape[2] - th) // 2
    left = (skip.shape[3] - tw) // 2
    return skip[:, :, top:top + th, left:left + tw]


def pad_mask(mask: torch.Tensor, output_bin: int) -> torch.Tensor:
    """Repeat the mask's last bin up to ``output_bin`` bins."""
    pad = output_bin - mask.shape[2]
    return torch.cat([mask, mask[:, :, -1:].expand(-1, -1, pad, -1)], dim=2)


class ConvBNActiv(nn.Module):
    """Conv2DBNActiv / SeperableConv2DBNActiv of the reference's
    ``layers.py``: conv (depthwise + pointwise when separable), BatchNorm,
    ReLU or leaky ReLU (slope 0.01)."""

    def __init__(self, nin: int, nout: int, ksize: int = 3, stride: int = 1,
                 pad: int = 1, dilation: int = 1, separable: bool = False,
                 leaky: bool = False):
        super().__init__()
        if separable:
            self.conv = nn.Sequential(
                nn.Conv2d(nin, nin, ksize, stride, pad, dilation, groups=nin,
                          bias=False),
                nn.Conv2d(nin, nout, 1, bias=False), nn.BatchNorm2d(nout))
        else:
            self.conv = nn.Sequential(
                nn.Conv2d(nin, nout, ksize, stride, pad, dilation,
                          bias=False),
                nn.BatchNorm2d(nout))
        self.leaky = leaky

    def forward(self, x):
        x = self.conv(x)
        return F.leaky_relu(x, 0.01) if self.leaky else F.relu(x)


class VREncoder(nn.Module):
    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv1 = ConvBNActiv(nin, nout, 3, 1, 1, leaky=True)
        self.conv2 = ConvBNActiv(nout, nout, 3, 2, 1, leaky=True)

    def forward(self, x):
        skip = self.conv1(x)
        return self.conv2(skip), skip


class VRDecoder(nn.Module):
    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv = ConvBNActiv(nin, nout, 3, 1, 1)

    def forward(self, x, skip=None):
        x = upsample2(x)
        if skip is not None:
            x = torch.cat([x, crop_to(skip, x)], dim=1)
        return self.conv(x)


class _FreqPool(nn.Module):
    """AdaptiveAvgPool2d((1, None)): the mean over the bins."""

    def forward(self, x):
        return x.mean(dim=2, keepdim=True)


class ASPPModule(nn.Module):
    def __init__(self, nin: int, nout: int, dilations=(4, 8, 16),
                 enlarge: bool = False):
        super().__init__()
        self.conv1 = nn.Sequential(_FreqPool(),
                                   ConvBNActiv(nin, nin, 1, 1, 0))
        self.conv2 = ConvBNActiv(nin, nin, 1, 1, 0)
        dils = list(dilations) + ([dilations[2]] * 2 if enlarge else [])
        self.names = [f"conv{i + 3}" for i in range(len(dils))]
        for name, d in zip(self.names, dils):
            setattr(self, name, ConvBNActiv(nin, nin, 3, 1, d, d,
                                            separable=True))
        self.bottleneck = nn.Sequential(
            ConvBNActiv(nin * (2 + len(dils)), nout, 1, 1, 0))

    def forward(self, x):
        feats = [self.conv1(x).expand(-1, -1, x.shape[2], -1), self.conv2(x)]
        feats += [getattr(self, name)(x) for name in self.names]
        return self.bottleneck(torch.cat(feats, dim=1))


class BaseASPPNet(nn.Module):
    def __init__(self, nin: int, ch: int, enlarge: bool = False):
        super().__init__()
        self.enc1 = VREncoder(nin, ch)
        self.enc2 = VREncoder(ch, ch * 2)
        self.enc3 = VREncoder(ch * 2, ch * 4)
        self.enc4 = VREncoder(ch * 4, ch * 8)
        self.aspp = ASPPModule(ch * 8, ch * 16, enlarge=enlarge)
        self.dec4 = VRDecoder(ch * (16 + 8), ch * 8)
        self.dec3 = VRDecoder(ch * (8 + 4), ch * 4)
        self.dec2 = VRDecoder(ch * (4 + 2), ch * 2)
        self.dec1 = VRDecoder(ch * (2 + 1), ch)

    def forward(self, x):
        h, e1 = self.enc1(x)
        h, e2 = self.enc2(h)
        h, e3 = self.enc3(h)
        h, e4 = self.enc4(h)
        h = self.aspp(h)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        return self.dec1(h, e1)


class CascadedASPPNet(nn.Module):
    """Input (B, 2, bins, frames) magnitude; output the masked magnitude
    ``sigmoid mask * input`` of the same shape."""

    def __init__(self, n_fft: int, ch1: int = 32, ch2: int = 16,
                 ch3: int = 32, enlarge: bool = False):
        super().__init__()
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        self.stg1_low_band_net = BaseASPPNet(2, ch1, enlarge)
        self.stg1_high_band_net = BaseASPPNet(2, ch1, enlarge)
        self.stg2_bridge = ConvBNActiv(ch1 + 2, ch2, 1, 1, 0)
        self.stg2_full_band_net = BaseASPPNet(ch2, ch2 * 2, enlarge)
        self.stg3_bridge = ConvBNActiv(2 + ch1 + ch2 * 2, ch3, 1, 1, 0)
        self.stg3_full_band_net = BaseASPPNet(ch3, ch3 * 2, enlarge)
        self.out = nn.Conv2d(ch3 * 2, 2, 1, bias=False)

    def forward(self, mix):
        x = mix[:, :, :self.max_bin]
        bandw = x.shape[2] // 2
        aux1 = torch.cat([self.stg1_low_band_net(x[:, :, :bandw]),
                          self.stg1_high_band_net(x[:, :, bandw:])], dim=2)
        h = self.stg2_bridge(torch.cat([x, aux1], dim=1))
        aux2 = self.stg2_full_band_net(h)
        h = self.stg3_bridge(torch.cat([x, aux1, aux2], dim=1))
        h = self.stg3_full_band_net(h)
        mask = torch.sigmoid(self.out(h))
        return pad_mask(mask, self.output_bin) * mix


def infer_vr_layout(state: Dict) -> dict:
    """The CascadedASPPNet layout from the state dict's shapes (JAX:
    uvr5.py:239): ch1 / ch2 / ch3 are the stages' widths, ``enlarge`` is
    the presence of the 4th / 5th ASPP branch."""
    return dict(
        ch1=int(state["stg1_low_band_net.enc1.conv1.conv.0.weight"].shape[0]),
        ch2=int(state["stg2_bridge.conv.0.weight"].shape[0]),
        ch3=int(state["stg3_bridge.conv.0.weight"].shape[0]),
        enlarge="stg1_low_band_net.aspp.conv6.conv.0.weight" in state,
    )


def read_state(model_path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` / ``.ckpt`` as fp32 tensors (a ``state_dict`` wrapper
    unwrapped), without BatchNorm's ``num_batches_tracked`` counters."""
    raw = torch.load(model_path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and isinstance(raw.get("state_dict"), dict):
        raw = raw["state_dict"]
    return {k: v.detach().to(torch.float32) for k, v in raw.items()
            if hasattr(v, "detach") and not k.endswith(
                ".num_batches_tracked")}


def load_net(net: nn.Module, state: Dict, device) -> nn.Module:
    """``net`` holding ``state`` (strict), in eval mode on ``device``."""
    net.load_state_dict(state, strict=True)
    return net.eval().to(device)


# ---------------------------------------------------------------------------
# multiband spectrogram utilities (host copies of the JAX package's,
# uvr5.py:292-381)
# ---------------------------------------------------------------------------


def load_band_params(name: str = "4band_v2.json") -> dict:
    with open(os.path.join(PARAMS_DIR, name), encoding="utf8") as f:
        mp = json.load(f)
    if "bins" not in mp and "n_bins" in mp:   # 4band_v3_sn spelling
        mp["bins"] = mp["n_bins"]
    # defaults the reference's ModelParameters fills in
    for key, val in (("mid_side", False), ("mid_side_b2", False),
                     ("reverse", False), ("pre_filter_start", 0),
                     ("pre_filter_stop", 0)):
        mp.setdefault(key, val)
    return mp


def _fft_lp_filter(spec: np.ndarray, start: int, stop: int) -> np.ndarray:
    """Linear fade-out over [start, stop), zero above (spec_utils.py:434)."""
    spec = spec.copy()
    n = stop - start
    if n > 0:
        gains = 1.0 - (np.arange(1, n + 1) / n)
        spec[:, start:stop] *= gains[None, :, None]
    spec[:, stop:] = 0
    return spec


def _fft_hp_filter(spec: np.ndarray, start: int, stop: int) -> np.ndarray:
    """Linear fade-out downward over (stop, start], zero at/below stop
    (spec_utils.py:445; called with stop = hpf_stop - 1)."""
    spec = spec.copy()
    n = start - stop
    if n > 0:
        gains = 1.0 - (np.arange(1, n + 1) / n)
        spec[:, start:stop:-1] *= gains[None, :, None]
    spec[:, :stop + 1] = 0
    return spec


def _encode_channels(wav: np.ndarray, mp: dict) -> np.ndarray:
    """Stereo pre-transform before analysis (spec_utils.py:31-46)."""
    if mp.get("reverse"):
        return np.stack([np.flip(wav[0]), np.flip(wav[1])])
    if mp.get("mid_side"):
        return np.stack([(wav[0] + wav[1]) / 2, wav[0] - wav[1]])
    if mp.get("mid_side_b2"):
        return np.stack([wav[1] + wav[0] * 0.5, wav[0] - wav[1] * 0.5])
    return wav


def _decode_channels(wav: np.ndarray, mp: dict) -> np.ndarray:
    """Inverse stereo transform after synthesis (spec_utils.py:297-320)."""
    if mp.get("reverse"):
        return np.stack([np.flip(wav[0]), np.flip(wav[1])])
    if mp.get("mid_side"):
        return np.stack([wav[0] + wav[1] / 2, wav[0] - wav[1] / 2])
    if mp.get("mid_side_b2"):
        return np.stack([wav[1] / 1.25 + 0.4 * wav[0],
                         wav[0] / 1.25 - 0.4 * wav[1]])
    return wav


def _stft(wav: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Complex STFT, centered (librosa-style), (2, bins, frames) for stereo."""
    if wav.ndim == 1:
        wav = np.stack([wav, wav])
    pad = n_fft // 2
    out = []
    for ch in wav:
        y = np.pad(ch, (pad, pad), mode="reflect")
        frames = 1 + (len(y) - n_fft) // hop
        idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
        win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
        out.append(np.fft.rfft(y[idx] * win, axis=-1).T)
    return np.stack(out)


def _istft(spec: np.ndarray, hop: int) -> np.ndarray:
    """(2, bins, frames) complex -> (2, samples), hann overlap-add."""
    n_fft = (spec.shape[1] - 1) * 2
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    out = []
    for ch in spec:
        frames = np.fft.irfft(ch.T, n=n_fft, axis=-1)
        total = n_fft + hop * (frames.shape[0] - 1)
        y = np.zeros(total, np.float32)
        norm = np.zeros(total, np.float32)
        for i in range(frames.shape[0]):
            y[i * hop:i * hop + n_fft] += frames[i] * win
            norm[i * hop:i * hop + n_fft] += win ** 2
        y /= np.maximum(norm, 1e-8)
        out.append(y[n_fft // 2:-(n_fft // 2)])
    return np.stack(out)


class VRSeparator:
    """Windowed inference over the combined multiband spectrogram, the net
    on ``device`` (the card unless the caller asks for the CPU).

    ``agg`` (aggressiveness, reference default 10) raises the vocal mask to
    a power >1 below / above a split bin; ``tta`` runs a second,
    half-step-shifted pass and averages.  A checkpoint that does not load
    raises."""

    WINDOW = 512
    OFFSET = 128

    def __init__(self, model_path: str, band_config: str = "4band_v2.json",
                 device="cuda", agg: int = 10, tta: bool = False):
        self.device = resolve_device(device, type(self).__name__)
        state = read_state(model_path)
        self.mp = load_band_params(band_config)
        self.net = load_net(CascadedASPPNet(self.mp["bins"] * 2,
                                            **infer_vr_layout(state)),
                            state, self.device)
        self.agg = agg
        self.tta = tta

    # ---- multiband analysis ------------------------------------------------

    def _band_specs(self, wav44: np.ndarray) -> List[np.ndarray]:
        """Per-band STFTs, resampling progressively DOWN the band chain
        (top band at the native rate, each lower band resampled from the
        one above it)."""
        bands = self.mp["band"]
        order = sorted(bands, key=int)
        waves: Dict[str, np.ndarray] = {}
        prev = None
        for b in reversed(order):
            bp = bands[b]
            if prev is None:
                waves[b] = wav44
            else:
                prev_bp = bands[prev]
                waves[b] = (waves[prev] if bp["sr"] == prev_bp["sr"]
                            else audio_io.resample(
                                waves[prev], prev_bp["sr"], bp["sr"]))
            prev = b
        return [_stft(waves[b], bands[b]["n_fft"], bands[b]["hl"])
                for b in order]

    def _combine(self, specs: List[np.ndarray]) -> np.ndarray:
        """Stack cropped band bins -> (2, bins, frames) complex, with the
        reference's pre-filter roll-off above pre_filter_start."""
        bands = self.mp["band"]
        frames = min(s.shape[2] for s in specs)
        rows = []
        for s, b in zip(specs, sorted(bands, key=int)):
            bp = bands[b]
            rows.append(s[:, bp["crop_start"]:bp["crop_stop"], :frames])
        comb = np.concatenate(rows, axis=1)
        pad = self.mp["bins"] + 1 - comb.shape[1]
        if pad > 0:
            comb = np.pad(comb, ((0, 0), (0, pad), (0, 0)))
        comb = comb[:, :self.mp["bins"] + 1]
        pfs, pfe = self.mp["pre_filter_start"], self.mp["pre_filter_stop"]
        if pfs > 0:
            if len(bands) == 1:
                comb = _fft_lp_filter(comb, pfs, pfe)
            else:
                gp = 1.0
                for b in range(pfs + 1, pfe):
                    g = 10 ** (-(b - pfs) * (3.5 - gp) / 20.0)
                    gp = g
                    comb[:, b] *= g
        return comb

    def _split_mask(self, masked: np.ndarray,
                    specs: List[np.ndarray]) -> List[np.ndarray]:
        """Un-stack a combined complex spec back into per-band specs."""
        bands = self.mp["band"]
        out = []
        offset = 0
        for s, b in zip(specs, sorted(bands, key=int)):
            bp = bands[b]
            width = bp["crop_stop"] - bp["crop_start"]
            band = np.zeros_like(s[:, :, :masked.shape[2]])
            band[:, bp["crop_start"]:bp["crop_stop"]] = \
                masked[:, offset:offset + width]
            offset += width
            out.append(band)
        return out

    # ---- inference -------------------------------------------------------------

    @torch.no_grad()
    def _net_out(self, batch: torch.Tensor) -> torch.Tensor:
        """The masked magnitude of a window batch (N, 2, bins, W)."""
        return self.net(batch)

    def _predict_mag(self, mag_norm: np.ndarray) -> np.ndarray:
        """(2, bins+1, frames) normalized magnitude -> masked magnitude; the
        windows run as one batch on the device."""
        n_frames = mag_norm.shape[2]
        window, offset = self.WINDOW, self.OFFSET
        step = window - 2 * offset
        pad_total = step - (n_frames % step) if n_frames % step else 0
        x = np.pad(mag_norm, ((0, 0), (0, 0), (offset, offset + pad_total)),
                   mode="constant")
        starts = range(0, x.shape[2] - window + 1, step)
        batch = np.stack([x[:, :, s:s + window] for s in starts])
        masked = self._net_out(torch.from_numpy(batch.astype(
            np.float32)).to(self.device)).cpu().numpy()
        masked = masked[:, :, :, offset:window - offset]          # trim edges
        return np.concatenate(list(masked), axis=2)[:, :, :n_frames]

    def _apply_aggressiveness(self, masked: np.ndarray,
                              mag: np.ndarray) -> np.ndarray:
        """mask^(1+agg-dependent power), split at 2/3 of the reduction
        bins."""
        if not self.agg:
            return masked
        value = self.agg / 100.0
        split = int(self.mp.get("reduction_bins", 0) * 2 / 3)
        if split <= 0:
            return masked
        mask = masked / np.maximum(mag, 1e-10)
        mask[:, :split] = np.power(np.clip(mask[:, :split], 0, 1),
                                   1 + value / 3)
        mask[:, split:] = np.power(np.clip(mask[:, split:], 0, 1), 1 + value)
        return mask * mag

    def separate(self, wav: np.ndarray, sr: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """mono / stereo float wav -> (vocals, accompaniment), stereo
        (2, T) at the band config's rate."""
        if sr != self.mp["sr"]:
            wav = audio_io.resample(wav, sr, self.mp["sr"])
        if wav.ndim == 1:
            wav = np.stack([wav, wav])
        wav = _encode_channels(wav, self.mp)
        specs = self._band_specs(wav)
        comb = self._combine(specs)
        mag = np.abs(comb).astype(np.float32)
        coef = max(mag.max(), 1e-6)
        masked_mag = self._predict_mag(mag / coef)
        if self.tta:
            # second pass shifted by half a step, averaged (reference TTA)
            shift = (self.WINDOW - 2 * self.OFFSET) // 2
            shifted = np.pad(mag, ((0, 0), (0, 0), (shift, 0)))[
                :, :, :mag.shape[2]]
            masked2 = self._predict_mag(shifted / coef)
            masked2 = np.concatenate(
                [masked2[:, :, shift:],
                 masked_mag[:, :, masked_mag.shape[2] - shift:]], axis=2)
            masked_mag = 0.5 * (masked_mag + masked2)
        masked_mag = self._apply_aggressiveness(masked_mag * coef, mag)
        phase = np.exp(1.0j * np.angle(comb))
        vocal_spec = masked_mag * phase
        inst_spec = comb - vocal_spec
        vocal = self._multiband_to_wave(self._split_mask(vocal_spec, specs))
        inst = self._multiband_to_wave(self._split_mask(inst_spec, specs))
        n = min(vocal.shape[-1], inst.shape[-1])
        return vocal[:, :n], inst[:, :n]

    def _multiband_to_wave(self, band_specs: List[np.ndarray]) -> np.ndarray:
        """Progressive synthesis up the band chain with the band-edge fades:
        lowest band low-pass-faded, mid bands band-pass-faded, the running
        sum resampled up to each next band's rate, the top band
        high-pass-faded.  Returns stereo (2, T)."""
        bands = self.mp["band"]
        order = sorted(bands, key=int)
        bands_n = len(order)
        wave: Optional[np.ndarray] = None
        for d, (spec, b) in enumerate(zip(band_specs, order), start=1):
            bp = bands[b]
            if d == bands_n:
                if bp.get("hpf_start", 0) > 0:
                    spec = _fft_hp_filter(spec, bp["hpf_start"],
                                          bp["hpf_stop"] - 1)
                band_wave = _istft(spec, bp["hl"])
                if bands_n == 1:
                    wave = band_wave
                else:
                    n = min(wave.shape[-1], band_wave.shape[-1])
                    wave = wave[:, :n] + band_wave[:, :n]
            elif d == 1:
                spec = _fft_lp_filter(spec, bp["lpf_start"], bp["lpf_stop"])
                next_sr = bands[order[d]]["sr"]
                wave = _istft(spec, bp["hl"])
                if next_sr != bp["sr"]:
                    wave = audio_io.resample(wave, bp["sr"], next_sr)
            else:
                spec = _fft_hp_filter(spec, bp["hpf_start"],
                                      bp["hpf_stop"] - 1)
                spec = _fft_lp_filter(spec, bp["lpf_start"], bp["lpf_stop"])
                band_wave = _istft(spec, bp["hl"])
                n = min(wave.shape[-1], band_wave.shape[-1])
                wave = wave[:, :n] + band_wave[:, :n]
                next_sr = bands[order[d]]["sr"]
                if next_sr != bp["sr"]:
                    wave = audio_io.resample(wave, bp["sr"], next_sr)
        if wave is None:
            return np.zeros((2, 1), np.float32)
        return _decode_channels(np.atleast_2d(wave), self.mp)


class DeEchoSeparator(VRSeparator):
    """DeEcho / DeReverb: the nets_new CascadedNet over 4band_v3, which emits
    the mask (the masked magnitude is mask * input), a 64-frame offset and
    no mask power (JAX: uvr5.py:596-618).  ``nout`` is 64 for DeReverb
    models and 48 for DeEcho."""

    OFFSET = 64

    def __init__(self, model_path: str, device="cuda"):
        from .uvr5_deecho import CascadedNet

        self.device = resolve_device(device, "DeEchoSeparator")
        state = read_state(model_path)
        self.mp = load_band_params("4band_v3.json")
        nout = 64 if "DeReverb" in model_path else 48
        self.net = load_net(CascadedNet(self.mp["bins"] * 2, nout=nout),
                            state, self.device)
        self.agg = 0
        self.tta = False

    @torch.no_grad()
    def _net_out(self, batch: torch.Tensor) -> torch.Tensor:
        return self.net(batch) * batch


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


def weights_root() -> str:
    return os.path.join(paths.get_base_path(), "models", "uvr5_weights")


def get_separator(model_name: str, device="cuda"):
    """A separation engine by model name (JAX: uvr5.py:621), its net on
    ``device``.  Weights that are absent raise FileNotFoundError; a
    checkpoint that is present and does not load raises its own error."""
    lowered = model_name.lower()
    root = weights_root()
    if "roformer" in lowered:
        from .bs_roformer import BSRoformerSeparator, MelBandRoformerSeparator

        cls = (MelBandRoformerSeparator if "mel" in lowered
               else BSRoformerSeparator)
        for cand in (model_name + ".ckpt", model_name + ".pth", model_name):
            path = os.path.join(root, cand)
            if os.path.exists(path):
                return cls(path, device)
        raise FileNotFoundError(f"Roformer weights not found under {root}")
    if "mdx" in lowered or "onnx" in lowered:
        from .mdxnet import MDXSeparator

        for cand in (model_name + ".onnx", model_name + ".pth", model_name,
                     "vocals.onnx"):
            path = os.path.join(root, "onnx_dereverb_By_FoxJoy"
                                if "reverb" in lowered else "", cand)
            if os.path.exists(path):
                return MDXSeparator(path, device)
        raise FileNotFoundError(f"MDX-Net weights not found under {root}")
    path = os.path.join(root, model_name + ".pth")
    if not os.path.exists(path):
        raise FileNotFoundError(f"UVR5 weights not found: {path}")
    if "DeEcho" in model_name:
        return DeEchoSeparator(path, device)
    return VRSeparator(path, device=device)
