"""FRCRN speech denoiser (JAX: audiokit/frcrn.py), in plain torch.

The FRCRN of Zhao et al. (ICASSP 2022) as modelscope's
``speech_frcrn_ans_cirm_16k`` ships it: a sqrt-Hann STFT (win 640 / hop 320
/ fft 640 at 16 kHz), two cascaded complex U-Nets (complex conv encoder
blocks with stride-2 frequency downsampling, a complex FSMN along the
frequency axis after every block, a two-layer complex FSMN over time at the
bottleneck), and the complex ratio mask ``tanh(unet1) + tanh(unet2(unet1))``
applied by complex multiplication before the inverse STFT.

Complex feature maps are one tensor of shape (2B, C, F, T): the real parts
of the B items, then their imaginary parts.  A complex layer (f_re, f_im)
runs each real layer once over both halves.  Convolutions, dense layers and
the FFTs are cuDNN, cuBLAS and cuFFT calls: the JAX package computes them
with XLA, outside any Pallas kernel.

Module names follow the replica key scheme of the JAX converter
(``unet.enc0_conv.conv_re.weight``, ...), so a replica state dict loads with
``load_state_dict(strict=True)``, and a released modelscope checkpoint does
after :func:`adapt_modelscope_state`.  BatchNorm's ``num_batches_tracked``
counters are not read (inference uses the running statistics only).
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import audio_io
from ..utils.device import resolve_device
from ..utils.logger import logger


# ---------------------------------------------------------------------------
# STFT / inverse STFT (sqrt-Hann dual window, modelscope ConvSTFT framing)
# ---------------------------------------------------------------------------


def _sqrt_hann(win_len: int) -> np.ndarray:
    # periodic Hann ** 0.5 (fftbins=True in scipy.get_window terms)
    n = np.arange(win_len)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / win_len)
    return np.sqrt(hann).astype(np.float32)


def _window(win_len: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_sqrt_hann(win_len)).to(like.device)


def stft(wav: torch.Tensor, win_len: int = 640, hop: int = 320,
         fft_len: int = 640) -> torch.Tensor:
    """(B, S) -> complex (B, F, T), F = fft_len // 2 + 1; the input is
    padded by ``win_len - hop`` on both sides."""
    pad = win_len - hop
    frames = F.pad(wav, (pad, pad)).unfold(1, win_len, hop)  # (B, T, win)
    spec = torch.fft.rfft(frames * _window(win_len, wav), n=fft_len, dim=-1)
    return spec.transpose(1, 2)


def istft(spec: torch.Tensor, out_len: int, win_len: int = 640,
          hop: int = 320, fft_len: int = 640) -> torch.Tensor:
    """complex (B, F, T) -> (B, out_len): overlap-add of the windowed
    frames, divided by the summed squared window."""
    window = _window(win_len, spec)
    frames = torch.fft.irfft(spec.transpose(1, 2), n=fft_len, dim=-1)
    frames = frames[..., :win_len] * window            # (B, T, win)
    b, t = frames.shape[:2]
    total = (t - 1) * hop + win_len

    def overlap_add(x):                                # (N, win, T)
        return F.fold(x, (1, total), (1, win_len), stride=(1, hop))[:, 0, 0]

    out = overlap_add(frames.transpose(1, 2))
    wsum = overlap_add((window ** 2)[None, :, None].expand(1, win_len, t))
    out = out / wsum.clamp_min(1e-8)
    pad = win_len - hop
    return out[:, pad:pad + out_len]


# ---------------------------------------------------------------------------
# complex building blocks over (2B, C, F, T): real parts, then imaginary
# ---------------------------------------------------------------------------


def _complex(f_re, f_im, x: torch.Tensor, *args) -> torch.Tensor:
    """(f_re + i f_im)(x_re + i x_im) for real layers f_re, f_im."""
    a_re, a_im = f_re(x, *args).chunk(2)
    b_re, b_im = f_im(x, *args).chunk(2)
    return torch.cat([a_re - b_im, a_im + b_re])


def _cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_re, a_im = a.chunk(2)
    b_re, b_im = b.chunk(2)
    return torch.cat([a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re])


class ComplexConv(nn.Module):
    """Complex conv2d: frequency kernel kf, stride sf, ``kf // 2`` padding on
    both sides; time kernel kt, stride 1, causal (``kt - 1`` on the left)."""

    def __init__(self, cin: int, cout: int, kf: int = 5, kt: int = 2,
                 sf: int = 2):
        super().__init__()
        self.kf, self.kt = kf, kt
        self.conv_re = nn.Conv2d(cin, cout, (kf, kt), (sf, 1))
        self.conv_im = nn.Conv2d(cin, cout, (kf, kt), (sf, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (self.kt - 1, 0, self.kf // 2, self.kf // 2))
        return _complex(self.conv_re, self.conv_im, x)


class ComplexConvTranspose(nn.Module):
    """Complex transposed conv, frequency upsampled by sf: VALID, so
    F_out = (F_in - 1) * sf + kf, then cropped about its centre to the skip
    connection's ``out_f`` bins, and the ``kt - 1`` frames the kernel adds
    at the end of time cut."""

    def __init__(self, cin: int, cout: int, kf: int = 5, kt: int = 2,
                 sf: int = 2):
        super().__init__()
        self.conv_re = nn.ConvTranspose2d(cin, cout, (kf, kt), (sf, 1))
        self.conv_im = nn.ConvTranspose2d(cin, cout, (kf, kt), (sf, 1))

    def forward(self, x: torch.Tensor, out_f: int) -> torch.Tensor:
        y = _complex(self.conv_re, self.conv_im, x)
        f0 = (y.shape[2] - out_f) // 2
        return y[:, :, f0:f0 + out_f, :x.shape[3]]


class _BatchNorm(nn.Module):
    """BatchNorm2d with inference statistics only (eps 1e-5, flax's and
    torch's default)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, 1e-5)


class ComplexBatchNorm(nn.Module):
    """Per-part (naive complex) batch norm."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn_re = _BatchNorm(channels)
        self.bn_im = _BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        re, im = x.chunk(2)
        return torch.cat([self.bn_re(re), self.bn_im(im)])


class UniDeepFsmn(nn.Module):
    """FSMN memory block (modelscope UniDeepFsmn): (N, L, D) -> (N, L, D),
    linear -> relu -> projection (no bias), a depthwise conv of
    ``2 * lorder - 1`` symmetric taps along L over the projection, and
    both added to the input.  ``conv1`` keeps modelscope's weight layout
    (D, 1, taps, 1)."""

    def __init__(self, dim: int, hidden: int, lorder: int = 20):
        super().__init__()
        self.lorder = lorder
        self.linear = nn.Linear(dim, hidden)
        self.project = nn.Linear(hidden, dim, bias=False)
        self.conv1 = nn.Conv2d(dim, dim, (2 * lorder - 1, 1), groups=dim,
                               bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p1 = self.project(F.relu(self.linear(x)))
        mem = F.conv1d(p1.transpose(1, 2), self.conv1.weight[..., 0],
                       padding=self.lorder - 1, groups=p1.shape[-1])
        return x + p1 + mem.transpose(1, 2)


class ComplexFsmn(nn.Module):
    """One complex FSMN layer over (2N, L, D)."""

    def __init__(self, dim: int, hidden: int, lorder: int = 20):
        super().__init__()
        self.re = UniDeepFsmn(dim, hidden, lorder)
        self.im = UniDeepFsmn(dim, hidden, lorder)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _complex(self.re, self.im, x)


class FreqFsmn(nn.Module):
    """Frequency recurrence: a complex FSMN along F, one sequence per
    (item, frame), the channels as features."""

    def __init__(self, dim: int, hidden: int, lorder: int = 20):
        super().__init__()
        self.fsmn = ComplexFsmn(dim, hidden, lorder)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b2, c, f, t = x.shape
        y = x.permute(0, 3, 2, 1).reshape(b2 * t, f, c)
        y = self.fsmn(y)
        return y.reshape(b2, t, f, c).permute(0, 3, 2, 1)


@dataclasses.dataclass(frozen=True)
class FRCRNConfig:
    """Paper/released-model configuration."""

    win_len: int = 640
    hop: int = 320
    fft_len: int = 640
    channels: int = 128        # complex channels per conv block
    depth: int = 6             # encoder (= decoder) blocks per U-Net
    fsmn_hidden: int = 128
    lorder: int = 20
    kf: int = 5
    kt: int = 2

    @property
    def n_bins(self) -> int:
        return self.fft_len // 2 + 1


class CREDUNet(nn.Module):
    """One complex U-Net with frequency recurrence (paper Fig. 1)."""

    def __init__(self, cfg: FRCRNConfig):
        super().__init__()
        self.cfg = c = cfg
        cin = 1
        for i in range(c.depth):
            setattr(self, f"enc{i}_conv",
                    ComplexConv(cin, c.channels, c.kf, c.kt))
            setattr(self, f"enc{i}_bn", ComplexBatchNorm(c.channels))
            setattr(self, f"enc{i}_fr",
                    FreqFsmn(c.channels, c.fsmn_hidden, c.lorder))
            cin = c.channels
        self.bottleneck0 = ComplexFsmn(c.channels, c.fsmn_hidden, c.lorder)
        self.bottleneck1 = ComplexFsmn(c.channels, c.fsmn_hidden, c.lorder)
        for i in range(c.depth):
            setattr(self, f"dec{i}_conv",
                    ComplexConvTranspose(2 * c.channels, c.channels, c.kf,
                                         c.kt))
            setattr(self, f"dec{i}_bn", ComplexBatchNorm(c.channels))
            setattr(self, f"dec{i}_fr",
                    FreqFsmn(c.channels, c.fsmn_hidden, c.lorder))
        self.mask_conv = ComplexConv(c.channels, 1, 1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        skips: List[torch.Tensor] = []
        for i in range(c.depth):
            x = getattr(self, f"enc{i}_conv")(x)
            x = F.leaky_relu(getattr(self, f"enc{i}_bn")(x), 0.1)
            x = getattr(self, f"enc{i}_fr")(x)
            skips.append(x)

        # bottleneck: two complex FSMN layers over time, one sequence per
        # (item, frequency bin)
        b2, ch, f, t = x.shape
        y = x.permute(0, 2, 3, 1).reshape(b2 * f, t, ch)
        y = self.bottleneck1(self.bottleneck0(y))
        x = y.reshape(b2, f, t, ch).permute(0, 3, 1, 2)

        for i in range(c.depth):
            x = torch.cat([x, skips[c.depth - 1 - i]], dim=1)
            out_f = (skips[c.depth - 2 - i].shape[2] if i < c.depth - 1
                     else c.n_bins)
            x = getattr(self, f"dec{i}_conv")(x, out_f)
            x = F.leaky_relu(getattr(self, f"dec{i}_bn")(x), 0.1)
            x = getattr(self, f"dec{i}_fr")(x)
        return self.mask_conv(x)                       # (2B, 1, F, T)


class FRCRN(nn.Module):
    """Two cascaded U-Nets with complex ratio masking (modelscope
    frcrn.forward)."""

    def __init__(self, cfg: FRCRNConfig = FRCRNConfig()):
        super().__init__()
        self.cfg = cfg
        self.unet = CREDUNet(cfg)
        self.unet2 = CREDUNet(cfg)

    def forward(self, spec: torch.Tensor):
        """spec: (2B, 1, F, T) -> (estimate, mask), both (2B, 1, F, T)."""
        u1 = self.unet(spec)
        u2 = self.unet2(u1)
        mask = torch.tanh(u2) + torch.tanh(u1)
        return _cmul(spec, mask), mask


# ---------------------------------------------------------------------------
# checkpoints (host copies of the JAX module's loaders)
# ---------------------------------------------------------------------------

_MODELSCOPE_PREFIXES = ("model.", "module.", "")


def load_torch_state(path: str) -> Dict:
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict):
        for key in ("state_dict", "model", "weight"):
            if key in blob and isinstance(blob[key], dict):
                blob = blob[key]
                break
    state = {}
    for k, v in blob.items():
        for pref in _MODELSCOPE_PREFIXES:
            if pref and k.startswith(pref):
                k = k[len(pref):]
                break
        state[k] = v
    return state


def adapt_modelscope_state(state: Dict):
    """Rename a modelscope ``speech_frcrn_ans_cirm_16k`` state dict onto the
    replica key scheme (the JAX module's table of key families:
    ``{net}.encoder{i}.{conv,bn}.*`` -> ``{net}.enc{i}_{conv,bn}.*``,
    per-stage ``fsmn_{re,im}_L1`` -> ``{net}.{enc,dec}{i}_fr.fsmn.{re,im}``,
    net-level ``fsmn_{re,im}_L{1,2}`` -> ``{net}.bottleneck{0,1}.{re,im}``,
    ``{net}.linear.conv_{re,im}`` -> ``{net}.mask_conv``; the fixed STFT
    kernels dropped).  FSMN keys are matched by structure (stage index,
    side, leg name), as their wrapper names vary across modelscope
    revisions.  Returns ``(adapted, leftovers)``; the caller decides whether
    leftover keys are fatal."""
    adapted: Dict = {}
    leftovers = []
    for k, v in state.items():
        if k.startswith(("stft.", "istft.")) or k.endswith(".window"):
            continue
        m = re.match(r"(unet2|unet)\.(.*)$", k)
        if not m:
            leftovers.append(k)
            continue
        net, rest = m.group(1), m.group(2)

        fs = re.search(
            r"fsmn_(re|im)_L([12])\.(linear|project|conv1)\.(weight|bias)$",
            rest)
        if fs:
            part, layer, sub, wb = fs.groups()
            stage = re.search(r"(encoder|decoder|enc|dec|en|de)[._]?(\d+)",
                              rest)
            if stage:
                kind = "enc" if stage.group(1).startswith("en") else "dec"
                if layer != "1":
                    leftovers.append(k)  # per-stage FR has a single layer
                    continue
                adapted[f"{net}.{kind}{stage.group(2)}_fr.fsmn."
                        f"{part}.{sub}.{wb}"] = v
            else:
                adapted[f"{net}.bottleneck{int(layer) - 1}."
                        f"{part}.{sub}.{wb}"] = v
            continue

        m2 = re.match(
            r"(encoder|decoder)(\d+)\.(conv|bn)\."
            r"((?:conv|bn)_(?:re|im))\.(.+)$", rest)
        if m2:
            kind = "enc" if m2.group(1) == "encoder" else "dec"
            adapted[f"{net}.{kind}{m2.group(2)}_{m2.group(3)}."
                    f"{m2.group(4)}.{m2.group(5)}"] = v
            continue

        m3 = re.match(r"linear\.conv_(re|im)\.(weight|bias)$", rest)
        if m3:
            adapted[f"{net}.mask_conv.conv_{m3.group(1)}.{m3.group(2)}"] = v
            continue
        leftovers.append(k)
    return adapted, leftovers


def infer_frcrn_config(state: Dict, win_len: int = 640, hop: int = 320,
                       fft_len: int = 640) -> FRCRNConfig:
    """Derive the net hyperparameters from a checkpoint's shapes.

    STFT framing is kernel-free here, so win/hop/fft stay caller-supplied
    (override via ``EASEVOICE_FRCRN_STFT=win,hop,fft``).
    """
    env = os.environ.get("EASEVOICE_FRCRN_STFT")
    if env:
        win_len, hop, fft_len = (int(v) for v in env.split(","))
    depth = len({k.split("_")[0] for k in state
                 if k.startswith("unet.enc") and k.endswith("conv_re.weight")
                 and ".fr." not in k})
    w = np.asarray(state["unet.enc0_conv.conv_re.weight"].shape)
    channels, _, kf, kt = (int(v) for v in w)
    lin = state["unet.enc0_fr.fsmn.re.linear.weight"].shape
    hidden = int(lin[0])
    taps = int(state["unet.enc0_fr.fsmn.re.conv1.weight"].shape[2])
    return FRCRNConfig(win_len=win_len, hop=hop, fft_len=fft_len,
                       channels=channels, depth=depth, fsmn_hidden=hidden,
                       lorder=(taps + 1) // 2, kf=kf, kt=kt)


def replica_state(state: Dict, model_path: str = "") -> Dict:
    """A loaded checkpoint in the replica key scheme: as it is, or adapted
    from modelscope's; raises for any other scheme."""
    if "unet.enc0_conv.conv_re.weight" in state:
        return state
    adapted, leftovers = adapt_modelscope_state(state)
    if "unet.enc0_conv.conv_re.weight" not in adapted:
        raise RuntimeError(
            "FRCRN checkpoint %r uses an unrecognized key scheme; expected "
            "replica keys (unet.enc0_conv.conv_re.weight ...) or modelscope "
            "speech_frcrn_ans_cirm_16k keys (unet.encoder0.conv.conv_re."
            "weight ...). Found e.g. %s" % (model_path, sorted(state)[:8]))
    if leftovers:
        logger.info("frcrn: %d unmapped modelscope keys (e.g. %s)",
                    len(leftovers), leftovers[:3])
    return adapted


def load_frcrn(state: Dict, cfg: Optional[FRCRNConfig] = None) -> FRCRN:
    """An FRCRN (on the CPU, eval mode) holding a replica-scheme state dict,
    loaded ``strict=True`` apart from BatchNorm's ``num_batches_tracked``."""
    model = FRCRN(cfg or infer_frcrn_config(state))
    model.load_state_dict(
        {k: torch.as_tensor(v, dtype=torch.float32) for k, v in state.items()
         if not k.endswith(".num_batches_tracked")}, strict=True)
    return model.eval()


# ---------------------------------------------------------------------------
# runtime denoiser
# ---------------------------------------------------------------------------


class FRCRNDenoiser:
    """File-to-file denoiser over the FRCRN net on ``device`` (16 kHz, like
    the reference's modelscope pipeline).  Accepts checkpoints in the
    replica naming or the released modelscope naming; a checkpoint that
    does not load raises."""

    SR = 16000

    def __init__(self, model_path: str, device="cuda",
                 cfg: Optional[FRCRNConfig] = None):
        self.device = resolve_device(device, "FRCRNDenoiser")
        state = replica_state(load_torch_state(model_path), model_path)
        self.cfg = cfg or infer_frcrn_config(state)
        self.model = load_frcrn(state, self.cfg).to(self.device)

    @torch.no_grad()
    def run(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, S) waveform on the device -> (B, S) denoised."""
        c = self.cfg
        spec = stft(wav, c.win_len, c.hop, c.fft_len)
        spec = torch.cat([spec.real, spec.imag])[:, None]
        est, _ = self.model(spec)
        re, im = est[:, 0].chunk(2)
        return istft(torch.complex(re, im), wav.shape[1], c.win_len, c.hop,
                     c.fft_len)

    def process(self, wav: np.ndarray, sr: int) -> np.ndarray:
        if sr != self.SR:
            wav = audio_io.resample(wav.astype(np.float32), sr, self.SR)
        # the JAX module's 2-second padding bucket: the bottleneck FSMN sees
        # 39 frames about each frame, so the last frames of the output
        # depend on the padding that follows them
        bucket = 2 * self.SR
        n = max(1, int(np.ceil(len(wav) / bucket))) * bucket
        padded = np.zeros((1, n), np.float32)
        padded[0, :len(wav)] = wav
        out = self.run(torch.from_numpy(padded).to(self.device))
        return out[0, :len(wav)].cpu().numpy().astype(np.float32)

    def denoise(self, input_path: str, output_path: str) -> None:
        wav, sr = audio_io.read_wav(input_path)
        out = self.process(wav, sr)
        # the reference's modelscope pipeline writes 16 kHz output
        audio_io.write_wav(output_path, out, self.SR)


def default_model_path() -> Optional[str]:
    env = os.environ.get("EASEVOICE_FRCRN_PATH")
    if env:
        return env if os.path.exists(env) else None
    from ..utils import paths

    root = os.path.join(paths.get_base_path(), paths.MODEL_ROOT, "denoise",
                        "speech_frcrn_ans_cirm_16k")
    for name in ("pytorch_model.bin", "model.pt", "frcrn.pth"):
        cand = os.path.join(root, name)
        if os.path.exists(cand):
            return cand
    return None
