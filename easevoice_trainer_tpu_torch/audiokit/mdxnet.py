"""MDX-Net (Conv-TDF) separator (JAX: audiokit/mdxnet.py), in plain torch.

``ConvTDFNet`` under the reference's torch names (``first_conv.0.weight``,
``encoding_blocks.{i}.tfc.H.{j}.0.weight``, ``ds.{i}``, ``us.{i}``, ...),
taking the reference's (B, dim_c, dim_f, dim_t) layout and working in
(B, C, T, F) inside, so the TDF branch's dense layers mix the frequencies
on the last axis.  Its convolutions, the transposed convolutions of the
upsampling path, GroupNorm(2, C) and the dense layers are cuDNN / cuBLAS
calls: the JAX package computes them with XLA, outside any Pallas kernel.

``MDXSeparator`` keeps the JAX package's host numpy for the STFT packing
(n_fft 6144, hop 1024, 512 frames a window) and the margin-padded chunked
demix; the windows of a segment, and the ``denoise`` pass's negated copy,
run as one batch on the device.

The ONNX initializer reader (``_fields``, ``_parse_tensor``,
``load_onnx_initializers``, mdxnet.py:251-339) is a copy of the JAX
package's, also used to read ``g2pW.onnx``: a dependency-free protobuf
walk, no ``onnx`` package is needed.  ``tests/test_torch_host.py`` holds
the copy to the original.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils import audio_io
from ..utils.device import resolve_device

_ONNX_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
                7: np.int64, 10: np.float16, 11: np.float64}


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                       # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:                     # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:                     # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:                     # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    """TensorProto: dims=1, data_type=2, float_data=4, int64_data=7,
    name=8, raw_data=9."""
    dims: List[int] = []
    dtype = 1
    name = ""
    raw: Optional[memoryview] = None
    floats: List[float] = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 1 and wire == 2:      # packed dims
            p = 0
            while p < len(val):
                d, p = _read_varint(val, p)
                dims.append(d)
        elif field == 2:
            dtype = val
        elif field == 4:
            if wire == 2:                   # packed floats
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 8:
            name = bytes(val).decode("utf8")
        elif field == 9:
            raw = val
    np_dtype = _ONNX_DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(bytes(raw), dtype=np_dtype)
    else:
        arr = np.asarray(floats, np.float32)
    return name, arr.reshape(dims).astype(np.float32, copy=False)


def load_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """Read {initializer name: array} out of an .onnx file.

    ModelProto.graph = field 7; GraphProto.initializer = field 5.
    """
    with open(path, "rb") as f:
        model = memoryview(f.read())
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _fields(model):
        if field == 7 and wire == 2:        # graph
            for gfield, gwire, gval in _fields(val):
                if gfield == 5 and gwire == 2:   # initializer
                    name, arr = _parse_tensor(gval)
                    out[name] = arr
    return out


# ---------------------------------------------------------------------------
# network
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MDXConfig:
    """UVR's Conv-TDF deployment config (JAX: mdxnet.py:88)."""

    num_blocks: int = 11          # L
    g: int = 48                   # channel growth
    k: int = 3
    l: int = 3                    # convs per TFC
    bn: int = 8                   # TDF bottleneck factor
    bias: bool = False
    norm: str = "group"
    dim_c: int = 4                # 2 channels x re/im
    dim_f: int = 3072
    dim_t: int = 512              # 2**9 stft frames per window
    n_fft: int = 6144
    hop: int = 1024

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def chunk_size(self) -> int:
        return self.hop * (self.dim_t - 1)


def _norm(kind: str, c: int) -> nn.Module:
    return nn.GroupNorm(2, c, eps=1e-5) if kind == "group" \
        else nn.BatchNorm2d(c)


class TFC(nn.Module):
    """l x (conv kxk -> norm -> relu), channel-preserving."""

    def __init__(self, c: int, l: int, k: int, norm: str):
        super().__init__()
        self.H = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, c, k, 1, k // 2), _norm(norm, c),
                          nn.ReLU())
            for _ in range(l))

    def forward(self, x):
        for h in self.H:
            x = h(x)
        return x


class TFCTDF(nn.Module):
    """TFC + residual time-distributed fully-connected over the frequency
    axis (the last one)."""

    def __init__(self, c: int, l: int, f: int, k: int, bn: int,
                 bias: bool, norm: str):
        super().__init__()
        self.tfc = TFC(c, l, k, norm)
        self.tdf = nn.Sequential(
            nn.Linear(f, f // bn, bias=bias), _norm(norm, c), nn.ReLU(),
            nn.Linear(f // bn, f, bias=bias), _norm(norm, c), nn.ReLU())

    def forward(self, x):
        x = self.tfc(x)
        return x + self.tdf(x)


class ConvTDFNet(nn.Module):
    def __init__(self, cfg: MDXConfig = MDXConfig()):
        super().__init__()
        c = cfg
        self.cfg = cfg
        n = c.num_blocks // 2
        self.first_conv = nn.Sequential(nn.Conv2d(c.dim_c, c.g, 1),
                                        _norm(c.norm, c.g), nn.ReLU())
        f, ch = c.dim_f, c.g
        self.encoding_blocks = nn.ModuleList()
        self.ds = nn.ModuleList()
        for _ in range(n):
            self.encoding_blocks.append(
                TFCTDF(ch, c.l, f, c.k, c.bn, c.bias, c.norm))
            self.ds.append(nn.Sequential(
                nn.Conv2d(ch, ch + c.g, 2, 2), _norm(c.norm, ch + c.g),
                nn.ReLU()))
            f //= 2
            ch += c.g
        self.bottleneck_block = TFCTDF(ch, c.l, f, c.k, c.bn, c.bias, c.norm)
        self.us = nn.ModuleList()
        self.decoding_blocks = nn.ModuleList()
        for _ in range(n):
            self.us.append(nn.Sequential(
                nn.ConvTranspose2d(ch, ch - c.g, 2, 2),
                _norm(c.norm, ch - c.g), nn.ReLU()))
            f *= 2
            ch -= c.g
            self.decoding_blocks.append(
                TFCTDF(ch, c.l, f, c.k, c.bn, c.bias, c.norm))
        self.final_conv = nn.Sequential(nn.Conv2d(ch, c.dim_c, 1))

    def forward(self, x):
        """x: (B, dim_c, dim_f, dim_t) -> the predicted stem's spec, same
        shape."""
        x = self.first_conv(x).transpose(-1, -2)        # (B, C, T, F)
        skips = []
        for enc, ds in zip(self.encoding_blocks, self.ds):
            x = enc(x)
            skips.append(x)
            x = ds(x)
        x = self.bottleneck_block(x)
        for i, (us, dec) in enumerate(zip(self.us, self.decoding_blocks)):
            x = us(x) * skips[-i - 1]                   # multiplicative skip
            x = dec(x)
        return self.final_conv(x.transpose(-1, -2))


def infer_mdx_config(state: Dict, dim_f: int = 3072, dim_t: int = 512,
                     n_fft: int = 6144) -> MDXConfig:
    """Net hyperparameters from the weights' shapes (JAX: mdxnet.py:188)."""
    g = int(state["first_conv.0.weight"].shape[0])
    n = 0
    while f"ds.{n}.0.weight" in state:
        n += 1
    l = 0
    while f"encoding_blocks.0.tfc.H.{l}.0.weight" in state:
        l += 1
    k = int(state["encoding_blocks.0.tfc.H.0.0.weight"].shape[-1])
    tdf_in, tdf_out = state["encoding_blocks.0.tdf.0.weight"].shape[1], \
        state["encoding_blocks.0.tdf.0.weight"].shape[0]
    bias = "encoding_blocks.0.tdf.0.bias" in state
    norm = "batch" if "first_conv.1.running_mean" in state else "group"
    dim_c = int(state["first_conv.0.weight"].shape[1])
    return MDXConfig(num_blocks=2 * n + 1, g=g, k=k, l=l,
                     bn=int(tdf_in) // int(tdf_out), bias=bias, norm=norm,
                     dim_c=dim_c, dim_f=int(tdf_in), dim_t=dim_t,
                     n_fft=n_fft)


# ---------------------------------------------------------------------------
# separator (chunked demix with margins; JAX: mdxnet.py:347-514)
# ---------------------------------------------------------------------------


class MDXSeparator:
    """The MDX-Net separator, its net on ``device`` (the card unless the
    caller asks for the CPU).  A checkpoint that does not load raises."""

    SR = 44100

    def __init__(self, model_path: str, device="cuda", chunks: int = 15,
                 margin: int = 44100, denoise: bool = True):
        state = self._load_state(model_path)
        self._init(state, infer_mdx_config(state), device, chunks, margin,
                   denoise)

    @staticmethod
    def _load_state(model_path: str) -> Dict[str, torch.Tensor]:
        if model_path.endswith(".onnx"):
            state = load_onnx_initializers(model_path)
            if "first_conv.0.weight" not in state:
                raise ValueError(
                    f"{model_path}: ONNX initializers do not carry torch "
                    "parameter names; cannot map weights")
            return {k: torch.from_numpy(np.array(v, np.float32))
                    for k, v in state.items()}
        from .uvr5 import read_state

        return read_state(model_path)

    def _init(self, state, cfg: MDXConfig, device, chunks, margin, denoise):
        from .uvr5 import load_net

        self.device = resolve_device(device, "MDXSeparator")
        self.cfg = cfg
        self.net = load_net(ConvTDFNet(cfg), state, self.device)
        self.chunks = chunks
        self.margin = margin
        self.denoise = denoise

    @classmethod
    def from_state(cls, state: Dict[str, torch.Tensor], cfg: MDXConfig,
                   device="cuda", chunks: int = 15, margin: int = 44100,
                   denoise: bool = True) -> "MDXSeparator":
        """A separator over a state dict and an explicit config (tests,
        custom configs)."""
        self = cls.__new__(cls)
        self._init(state, cfg, device, chunks, margin, denoise)
        return self

    # -- stft packing (mdxnet.py ConvTDFNetTrim.stft/istft) -----------------

    def _window(self) -> np.ndarray:
        # torch.hann_window(periodic=True)
        n = self.cfg.n_fft
        return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(
            np.float64)

    def _stft(self, waves: np.ndarray) -> np.ndarray:
        """(B, 2, chunk_size) -> (B, dim_c, dim_f, dim_t)."""
        c = self.cfg
        b = waves.shape[0]
        x = waves.reshape(-1, c.chunk_size)
        pad = c.n_fft // 2
        win = self._window()
        specs = []
        for chan in x:
            y = np.pad(chan, (pad, pad), mode="reflect")
            frames = 1 + (len(y) - c.n_fft) // c.hop
            idx = (np.arange(frames)[:, None] * c.hop
                   + np.arange(c.n_fft)[None, :])
            specs.append(np.fft.rfft(y[idx] * win, axis=-1).T)  # (bins, T)
        s = np.stack(specs)                                # (B*2, bins, T)
        s = s[:, :, :c.dim_t]
        out = np.stack([s.real, s.imag], axis=1)           # (B*2, 2, bins, T)
        out = out.reshape(b, c.dim_c, c.n_bins, -1)[:, :, :c.dim_f]
        return out.astype(np.float32)

    def _istft(self, spec: np.ndarray) -> np.ndarray:
        """(B, dim_c, dim_f, dim_t) -> (B, 2, chunk_size)."""
        c = self.cfg
        b = spec.shape[0]
        x = np.concatenate(
            [spec, np.zeros((b, c.dim_c, c.n_bins - c.dim_f,
                             spec.shape[-1]))], 2)
        x = x.reshape(b * 2, 2, c.n_bins, -1)
        comp = x[:, 0] + 1j * x[:, 1]                      # (B*2, bins, T)
        win = self._window()
        hop, n_fft = c.hop, c.n_fft
        outs = []
        for ch in comp:
            frames = np.fft.irfft(ch.T, n=n_fft, axis=-1)
            total = n_fft + hop * (frames.shape[0] - 1)
            y = np.zeros(total)
            norm = np.zeros(total)
            for i in range(frames.shape[0]):
                y[i * hop:i * hop + n_fft] += frames[i] * win
                norm[i * hop:i * hop + n_fft] += win ** 2
            y /= np.maximum(norm, 1e-8)
            outs.append(y[n_fft // 2:n_fft // 2 + c.chunk_size])
        return np.stack(outs).reshape(b, 2, c.chunk_size).astype(np.float32)

    @torch.no_grad()
    def _run_model(self, spec: np.ndarray) -> np.ndarray:
        """The net over a window batch; with ``denoise``, the batch and its
        negation in one call, ``0.5 * net(x) - 0.5 * net(-x)``."""
        x = torch.from_numpy(spec).to(self.device)
        if not self.denoise:
            return self.net(x).cpu().numpy()
        out = self.net(torch.cat([x, -x])).cpu().numpy()
        return 0.5 * out[:len(spec)] - 0.5 * out[len(spec):]

    def _demix_segment(self, cmix: np.ndarray) -> np.ndarray:
        """One margin-padded segment (2, n) -> separated (2, n)."""
        c = self.cfg
        n_sample = cmix.shape[1]
        trim = c.n_fft // 2
        gen_size = c.chunk_size - 2 * trim
        pad = gen_size - n_sample % gen_size
        mix_p = np.concatenate(
            [np.zeros((2, trim)), cmix, np.zeros((2, pad)),
             np.zeros((2, trim))], axis=1)
        waves = []
        i = 0
        while i < n_sample + pad:
            waves.append(mix_p[:, i:i + c.chunk_size])
            i += gen_size
        batch = np.stack(waves).astype(np.float32)          # (W, 2, chunk)
        spec = self._stft(batch)
        pred = self._run_model(spec)
        tar = self._istft(pred)                             # (W, 2, chunk)
        sig = tar[:, :, trim:-trim].transpose(1, 0, 2).reshape(2, -1)
        return sig[:, :-pad]

    def demix(self, mix: np.ndarray) -> np.ndarray:
        """(2, samples) -> target stem (2, samples)."""
        samples = mix.shape[-1]
        chunk = self.chunks * self.SR
        margin = self.margin
        if margin > chunk:
            margin = chunk
        if self.chunks == 0 or samples < chunk:
            chunk = samples
        outs = []
        skip = 0
        counter = 0
        while skip < samples:
            s_margin = 0 if counter == 0 else margin
            end = min(skip + chunk + margin, samples)
            seg = self._demix_segment(mix[:, skip - s_margin:end].copy())
            start = 0 if counter == 0 else margin
            stop = None if end == samples else -margin
            if margin == 0:
                stop = None
            outs.append(seg[:, start:stop])
            counter += 1
            if end == samples:
                break
            skip += chunk
        return np.concatenate(outs, axis=-1)

    def separate(self, wav: np.ndarray, sr: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(vocal, instrumental), stereo at 44.1 kHz: the net's output is
        the non-vocal stem and vocal = mix - it."""
        if sr != self.SR:
            wav = audio_io.resample(wav, sr, self.SR)
        if wav.ndim == 1:
            wav = np.stack([wav, wav])
        opt = self.demix(wav)
        vocal = wav[:, :opt.shape[1]] - opt
        return vocal, opt
