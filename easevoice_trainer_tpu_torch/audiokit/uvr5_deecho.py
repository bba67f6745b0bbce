"""DeEcho / DeReverb separation net (JAX: audiokit/uvr5_deecho.py), in
plain torch.

The VR "nets_new" CascadedNet: a two-band, three-stage U-Net stack with
2-D-dilated ASPP and a bidirectional LSTM over the frames on the last
decoder, predicting a sigmoid echo / reverb mask.  ``nout`` is 64 for
DeReverb models and 48 for DeEcho; the band config is 4band_v3.json.  The
LSTM is ``nn.LSTM(bidirectional=True)`` (cuDNN on the card): the JAX package
computes it with XLA's scan, outside any Pallas kernel.

NCHW modules under the reference's torch names (the keys the JAX
``convert_deecho_weights`` reads), so a released ``.pth`` loads with
``load_state_dict(strict=True)`` apart from BatchNorm's
``num_batches_tracked`` counters.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .uvr5 import _FreqPool, crop_to, pad_mask, upsample2


class ConvBN2(nn.Module):
    """Conv2DBNActiv of layers_new: conv with 2-D padding and dilation,
    BatchNorm, ReLU or leaky ReLU (slope 0.01)."""

    def __init__(self, nin: int, nout: int, ksize: int = 3, stride: int = 1,
                 pad=(1, 1), dilation=(1, 1), leaky: bool = False):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nout, ksize, stride, tuple(pad), tuple(dilation),
                      bias=False),
            nn.BatchNorm2d(nout))
        self.leaky = leaky

    def forward(self, x):
        x = self.conv(x)
        return F.leaky_relu(x, 0.01) if self.leaky else F.relu(x)


class NewEncoder(nn.Module):
    def __init__(self, nin: int, nout: int, stride: int = 2):
        super().__init__()
        self.conv1 = ConvBN2(nin, nout, 3, stride, leaky=True)
        self.conv2 = ConvBN2(nout, nout, 3, 1, leaky=True)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class NewDecoder(nn.Module):
    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv1 = ConvBN2(nin, nout, 3, 1)

    def forward(self, x, skip=None):
        x = upsample2(x)
        if skip is not None:
            x = torch.cat([x, crop_to(skip, x)], dim=1)
        return self.conv1(x)


class NewASPP(nn.Module):
    DILATIONS = ((4, 2), (8, 4), (12, 6))

    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv1 = nn.Sequential(_FreqPool(),
                                   ConvBN2(nin, nout, 1, 1, (0, 0)))
        self.conv2 = ConvBN2(nin, nout, 1, 1, (0, 0))
        self.conv3, self.conv4, self.conv5 = (
            ConvBN2(nin, nout, 3, 1, d, d) for d in self.DILATIONS)
        self.bottleneck = ConvBN2(nout * 5, nout, 1, 1, (0, 0))

    def forward(self, x):
        feats = [self.conv1(x).expand(-1, -1, x.shape[2], -1), self.conv2(x),
                 self.conv3(x), self.conv4(x), self.conv5(x)]
        return self.bottleneck(torch.cat(feats, dim=1))


class BiLSTMModule(nn.Module):
    """1x1 conv to one channel -> bidirectional LSTM over the frames ->
    dense + BatchNorm + ReLU a frame; (B, C, bins, frames) -> (B, 1, bins,
    frames)."""

    def __init__(self, nin_conv: int, nin_lstm: int, nout_lstm: int):
        super().__init__()
        self.conv = ConvBN2(nin_conv, 1, 1, 1, (0, 0))
        self.lstm = nn.LSTM(nin_lstm, nout_lstm // 2, batch_first=True,
                            bidirectional=True)
        self.dense = nn.Sequential(nn.Linear(nout_lstm, nin_lstm),
                                   nn.BatchNorm1d(nin_lstm), nn.ReLU())

    def forward(self, x):
        b, _, bins, frames = x.shape
        seq = self.conv(x)[:, 0].transpose(1, 2)            # (B, frames, bins)
        h, _ = self.lstm(seq.contiguous())                  # (B, frames, nout)
        d = self.dense(h.reshape(b * frames, -1))           # (B*frames, bins)
        return d.reshape(b, frames, bins).transpose(1, 2)[:, None]


class NewBaseNet(nn.Module):
    def __init__(self, nin: int, nout: int, nin_lstm: int, nout_lstm: int):
        super().__init__()
        self.enc1 = ConvBN2(nin, nout, 3, 1)
        self.enc2 = NewEncoder(nout, nout * 2)
        self.enc3 = NewEncoder(nout * 2, nout * 4)
        self.enc4 = NewEncoder(nout * 4, nout * 6)
        self.enc5 = NewEncoder(nout * 6, nout * 8)
        self.aspp = NewASPP(nout * 8, nout * 8)
        self.dec4 = NewDecoder(nout * (6 + 8), nout * 6)
        self.dec3 = NewDecoder(nout * (4 + 6), nout * 4)
        self.dec2 = NewDecoder(nout * (2 + 4), nout * 2)
        self.lstm_dec2 = BiLSTMModule(nout * 2, nin_lstm, nout_lstm)
        self.dec1 = NewDecoder(nout * (1 + 2) + 1, nout)

    def forward(self, x):
        e1 = self.enc1(x)
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        e4 = self.enc4(e3)
        e5 = self.enc5(e4)
        h = self.aspp(e5)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        h = torch.cat([h, self.lstm_dec2(h)], dim=1)
        return self.dec1(h, e1)


class CascadedNet(nn.Module):
    """DeEcho / DeReverb mask net; input (B, 2, bins, frames) magnitude,
    output the sigmoid mask of the same shape."""

    def __init__(self, n_fft: int, nout: int = 32, nout_lstm: int = 128):
        super().__init__()
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        nin_lstm = self.max_bin // 2
        self.stg1_low_band_net = nn.Sequential(
            NewBaseNet(2, nout // 2, nin_lstm // 2, nout_lstm),
            ConvBN2(nout // 2, nout // 4, 1, 1, (0, 0)))
        self.stg1_high_band_net = NewBaseNet(2, nout // 4, nin_lstm // 2,
                                             nout_lstm // 2)
        self.stg2_low_band_net = nn.Sequential(
            NewBaseNet(nout // 4 + 2, nout, nin_lstm // 2, nout_lstm),
            ConvBN2(nout, nout // 2, 1, 1, (0, 0)))
        self.stg2_high_band_net = NewBaseNet(nout // 4 + 2, nout // 2,
                                             nin_lstm // 2, nout_lstm // 2)
        self.stg3_full_band_net = NewBaseNet(3 * nout // 4 + 2, nout,
                                             nin_lstm, nout_lstm)
        self.out = nn.Conv2d(nout, 2, 1, bias=False)

    def forward(self, x):
        x = x[:, :, :self.max_bin]
        bandw = x.shape[2] // 2
        l1_in, h1_in = x[:, :, :bandw], x[:, :, bandw:]
        l1 = self.stg1_low_band_net(l1_in)
        h1 = self.stg1_high_band_net(h1_in)
        aux1 = torch.cat([l1, h1], dim=2)
        l2 = self.stg2_low_band_net(torch.cat([l1_in, l1], dim=1))
        h2 = self.stg2_high_band_net(torch.cat([h1_in, h1], dim=1))
        aux2 = torch.cat([l2, h2], dim=2)
        f3 = self.stg3_full_band_net(torch.cat([x, aux1, aux2], dim=1))
        mask = torch.sigmoid(self.out(f3))
        return pad_mask(mask, self.output_bin)
