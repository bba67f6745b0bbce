"""Plain PyTorch reference of the s2 SoVITS fine-tune step (GPT-SoVITS v2
s2, ``module/models.py`` ``SynthesizerTrn`` + ``MultiPeriodDiscriminator``,
``module/losses.py``, ``s2_train.py``): the generator forward, the
discriminator's LSGAN step, then the generator's step against the updated
discriminator, each with AdamW.

fp32 throughout with TF32 off, plain convolutions (the ResBlocks' convs
too), no kernels.  Parameters and buffers are a dict under the published
state-dict names; weight norm is ``g * v / ||v||``.  It imports nothing of
the program.  Dropout draws its keep masks as ``torch.rand(shape) >= p``
from the step's generator, in the order of the published modules, so the
same seed gives the same masks as any implementation that draws alike.
``q`` rounds every product's operands (a control in a lower precision).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .gpt_s1 import FP32, Lowp

LRELU = 0.1
MASK_VALUE = -1e4
PERIODS = (2, 3, 5, 7, 11)
S_SPECS = ((1, 16, 15, 1, 1, 7), (16, 64, 41, 4, 4, 20),
           (64, 256, 41, 4, 16, 20), (256, 1024, 41, 4, 64, 20),
           (1024, 1024, 41, 4, 256, 20), (1024, 1024, 5, 1, 1, 2))
P_CHANS = ((1, 32), (32, 128), (128, 512), (512, 1024))
TEXT_LOW_LR = ("enc_p.text_embedding", "enc_p.encoder_text", "enc_p.mrte")


# ---- shapes ---------------------------------------------------------------


def _conv(shapes, name, cin, cout, k, bias=True):
    shapes[name + ".weight"] = (cout, cin, k)
    if bias:
        shapes[name + ".bias"] = (cout,)


def _wn(shapes, name, v_shape, bias=True, out=None):
    shapes[name + ".weight_v"] = tuple(v_shape)
    shapes[name + ".weight_g"] = (v_shape[0],) + (1,) * (len(v_shape) - 1)
    if bias:
        shapes[name + ".bias"] = (out if out is not None else v_shape[0],)


def _relpos(shapes, name, hidden, filt, heads, layers, k):
    dk = hidden // heads
    for i in range(layers):
        a = f"{name}.attn_layers.{i}."
        for c in "qkvo":
            _conv(shapes, a + "conv_" + c, hidden, hidden, 1)
        shapes[a + "emb_rel_k"] = (1, 9, dk)
        shapes[a + "emb_rel_v"] = (1, 9, dk)
        for n in (f"{name}.norm_layers_1.{i}", f"{name}.norm_layers_2.{i}"):
            shapes[n + ".gamma"] = (hidden,)
            shapes[n + ".beta"] = (hidden,)
        _conv(shapes, f"{name}.ffn_layers.{i}.conv_1", hidden, filt, k)
        _conv(shapes, f"{name}.ffn_layers.{i}.conv_2", filt, hidden, k)


def _wavenet(shapes, name, hidden, k, layers, gin):
    _wn(shapes, name + ".cond_layer", (2 * hidden * layers, gin, 1))
    for i in range(layers):
        _wn(shapes, f"{name}.in_layers.{i}", (2 * hidden, hidden, k))
        out = 2 * hidden if i < layers - 1 else hidden
        _wn(shapes, f"{name}.res_skip_layers.{i}", (out, hidden, 1))


def generator_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Parameters and buffers of ``SynthesizerTrn`` with ``enc_q``."""
    m = cfg["model"]
    s: Dict[str, Tuple[int, ...]] = {}
    inter, hidden, filt = (m["inter_channels"], m["hidden_channels"],
                           m["filter_channels"])
    heads, layers, k, gin = (m["n_heads"], m["n_layers"], m["kernel_size"],
                             m["gin_channels"])
    ssl_dim = cfg["model"]["ssl_dim"]
    spec_ch = cfg["data"]["filter_length"] // 2 + 1
    _conv(s, "enc_p.ssl_proj", ssl_dim, hidden, 1)
    _relpos(s, "enc_p.encoder_ssl", hidden, filt, heads, layers // 2, k)
    s["enc_p.text_embedding.weight"] = (cfg["model"]["n_symbols"], hidden)
    _relpos(s, "enc_p.encoder_text", hidden, filt, heads, layers, k)
    for c in "qkvo":
        _conv(s, "enc_p.mrte.cross_attention.conv_" + c, gin, gin, 1)
    _conv(s, "enc_p.mrte.c_pre", hidden, gin, 1)
    _conv(s, "enc_p.mrte.text_pre", hidden, gin, 1)
    _conv(s, "enc_p.mrte.c_post", gin, hidden, 1)
    _relpos(s, "enc_p.encoder2", hidden, filt, heads, layers // 2, k)
    _conv(s, "enc_p.proj", hidden, 2 * inter, 1)
    ch = m["upsample_initial_channel"]
    _conv(s, "dec.conv_pre", inter, ch, 7)
    _conv(s, "dec.cond", gin, ch, 1)
    j = 0
    for i, (u, kk) in enumerate(zip(m["upsample_rates"],
                                    m["upsample_kernel_sizes"])):
        out = m["upsample_initial_channel"] // 2 ** (i + 1)
        _wn(s, f"dec.ups.{i}", (ch, out, kk), out=out)
        ch = out
        for rk, rd in zip(m["resblock_kernel_sizes"],
                          m["resblock_dilation_sizes"]):
            for n in range(len(rd)):
                _wn(s, f"dec.resblocks.{j}.convs1.{n}", (ch, ch, rk))
                _wn(s, f"dec.resblocks.{j}.convs2.{n}", (ch, ch, rk))
            j += 1
    _conv(s, "dec.conv_post", ch, 1, 7, bias=False)
    for f in range(0, 8, 2):
        _conv(s, f"flow.flows.{f}.pre", inter // 2, hidden, 1)
        _wavenet(s, f"flow.flows.{f}.enc", hidden, 5, 4, gin)
        _conv(s, f"flow.flows.{f}.post", hidden, inter // 2, 1)
    _lin = lambda n, i, o: s.update({n + ".weight": (o, i), n + ".bias": (o,)})
    _lin("ref_enc.spectral.0.fc", 704, 128)
    _lin("ref_enc.spectral.3.fc", 128, 128)
    for t in range(2):
        _conv(s, f"ref_enc.temporal.{t}.conv1.conv", 128, 256, 5)
    for n in ("w_qs", "w_ks", "w_vs", "fc"):
        _lin("ref_enc.slf_attn." + n, 128, 128)
    _lin("ref_enc.fc.fc", 128, gin)
    _conv(s, "ssl_proj", ssl_dim, ssl_dim, 2)
    s["quantizer.vq.layers.0._codebook.embed"] = (1024, ssl_dim)
    _conv(s, "enc_q.pre", spec_ch, hidden, 1)
    _wavenet(s, "enc_q.enc", hidden, 5, 16, gin)
    _conv(s, "enc_q.proj", hidden, 2 * inter, 1)
    return s


def discriminator_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    s: Dict[str, Tuple[int, ...]] = {}
    for i, (cin, cout, k, _, g, _) in enumerate(S_SPECS):
        _wn(s, f"discriminators.0.convs.{i}", (cout, cin // g, k))
    _wn(s, "discriminators.0.conv_post", (1, 1024, 3))
    for d in range(1, len(PERIODS) + 1):
        for i, (cin, cout) in enumerate(P_CHANS + ((1024, 1024),)):
            _wn(s, f"discriminators.{d}.convs.{i}", (cout, cin, 5, 1))
        _wn(s, f"discriminators.{d}.conv_post", (1, 1024, 3, 1))
    return s


FROZEN = ("ssl_proj.", "quantizer.")   # no gradient, no optimizer state
# start small, as in a fine-tune from a pretrained model: the projections to
# the latent statistics and the flow's coupling outputs (the published model
# starts its couplings at identity), so that the KL's exp(-2 logs_p) starts
# near 1 and not at e^6
STATS = ("enc_p.proj.", "enc_q.proj.")


def init_rule(name: str, shape):
    """The benchmark's draw of a weight: the common rule, a tenth of it for
    the latent statistics' projections and the couplings' outputs."""
    from evbench.common import InitRule, default_rule

    r = default_rule(name, shape)
    small = name.startswith(STATS) or (name.startswith("flow.flows.")
                                       and ".post." in name)
    return InitRule(r.mean * 0.1, r.std * 0.1) if small else r


# ---- layers -----------------------------------------------------------------


def wn(P, name: str) -> torch.Tensor:
    v, g = P[name + ".weight_v"], P[name + ".weight_g"]
    dims = list(range(1, v.dim()))
    return g * v / torch.linalg.vector_norm(v, dim=dims,
                                            keepdim=True).clamp_min(1e-12)


def conv1d(x, w, b, q: Lowp, **kw):
    y = F.conv1d(q(x), q(w), None, **kw)
    return y if b is None else y + b[:, None]


def conv(P, name, x, q, **kw):
    return conv1d(x, P[name + ".weight"], P.get(name + ".bias"), q, **kw)


def lrelu(x, slope=LRELU):
    return torch.where(x >= 0, x, x * slope)


def drop(x, p: float, gen):
    """Dropout with the program's masks: they agree only while both sides
    draw from generators seeded alike, site by site in the same order
    (``evbench/README.md``)."""
    if gen is None or p == 0.0:
        return x
    keep = torch.rand(tuple(x.shape), generator=gen, device=x.device,
                      dtype=torch.float32) >= p
    return x * keep / (1.0 - p)


def seq_mask(lengths, n):
    return (torch.arange(n, device=lengths.device)[None, :]
            < lengths[:, None]).float()


def channel_norm(P, name, x, eps=1e-5):
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * P[name + ".gamma"][None, :, None] + P[name + ".beta"][
        None, :, None]


def _rel_to_abs(x):
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1))
    x = F.pad(x.reshape(b, h, l * 2 * l), (0, l - 1))
    return x.reshape(b, h, l + 1, 2 * l - 1)[:, :, :l, l - 1:]


def _abs_to_rel(x):
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1))
    x = F.pad(x.reshape(b, h, l * l + l * (l - 1)), (l, 0))
    return x.reshape(b, h, l, 2 * l)[:, :, :, 1:]


def _window(emb, length, window=4):
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start:start + 2 * length - 1]


def mha(P, name, x, c, mask, heads, q, rel: bool, p: float, gen):
    qq = conv(P, name + ".conv_q", x, q)
    kk = conv(P, name + ".conv_k", c, q)
    vv = conv(P, name + ".conv_v", c, q)
    b, d, tq = qq.shape
    ts = kk.shape[2]
    dk = d // heads
    qq = qq.view(b, heads, dk, tq).transpose(2, 3) / math.sqrt(dk)
    kk = kk.view(b, heads, dk, ts).transpose(2, 3)
    vv = vv.view(b, heads, dk, ts).transpose(2, 3)
    scores = q(qq) @ q(kk).transpose(2, 3)
    if rel:
        rk = _window(P[name + ".emb_rel_k"], ts)
        scores = scores + _rel_to_abs(torch.einsum("bhqd,xmd->bhqm", q(qq),
                                                   q(rk)))
    scores = scores.masked_fill(mask == 0, MASK_VALUE)
    probs = drop(torch.softmax(scores, dim=-1), p, gen)
    out = q(probs) @ q(vv)
    if rel:
        rv = _window(P[name + ".emb_rel_v"], ts)
        out = out + torch.einsum("bhqm,xmd->bhqd", q(_abs_to_rel(probs)),
                                 q(rv))
    out = out.transpose(2, 3).reshape(b, d, tq)
    return conv(P, name + ".conv_o", out, q)


def relpos_encoder(P, name, x, x_mask, heads, layers, k, q, p, gen):
    attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)
    pads = ((k - 1) // 2, k // 2)
    x = x * x_mask
    for i in range(layers):
        y = mha(P, f"{name}.attn_layers.{i}", x, x, attn_mask, heads, q,
                True, p, gen)
        x = channel_norm(P, f"{name}.norm_layers_1.{i}", x + drop(y, p, gen))
        f = f"{name}.ffn_layers.{i}"
        y = torch.relu(conv(P, f + ".conv_1", F.pad(x * x_mask, pads), q))
        y = drop(y, p, gen)
        y = conv(P, f + ".conv_2", F.pad(y * x_mask, pads), q) * x_mask
        x = channel_norm(P, f"{name}.norm_layers_2.{i}", x + drop(y, p, gen))
    return x * x_mask


def wavenet(P, name, x, x_mask, g, hidden, k, layers, q):
    out = torch.zeros_like(x)
    g_all = conv1d(g, wn(P, name + ".cond_layer"),
                   P[name + ".cond_layer.bias"], q)
    for i in range(layers):
        x_in = conv1d(x, wn(P, f"{name}.in_layers.{i}"),
                      P[f"{name}.in_layers.{i}.bias"], q, padding=(k - 1) // 2)
        a = x_in + g_all[:, i * 2 * hidden:(i + 1) * 2 * hidden]
        acts = torch.tanh(a[:, :hidden]) * torch.sigmoid(a[:, hidden:])
        rs = conv1d(acts, wn(P, f"{name}.res_skip_layers.{i}"),
                    P[f"{name}.res_skip_layers.{i}.bias"], q)
        if i < layers - 1:
            x = (x + rs[:, :hidden]) * x_mask
            out = out + rs[:, hidden:]
        else:
            out = out + rs
    return out * x_mask


def _linear(P, name, x, q):
    return q(x) @ q(P[name + ".weight"]).t() + P[name + ".bias"]


def mish(x):
    return x * torch.tanh(F.softplus(x))


def style(P, spec, spec_mask, q):
    """MelStyleEncoder over the first 704 bins: (B, T, 704) -> (B, 1, gin)."""
    x = spec[..., :704] * spec_mask
    y = mish(_linear(P, "ref_enc.spectral.0.fc", x, q))
    y = mish(_linear(P, "ref_enc.spectral.3.fc", y, q))
    y = y.transpose(1, 2)
    for t in range(2):
        h = conv(P, f"ref_enc.temporal.{t}.conv1.conv", F.pad(y, (2, 2)), q)
        y = y + h[:, :128] * torch.sigmoid(h[:, 128:])
    y = y.transpose(1, 2) * spec_mask
    b, t, d = y.shape
    split = lambda z: z.view(b, t, 2, d // 2).transpose(1, 2)
    qq, kk, vv = (split(_linear(P, "ref_enc.slf_attn." + n, y, q))
                  for n in ("w_qs", "w_ks", "w_vs"))
    scores = q(qq) @ q(kk).transpose(2, 3) / math.sqrt(d)
    scores = scores.masked_fill(~(spec_mask[:, None, None, :, 0] > 0),
                                -math.inf)
    attn = q(torch.softmax(scores, dim=-1)) @ q(vv)
    y = y + _linear(P, "ref_enc.slf_attn.fc",
                    attn.transpose(1, 2).reshape(b, t, d), q)
    y = _linear(P, "ref_enc.fc.fc", y, q) * spec_mask
    return y.sum(1, keepdim=True) / spec_mask.sum(1, keepdim=True).clamp_min(
        1.0)


def quantize(P, h):
    """Nearest codebook entry (straight-through) and the commit loss."""
    cb = P["quantizer.vq.layers.0._codebook.embed"]
    flat = h.detach().reshape(-1, h.shape[-1])
    idx = (2.0 * flat @ cb.T - (cb * cb).sum(-1)[None]).argmax(-1)
    quant = cb[idx].reshape(h.shape).detach()
    commit = ((h - quant) ** 2).mean()
    return h + (quant - h).detach(), commit


def text_encoder(P, cfg, y, y_lengths, text, text_lengths, ge, q, gen):
    m = cfg["model"]
    hidden, heads, layers, k, p = (m["hidden_channels"], m["n_heads"],
                                   m["n_layers"], m["kernel_size"],
                                   m["p_dropout"])
    y_mask = seq_mask(y_lengths, y.shape[2])[:, None]
    t_mask = seq_mask(text_lengths, text.shape[1])[:, None]
    y = conv(P, "enc_p.ssl_proj", y * y_mask, q) * y_mask
    y = relpos_encoder(P, "enc_p.encoder_ssl", y * y_mask, y_mask, heads,
                       layers // 2, k, q, p, gen)
    t = F.embedding(text, P["enc_p.text_embedding.weight"]).transpose(1, 2)
    t = relpos_encoder(P, "enc_p.encoder_text", t * t_mask, t_mask, heads,
                       layers, k, q, p, gen)
    attn_mask = y_mask.unsqueeze(-1) * t_mask.unsqueeze(2)
    c = conv(P, "enc_p.mrte.c_pre", y * y_mask, q)
    tt = conv(P, "enc_p.mrte.text_pre", t * t_mask, q)
    x = mha(P, "enc_p.mrte.cross_attention", c * y_mask, tt * t_mask,
            attn_mask, 4, q, False, 0.0, None)
    y = conv(P, "enc_p.mrte.c_post", (x + c + ge) * y_mask, q)
    y = relpos_encoder(P, "enc_p.encoder2", y * y_mask, y_mask, heads,
                       layers // 2, k, q, p, gen)
    stats = conv(P, "enc_p.proj", y, q) * y_mask
    inter = m["inter_channels"]
    return stats[:, :inter], stats[:, inter:], y_mask


def posterior(P, x, x_mask, g, eps, q):
    h = conv(P, "enc_q.pre", x, q) * x_mask
    h = wavenet(P, "enc_q.enc", h, x_mask, g.detach(), h.shape[1], 5, 16, q)
    stats = conv(P, "enc_q.proj", h, q) * x_mask
    half = stats.shape[1] // 2
    m, logs = stats[:, :half], stats[:, half:]
    return (m + eps * torch.exp(logs)) * x_mask, m, logs


def flow(P, x, x_mask, g, q):
    half = x.shape[1] // 2
    for f in range(0, 8, 2):
        n = f"flow.flows.{f}"
        x0, x1 = x[:, :half], x[:, half:]
        h = conv(P, n + ".pre", x0, q) * x_mask
        h = wavenet(P, n + ".enc", h, x_mask, g, h.shape[1], 5, 4, q)
        mm = conv(P, n + ".post", h, q) * x_mask
        x = torch.flip(torch.cat([x0, (mm + x1) * x_mask], 1), dims=[1])
    return x


def decoder(P, cfg, x, g, q):
    m = cfg["model"]
    x = conv(P, "dec.conv_pre", x, q, padding=3) + conv(P, "dec.cond", g, q)
    n = len(m["resblock_kernel_sizes"])
    j = 0
    for i, (u, k) in enumerate(zip(m["upsample_rates"],
                                   m["upsample_kernel_sizes"])):
        name = f"dec.ups.{i}"
        x = F.conv_transpose1d(q(lrelu(x)), q(wn(P, name)), None, u,
                               (k - u) // 2) + P[name + ".bias"][:, None]
        xs = None
        for rk, rd in zip(m["resblock_kernel_sizes"],
                          m["resblock_dilation_sizes"]):
            y = x
            for c, d in enumerate(rd):
                b = f"dec.resblocks.{j}"
                t = conv1d(lrelu(y), wn(P, f"{b}.convs1.{c}"),
                           P[f"{b}.convs1.{c}.bias"], q,
                           padding=(rk - 1) * d // 2, dilation=d)
                y = conv1d(lrelu(t), wn(P, f"{b}.convs2.{c}"),
                           P[f"{b}.convs2.{c}.bias"], q,
                           padding=(rk - 1) // 2) + y
            xs = y if xs is None else xs + y
            j += 1
        x = xs / n
    return torch.tanh(conv(P, "dec.conv_post", lrelu(x, 0.01), q, padding=3))


def slice_segments(x, starts, size):
    idx = starts[:, None] + torch.arange(size, device=x.device)[None]
    return x.gather(2, idx[:, None, :].expand(x.shape[0], x.shape[1], -1))


def generator_forward(P, cfg, batch, ids_slice, eps, q, gen):
    """-> (y_hat (B, 1, seg), commit, (z_p, m_p, logs_p, logs_q), y_mask)."""
    spec, lengths = batch["spec"], batch["spec_lengths"]
    spec_mask = seq_mask(lengths, spec.shape[1])[:, :, None]
    ge = style(P, spec, spec_mask, q).transpose(1, 2)
    h = conv(P, "ssl_proj", batch["ssl"].transpose(1, 2), q,
             stride=2).transpose(1, 2).detach()
    quantized, commit = quantize(P, h)
    quantized = torch.repeat_interleave(quantized, 2, dim=1)
    m_p, logs_p, y_mask = text_encoder(P, cfg, quantized.transpose(1, 2),
                                       lengths, batch["text"],
                                       batch["text_lengths"], ge, q, gen)
    z, m_q, logs_q = posterior(P, spec.transpose(1, 2), y_mask, ge,
                               eps.transpose(1, 2), q)
    z_p = flow(P, z, y_mask, ge, q)
    seg = cfg["train"]["segment_size"] // cfg["data"]["hop_length"]
    y_hat = decoder(P, cfg, slice_segments(z, ids_slice, seg), ge, q)
    return y_hat, commit, (z_p, m_p, logs_p, logs_q), y_mask


def disc_s(P, x, q):
    fmap = []
    for i, (_, _, k, s, g, p) in enumerate(S_SPECS):
        name = f"discriminators.0.convs.{i}"
        x = lrelu(conv1d(x, wn(P, name), P[name + ".bias"], q, stride=s,
                         groups=g, padding=p))
        fmap.append(x)
    x = conv1d(x, wn(P, "discriminators.0.conv_post"),
               P["discriminators.0.conv_post.bias"], q, padding=1)
    fmap.append(x)
    return torch.flatten(x, 1, -1), fmap


def disc_p(P, d, period, x, q):
    b, c, t = x.shape
    if t % period:
        n = period - t % period
        x = F.pad(x, (0, n), mode="reflect")
        t += n
    x = x.view(b, c, t // period, period)
    fmap = []
    for i in range(5):
        name = f"discriminators.{d}.convs.{i}"
        x = F.conv2d(q(x), q(wn(P, name)), None, (3 if i < 4 else 1, 1),
                     (2, 0)) + P[name + ".bias"][:, None, None]
        x = lrelu(x)
        fmap.append(x)
    name = f"discriminators.{d}.conv_post"
    x = F.conv2d(q(x), q(wn(P, name)), None, 1, (1, 0)) + \
        P[name + ".bias"][:, None, None]
    fmap.append(x)
    return torch.flatten(x, 1, -1), fmap


def discriminate(P, x, q):
    outs = [disc_s(P, x, q)] + [disc_p(P, d + 1, per, x, q)
                                for d, per in enumerate(PERIODS)]
    return [o[0] for o in outs], [o[1] for o in outs]


# ---- spectrograms -------------------------------------------------------


def mel_matrix(cfg, device) -> torch.Tensor:
    """Slaney mel filterbank (librosa's default), (n_freq, n_mels)."""
    d = cfg["data"]
    sr, n_fft, n_mels = d["sampling_rate"], d["filter_length"], \
        d["n_mel_channels"]
    fmin = d["mel_fmin"]
    fmax = d["mel_fmax"] if d["mel_fmax"] is not None else sr / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10)
                                                   / 1000.0)
                        / (np.log(6.4) / 27.0), lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0
                                                   * (m - 15.0)),
                        m * 200.0 / 3)

    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    edges = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                  n_mels + 2))
    lo, ce, up = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    w = np.maximum(0.0, np.minimum((freqs[None] - lo) / np.maximum(
        ce - lo, 1e-10), (up - freqs[None]) / np.maximum(up - ce, 1e-10)))
    w *= (2.0 / (edges[2:] - edges[:-2]))[:, None]
    return torch.from_numpy(w.T.astype(np.float32)).to(device)


def spectrogram(y, n_fft, hop, win):
    pad = (n_fft - hop) // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = y.unfold(-1, n_fft, hop)
    n = torch.arange(win, dtype=torch.float32, device=y.device)
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win)
    spec = torch.fft.rfft(frames * window, n=n_fft)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6)


def log_mel(spec, mel):
    return torch.log(torch.clamp(spec @ mel, min=1e-5))


# ---- the step ---------------------------------------------------------------


class AdamW:
    """torch AdamW with optax's update order, fp32 moments."""

    def __init__(self, groups: List[Tuple[List[str], float]], lr: float,
                 betas, eps, weight_decay, decay, steps_per_epoch):
        self.groups, self.lr, self.eps = groups, lr, eps
        self.b1, self.b2 = betas
        self.wd, self.decay, self.spe = weight_decay, decay, steps_per_epoch
        self.count = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, P, grads):
        lr = self.lr * self.decay ** (self.count // self.spe)
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for names, scale in self.groups:
            for k in names:
                g = grads[k]
                m = self.m.get(k, torch.zeros_like(g)) * self.b1 + \
                    (1 - self.b1) * g
                v = self.v.get(k, torch.zeros_like(g)) * self.b2 + \
                    (1 - self.b2) * g * g
                self.m[k], self.v[k] = m, v
                upd = (m / c1) / ((v / c2).sqrt() + self.eps) + self.wd * P[k]
                P[k] = P[k] - lr * scale * upd


def leaves(P: Dict[str, torch.Tensor], frozen=FROZEN):
    """Detached copies of ``P`` that track gradients (not the frozen)."""
    return {k: v.detach().requires_grad_(not k.startswith(frozen))
            for k, v in P.items()}


def grads_of(loss, P):
    names = [k for k in P if P[k].requires_grad]
    return dict(zip(names, torch.autograd.grad(loss, [P[k] for k in names])))


def targets(cfg, batch, ids_slice, mel):
    """The real waveform slice and its log-mel frames."""
    hop, seg = cfg["data"]["hop_length"], cfg["train"]["segment_size"]
    with torch.no_grad():
        y_mel = slice_segments(log_mel(batch["spec"], mel).transpose(1, 2),
                               ids_slice, seg // hop)
        y = slice_segments(batch["wav"][:, None], ids_slice * hop, seg)
    return y, y_mel


def disc_loss(D, y, y_hat, q):
    """The LSGAN loss of D on a real and a generated slice."""
    real, _ = discriminate(D, y, q)
    fake, _ = discriminate(D, y_hat, q)
    return sum(torch.mean((1 - r) ** 2) + torch.mean(f ** 2)
               for r, f in zip(real, fake))


def gen_loss(cfg, D, fwd, y, y_mel, mel, q):
    """The generator's total loss against ``D`` (held fixed)."""
    d, t = cfg["data"], cfg["train"]
    y_hat, commit, (z_p, m_p, logs_p, logs_q), y_mask = fwd
    with torch.no_grad():
        _, fmap_r = discriminate(D, y, q)
    fake, fmap_g = discriminate(D, y_hat, q)
    y_hat_mel = log_mel(spectrogram(y_hat[:, 0], d["filter_length"],
                                    d["hop_length"], d["win_length"]),
                        mel).transpose(1, 2)
    loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * t["c_mel"]
    kl = logs_p - logs_q - 0.5 + 0.5 * (z_p - m_p) ** 2 * torch.exp(
        -2.0 * logs_p)
    loss_kl = torch.sum(kl * y_mask) / torch.sum(y_mask) * t["c_kl"]
    loss_fm = 2.0 * sum(torch.mean(torch.abs(r.detach() - g))
                        for dr, dg in zip(fmap_r, fmap_g)
                        for r, g in zip(dr, dg))
    loss_adv = sum(torch.mean((1 - f) ** 2) for f in fake)
    parts = {"adv": loss_adv, "fm": loss_fm, "mel": loss_mel, "kl": loss_kl,
             "commit": commit}
    return loss_adv + loss_fm + loss_mel + commit + loss_kl, parts


class Step:
    """The fine-tune's step on parameter dicts: ``__call__`` takes one
    batch and the step's draws, updates D then G, and returns the losses
    and gradients."""

    def __init__(self, cfg: dict, G: Dict[str, torch.Tensor],
                 D: Dict[str, torch.Tensor], steps_per_epoch: int,
                 q: Lowp = FP32):
        t = cfg["train"]
        self.cfg, self.G, self.D, self.q = cfg, G, D, q
        trainable = [k for k in G if not k.startswith(FROZEN)]
        text = [k for k in trainable if k.startswith(TEXT_LOW_LR)]
        base = [k for k in trainable if k not in set(text)]
        kw = dict(lr=t["learning_rate"], betas=tuple(t["betas"]),
                  eps=t["eps"], weight_decay=0.01, decay=t["lr_decay"],
                  steps_per_epoch=steps_per_epoch)
        self.opt_g = AdamW([(base, 1.0), (text, t["text_low_lr_rate"])],
                           **kw)
        self.opt_d = AdamW([(list(D), 1.0)], **kw)
        self.mel = mel_matrix(cfg, next(iter(G.values())).device)

    def __call__(self, batch, ids_slice, eps, gen) -> dict:
        cfg, q = self.cfg, self.q
        G = leaves(self.G)
        fwd = generator_forward(G, cfg, batch, ids_slice, eps, q, gen)
        y, y_mel = targets(cfg, batch, ids_slice, self.mel)
        D = leaves(self.D, ())
        loss_d = disc_loss(D, y, fwd[0].detach(), q)
        grads_d = grads_of(loss_d, D)
        self.opt_d.step(self.D, grads_d)
        total, parts = gen_loss(cfg, {k: v.detach() for k, v in
                                      self.D.items()}, fwd, y, y_mel,
                                self.mel, q)
        grads_g = grads_of(total, G)
        self.opt_g.step(self.G, grads_g)
        return {"loss_g": float(total.detach()),
                "loss_d": float(loss_d.detach()),
                "parts": {k: float(v.detach()) for k, v in parts.items()},
                "grads_g": grads_g, "grads_d": grads_d}
