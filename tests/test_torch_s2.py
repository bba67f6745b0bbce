"""Parity of the PyTorch port's s2 training slice with the JAX package, fp32
on the CPU at the tiny size of ``_torch_port_tiny.py``: spectrograms,
segment slicing, the quantizer forward, the posterior encoder, the flow
forward, ``SynthesizerTrn.forward``, the full-width MultiPeriodDiscriminator,
the losses, AdamW (fp32 and bf16 moments), the weight-norm and K3 gradients
(K4's twins), dropout, and two whole train steps against ``make_train_step``.
Each test states its tolerance; unless said otherwise a tolerance is
relative to the reference's largest magnitude (``assert_close``), for fp32
sums taken in other orders by the two frameworks."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from easevoice_trainer_tpu.models.sovits import discriminator as jdisc
from easevoice_trainer_tpu.models.sovits import generator as jgen
from easevoice_trainer_tpu.models.sovits import losses as jlosses
from easevoice_trainer_tpu.models.sovits import synthesizer as jsyn
from easevoice_trainer_tpu.nn import layers as jlayers
from easevoice_trainer_tpu.ops import stft as jstft
from easevoice_trainer_tpu.train import arena, ckpt
from easevoice_trainer_tpu.train import optim_lowp as joptim
from easevoice_trainer_tpu.train import sovits_step as jstep
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch.models.sovits import SovitsConfig, \
    SynthesizerTrn
from easevoice_trainer_tpu_torch.models.sovits import losses as plosses
from easevoice_trainer_tpu_torch.nn import layers as players
from easevoice_trainer_tpu_torch.nn.attention import RelPosEncoder
from easevoice_trainer_tpu_torch.ops import mrf
from easevoice_trainer_tpu_torch.ops import stft as pstft
from easevoice_trainer_tpu_torch.train import optim_lowp as poptim
from easevoice_trainer_tpu_torch.train import sovits as ptrain
from easevoice_trainer_tpu_torch.train import sovits_step as pstep

from _torch_port_tiny import SOVITS_KW, assert_close, tiny_mpd, \
    tiny_sovits_train
from test_trainers import TINY_S2, workspace  # noqa: F401  (a fixture)

JS = jsyn.SynthesizerTrn
CFG = jsyn.SovitsConfig(**SOVITS_KW)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def synth():
    port, params = tiny_sovits_train()
    return port, JS(CFG), params


@pytest.fixture(scope="module")
def mpd():
    port, params = tiny_mpd()
    return port, jdisc.MultiPeriodDiscriminator(), params


def _batch(seed=0, b=2, frames=16, lengths=(16, 13), text_len=6):
    """An s2 batch as ``collate_s2`` lays it out (numpy)."""
    rng = np.random.default_rng(seed)
    wav = rng.uniform(-0.5, 0.5, (b, frames * 640)).astype(np.float32)
    spec = np.asarray(jstft.spectrogram(wav))
    return {
        "ssl": rng.normal(size=(b, frames, SOVITS_KW["ssl_dim"])).astype(
            np.float32),
        "spec": spec, "spec_lengths": np.array(lengths, np.int32),
        "wav": wav,
        "text": rng.integers(1, 700, (b, text_len)).astype(np.int32),
        "text_lengths": np.array([text_len, text_len - 2], np.int32),
    }


def _torch_batch(batch):
    return {k: _t(v, torch.int64 if v.dtype.kind == "i" else None)
            for k, v in batch.items()}


# ---- ops/stft.py, slicing ---------------------------------------------------

def test_spectrogram_and_mel_match_jax():
    """Linear magnitudes within 1e-5 relative; log-mels within 2e-4
    absolute (fp32 FFTs of two libraries, then a log)."""
    wav = np.random.default_rng(1).uniform(-0.5, 0.5, (2, 12800)).astype(
        np.float32)
    cfg = jstft.MelConfig()
    pcfg = pstft.MelConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(pcfg)
    spec = pstft.spectrogram(_t(wav))
    want = np.asarray(jstft.spectrogram(wav))
    assert spec.shape == want.shape == (2, 20, 1025)
    assert_close(_np(spec), want, 1e-5, "spectrogram")
    mel = pstft.spec_to_mel(_t(want), pcfg)
    np.testing.assert_allclose(
        _np(mel), np.asarray(jstft.spec_to_mel(want, cfg)), rtol=0,
        atol=2e-4)
    np.testing.assert_allclose(
        _np(pstft.mel_spectrogram(_t(wav), pcfg)),
        np.asarray(jstft.mel_spectrogram(wav, cfg)), rtol=0, atol=2e-4)


def test_slice_segments_matches_jax():
    """Exact: a gather."""
    x = np.random.default_rng(2).normal(size=(3, 20, 5)).astype(np.float32)
    starts = np.array([3, 0, 16], np.int32)
    want = np.asarray(jlayers.slice_segments(x, starts, 4))
    got = players.slice_segments(_t(x).transpose(1, 2), _t(starts), 4)
    np.testing.assert_array_equal(_np(got.transpose(1, 2)), want)


def test_rand_slice_starts_formula():
    """(u * max(len - seg + 1, 1)).int() with u from the generator."""
    lengths = torch.tensor([16, 13, 3, 40])
    got = players.rand_slice_starts(lengths, 4,
                                    torch.Generator().manual_seed(7))
    u = torch.rand((4,), generator=torch.Generator().manual_seed(7))
    want = (u * torch.tensor([13.0, 10.0, 1.0, 37.0])).to(torch.int64)
    assert torch.equal(got, want)
    assert int(got[2]) == 0
    with pytest.raises(ValueError):
        players.rand_slice_starts(lengths, 4, None)


# ---- model pieces -------------------------------------------------------------

def test_quantizer_forward_matches_jax(synth):
    """Quantized output exact, codes identical, commit loss within 1e-6
    relative; the straight-through estimator passes the gradient as is."""
    port, jmodel, params = synth
    x = np.random.default_rng(3).normal(size=(2, 12, 64)).astype(np.float32)
    want = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, method=lambda m, x: m.quantizer(x, n_layers=1)))(
            params, x)
    xt = _t(x).requires_grad_()
    q, codes, commit = port.quantizer(xt, n_layers=1)
    assert codes.dtype == torch.int64
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want[1]))
    assert_close(_np(q), want[0], 1e-6, "quantized")
    assert_close(float(commit.detach()), float(want[2]), 1e-6, "commit")
    r = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    (g,) = torch.autograd.grad((q * r).sum(), xt)
    torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_posterior_encoder_matches_jax_with_eps(synth):
    """m, logs and the mask within 1e-4; z = (m + eps * exp(logs)) * mask
    with the noise given."""
    port, jmodel, params = synth
    rng = np.random.default_rng(4)
    spec = rng.random((2, 14, 1025)).astype(np.float32)
    lens = np.array([14, 9], np.int32)
    g = rng.normal(size=(2, 1, 32)).astype(np.float32)
    eps = rng.normal(size=(2, 14, 32)).astype(np.float32)
    z0, m, logs, mask = jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a, method=lambda mm, s, l, g: mm.enc_q(s, l, g=g)))(
            params, spec, lens, g)
    want_z = (np.asarray(m) + eps * np.exp(np.asarray(logs))) * np.asarray(
        mask)
    got = port.enc_q(_t(spec).transpose(1, 2), _t(lens, torch.int64),
                     g=_t(g).transpose(1, 2),
                     eps=_t(eps).transpose(1, 2))
    for name, a, b in zip(("z", "m", "logs", "mask"), got,
                          (want_z, m, logs, mask)):
        assert_close(_np(a.transpose(1, 2)), b, 1e-4, name)
    with pytest.raises(ValueError):
        port.enc_q(_t(spec).transpose(1, 2), _t(lens, torch.int64))


def test_flow_forward_matches_jax(synth):
    """Forward direction (posterior -> prior space), within 1e-4."""
    port, jmodel, params = synth
    rng = np.random.default_rng(5)
    z = rng.normal(size=(2, 20, 32)).astype(np.float32)
    mask = (np.arange(20)[None, :, None] < np.array([20, 13])[:, None, None]
            ).astype(np.float32)
    g = rng.normal(size=(2, 1, 32)).astype(np.float32)
    want = jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a, method=lambda m, z, mk, g: m.flow(z, mk, g=g)))(
            params, z, mask, g)
    with torch.no_grad():
        got = port.flow(_t(z).transpose(1, 2), _t(mask).transpose(1, 2),
                        g=_t(g).transpose(1, 2))
    assert_close(_np(got.transpose(1, 2)), want, 1e-4, "flow")


def _jax_forward(jmodel, params, batch, rng):
    """The JAX step's generator forward with its own rngs
    (``sovits_step.py gen_forward``)."""
    rngs = {"slice": jax.random.fold_in(rng, 1),
            "latent": jax.random.fold_in(rng, 2),
            "dropout": jax.random.fold_in(rng, 3)}
    return jax.jit(lambda p, b: jmodel.apply(
        {"params": p}, b["ssl"], b["spec"], b["spec_lengths"], b["text"],
        b["text_lengths"], rngs=rngs))(params, batch)


def _eps_of(outs):
    """The posterior noise the JAX forward drew: (z - m_q) / exp(logs_q)."""
    z, _, _, _, m_q, logs_q = (np.asarray(t) for t in outs[4])
    return (z - m_q) / np.exp(logs_q)


def test_synthesizer_forward_matches_jax(synth):
    """All outputs of the training forward, with the JAX forward's slice
    starts and posterior noise given: within 1e-4 (2e-4 for the waveform
    through the whole HiFi-GAN)."""
    port, jmodel, params = synth
    batch = _batch(6)
    outs = _jax_forward(jmodel, params, batch, jax.random.PRNGKey(0))
    eps = _eps_of(outs)
    with torch.no_grad():
        got = port(*(_torch_batch(batch)[k] for k in (
            "ssl", "spec", "spec_lengths", "text", "text_lengths")),
            ids_slice=_t(np.asarray(outs[2]), torch.int64), eps=_t(eps))
    y_hat, commit, ids, y_mask, latents = got
    assert y_hat.shape == outs[0].shape == (2, 2560, 1)
    assert_close(_np(y_hat), outs[0], 2e-4, "y_hat")
    assert_close(float(commit), float(outs[1]), 1e-5, "commit")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(outs[2]))
    assert_close(_np(y_mask), outs[3], 0, "y_mask")
    for name, a, b in zip(("z", "z_p", "m_p", "logs_p", "m_q", "logs_q"),
                          latents, outs[4]):
        assert_close(_np(a), b, 1e-4, name)


def test_synthesizer_build_keeps_deployable_state_dict():
    """The inference build has no enc_q; the training build adds only it,
    and freezes ssl_proj as the reference does."""
    cfg = SovitsConfig(**SOVITS_KW)
    infer = set(SynthesizerTrn(cfg).state_dict())
    train = SynthesizerTrn(cfg, with_enc_q=True)
    extra = set(train.state_dict()) - infer
    assert not any(k.startswith("enc_q.") for k in infer)
    assert extra and all(k.startswith("enc_q.") for k in extra)
    assert not any(p.requires_grad for p in train.ssl_proj.parameters())


def test_mpd_matches_jax(mpd):
    """Logits and feature maps of all six discriminators at 2560 samples
    (not a multiple of 3, 7 or 11: the reflect pad), within 1e-4; the
    JAX package runs its folded layout, (B * period, H, C)."""
    port, jmodel, params = mpd
    rng = np.random.default_rng(7)
    y = rng.uniform(-0.5, 0.5, (2, 2560, 1)).astype(np.float32)
    y_hat = rng.uniform(-0.5, 0.5, (2, 2560, 1)).astype(np.float32)
    want = jax.jit(lambda p, a, b: jmodel.apply({"params": p}, a, b))(
        params, y, y_hat)
    with torch.no_grad():
        got = port(_t(y).transpose(1, 2), _t(y_hat).transpose(1, 2))
    for which in (0, 1):
        for a, b in zip(got[which], want[which]):
            assert_close(_np(a), b, 1e-4, "logits")
    for which in (2, 3):
        for d, (fa, fb) in enumerate(zip(got[which], want[which])):
            for a, b in zip(fa, fb):
                if d == 0:   # scale discriminator: (B, C, T) -> (B, T, C)
                    a = a.transpose(1, 2)
                else:        # (B, C, H, p) -> (B * p, H, C)
                    bsz, c, h, p = a.shape
                    a = a.permute(0, 3, 2, 1).reshape(bsz * p, h, c)
                assert_close(_np(a), b, 1e-4, f"fmap {d}")


def test_discriminator_convert_roundtrip(mpd):
    port, _, params = mpd
    got = convert.discriminator_state_dict(params)
    want = port.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_losses_match_jax():
    """Each loss within 1e-6 relative."""
    rng = np.random.default_rng(8)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    real = [arr(2, 10), arr(2, 7)]
    fake = [arr(2, 10), arr(2, 7)]
    fr = [[arr(2, 4, 8), arr(2, 1, 8)], [arr(2, 3, 5)]]
    fg = [[arr(2, 4, 8), arr(2, 1, 8)], [arr(2, 3, 5)]]
    z_p, logs_q, m_p, logs_p = (arr(2, 9, 4) * 0.5 for _ in range(4))
    mask = (np.arange(9)[None, :, None] < np.array([9, 5])[:, None, None]
            ).astype(np.float32)
    tt = lambda xs: [_t(x) for x in xs]
    pairs = [
        (plosses.discriminator_loss(tt(real), tt(fake))[0],
         jlosses.discriminator_loss(real, fake)[0]),
        (plosses.generator_adv_loss(tt(fake))[0],
         jlosses.generator_adv_loss(fake)[0]),
        (plosses.feature_matching_loss([tt(f) for f in fr],
                                       [tt(f) for f in fg]),
         jlosses.feature_matching_loss(fr, fg)),
        (plosses.kl_loss(*(_t(a) for a in (z_p, logs_q, m_p, logs_p, mask))),
         jlosses.kl_loss(z_p, logs_q, m_p, logs_p, mask)),
    ]
    for got, want in pairs:
        assert_close(float(got), float(want), 1e-6, "loss")


@pytest.mark.parametrize("moments", ["fp32", "bf16"])
def test_adamw_matches_optax(moments):
    """Three steps, two LR groups, an LR schedule: fp32 moments against
    ``optax.adamw``, bf16 moments against the JAX package's
    ``scale_by_adam_lowp`` chain.  Parameters within 1e-6 absolute and the
    moments within 1e-6 relative (fp32 ops in another order; the bf16
    roundings land on the same values)."""
    rng = np.random.default_rng(9)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10 ** -k
              for s, k in zip(shapes, (0, 3, 6))] for _ in range(3)]
    lr_fn = lambda count: 1e-3 * 0.5 ** (count // 2)
    scales = (1.0, 0.4, 1.0)
    dtype = torch.float32 if moments == "fp32" else torch.bfloat16
    params = [torch.nn.Parameter(_t(p)) for p in p0]
    opt = poptim.AdamWLowp(
        [{"params": [params[0], params[2]]},
         {"params": [params[1]], "lr_scale": 0.4}], lr_fn, betas=(0.8, 0.99),
        eps=1e-9, weight_decay=0.01, dtype=dtype)

    def jtx(scale):
        sched = lambda c: lr_fn(c) * scale
        if moments == "fp32":
            return optax.adamw(sched, b1=0.8, b2=0.99, eps=1e-9,
                               weight_decay=0.01)
        return joptim.adamw_lowp(sched, 0.8, 0.99, 1e-9, 0.01,
                                 dtype=jnp.bfloat16)

    txs = [jtx(s) for s in scales]
    jp = [jnp.asarray(p) for p in p0]
    states = [tx.init(p) for tx, p in zip(txs, jp)]
    for step in range(3):
        for p, g in zip(params, grads[step]):
            p.grad = _t(g)
        opt.step()
        for i, tx in enumerate(txs):
            upd, states[i] = tx.update(jnp.asarray(grads[step][i]),
                                       states[i], jp[i])
            jp[i] = optax.apply_updates(jp[i], upd)
    for i, p in enumerate(params):
        np.testing.assert_allclose(_np(p), np.asarray(jp[i]), rtol=0,
                                   atol=1e-6)
        st = states[i][0]
        m, v = opt.state[p]["m"], opt.state[p]["v"]
        assert m.dtype == dtype
        assert_close(m.float().numpy(), np.asarray(st.mu, np.float32), 1e-6,
                     "m")
        assert_close(v.float().numpy(), np.asarray(st.nu, np.float32), 1e-6,
                     "v")


def test_moment_dtype_env(monkeypatch):
    monkeypatch.delenv("EASEVOICE_OPT_STATE", raising=False)
    assert poptim.moment_dtype() == torch.bfloat16
    monkeypatch.setenv("EASEVOICE_OPT_STATE", "fp32")
    assert poptim.moment_dtype() == torch.float32


# ---- gradients: weight norm, K3's backward twins ------------------------------

def _wn_grads_to_flax(prefix, named_grads, **rule_kw):
    out = {}
    for rule in ckpt._wn_rules(prefix, "m", **rule_kw):
        for name, g in named_grads.items():
            hit = rule.try_torch(f"{prefix}.{name}", g)
            if hit is not None:
                out[hit[0]] = hit[1]
    return out


@pytest.mark.parametrize("kind", ["conv", "conv_transpose"])
def test_weight_norm_grads_match_jax(kind):
    """Gradients w.r.t. weight_g / weight_v / bias in training mode equal the
    JAX gradients w.r.t. g / v / bias through _WeightNormKernel (names mapped
    with ``train/ckpt.py _wn_rules``), within 1e-5 relative."""
    rng = np.random.default_rng(10)
    if kind == "conv":
        port = players.WNConv1d(6, 5, 3, dilation=2)
        jmod = jlayers.WNConv1d(6, 5, 3, dilation=2)
        x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    else:
        port = players.WNConvTranspose1d(6, 4, 4, 2, padding=1)
        jmod = jlayers.WNConvTranspose1d(6, 4, 4, 2, padding=1)
        x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    gen = torch.Generator().manual_seed(1)
    port.load_state_dict(convert.random_state_dict(port, gen))
    port.train()
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    params = ckpt.torch_to_flax({f"m.{k}": v for k, v in state.items()},
                                ckpt._wn_rules(r"m", "m", transposed=(
                                    kind != "conv")))[0]["m"]
    y_port = port(_t(x).transpose(1, 2)).transpose(1, 2)
    r = rng.normal(size=tuple(y_port.shape)).astype(np.float32)
    (y_port * _t(r)).sum().backward()
    jg = jax.grad(lambda p: jnp.sum(jmod.apply({"params": p}, x) * r))(
        params)
    want = ckpt.flatten_tree({"m": jg})
    got = _wn_grads_to_flax("m", {n: _np(p.grad) for n, p in
                                  port.named_parameters()},
                            transposed=(kind != "conv"))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], 1e-5, k)


def test_weight_norm_refolds_when_leaving_training():
    conv = players.WNConv1d(4, 4, 3)
    with torch.no_grad():
        conv.weight_g.mul_(2.0)
    conv.train()
    trained = conv.weight.detach().clone()
    assert conv.weight.requires_grad
    conv.eval()
    torch.testing.assert_close(conv.weight, trained)
    assert not conv.weight.requires_grad


def _jax_mrf_conv(w_flax, b, d, x, res):
    """The JAX ResBlock conv (generator.py:31-44 at fold=1) on (B, T, C)."""
    k = w_flax.shape[0]
    pad = (k * d - d) // 2
    y = jax.lax.conv_general_dilated(
        jlayers.leaky_relu(x), w_flax, (1,), [(pad, pad)],
        rhs_dilation=(d,), dimension_numbers=("NHC", "HIO", "NHC")) + b
    return y if res is None else y + res


@pytest.mark.parametrize("d,with_res", [(1, True), (3, False), (5, True)])
def test_mrf_conv_grads_match_jax_vjp(d, with_res):
    """dx (K4 data twin, with exact zeros in x: lrelu'(0) = 1 as in JAX),
    dw and db (K4 weight twin) and d residual through ``mrf_conv`` on the
    CPU against ``jax.vjp``, within 1e-5 relative; the output keeps a
    grad_fn."""
    rng = np.random.default_rng(20 + d)
    c, t, k = 6, 40, 7
    x = rng.normal(size=(2, c, t)).astype(np.float32)
    x[0, :, :5] = 0.0
    w = (rng.normal(size=(c, c, k)) * 0.3).astype(np.float32)
    b = rng.normal(size=(c,)).astype(np.float32)
    res = rng.normal(size=(2, c, t)).astype(np.float32) if with_res else None
    dy = rng.normal(size=(2, c, t)).astype(np.float32)
    ins = [_t(a).requires_grad_() for a in (x, w, b)]
    rt = _t(res).requires_grad_() if with_res else None
    y = mrf.mrf_conv(*ins, d, residual=rt)
    assert y.grad_fn is not None
    y.backward(_t(dy))

    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1)
    args = (jnp.asarray(ckpt.t2f_conv(w)), jnp.asarray(b), tr(x)) + (
        (tr(res),) if with_res else ())
    out, vjp = jax.vjp(lambda wf, bb, xx, *rr: _jax_mrf_conv(
        wf, bb, d, xx, rr[0] if rr else None), *args)
    assert_close(_np(y), np.asarray(out).transpose(0, 2, 1), 1e-5, "y")
    gw, gb, gx, *gr = vjp(tr(dy))
    assert_close(_np(ins[0].grad), np.asarray(gx).transpose(0, 2, 1), 1e-5,
                 "dx")
    assert_close(_np(ins[1].grad), ckpt.f2t_conv(np.asarray(gw)), 1e-5, "dw")
    assert_close(_np(ins[2].grad), gb, 1e-5, "db")
    if with_res:
        assert_close(_np(rt.grad), np.asarray(gr[0]).transpose(0, 2, 1), 0,
                     "dres")


def test_resblock_grads_match_jax(synth):
    """ResBlock1 (six K3 convs) in training mode: gradients w.r.t. its input
    and every weight_g / weight_v / bias against ``jax.vjp`` of the JAX
    ResBlock1, within 1e-4 relative."""
    port, _, params = synth
    block = port.dec.resblocks[1]             # stage 0, k = 7, C = 16
    jblock = jgen.ResBlock1(16, 7, (1, 3, 5))
    jp = params["dec"]["resblock_0_1"]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 50, 16)).astype(np.float32)
    dy = rng.normal(size=(2, 50, 16)).astype(np.float32)
    out, vjp = jax.vjp(lambda p, x: jblock.apply({"params": p}, x), jp, x)
    gp, gx = vjp(jnp.asarray(dy))
    xt = _t(x).transpose(1, 2).contiguous().requires_grad_()
    block.zero_grad()
    y = block(xt)
    assert_close(_np(y.transpose(1, 2)), out, 1e-4, "y")
    y.backward(_t(dy).transpose(1, 2))
    assert_close(_np(xt.grad.transpose(1, 2)), gx, 1e-4, "dx")
    want = ckpt.flatten_tree(gp)
    for j in range(3):
        for conv, name in ((block.convs1[j], f"conv1_{j}"),
                           (block.convs2[j], f"conv2_{j}")):
            assert_close(_np(conv.weight_g.grad).reshape(-1),
                         want[f"{name}/wn/g"], 1e-4, name + " g")
            assert_close(_np(conv.weight_v.grad),
                         ckpt.f2t_conv(want[f"{name}/wn/v"]), 1e-4,
                         name + " v")
            assert_close(_np(conv.bias.grad), want[f"{name}/bias"], 1e-4,
                         name + " bias")


# ---- dropout ------------------------------------------------------------------

def test_dropout_seeded_and_off_in_eval():
    """p > 0 in training: the same seed gives the same masks, another seed
    other masks, no generator raises; eval() and p = 0 apply none."""
    torch.manual_seed(0)
    enc = RelPosEncoder(16, 32, 2, 2, 3, p_dropout=0.1)
    x = torch.randn(2, 16, 9)
    mask = torch.ones(2, 1, 9)
    enc.train()
    a = enc(x, mask, torch.Generator().manual_seed(5))
    b = enc(x, mask, torch.Generator().manual_seed(5))
    c = enc(x, mask, torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 1e-3
    with pytest.raises(ValueError):
        enc(x, mask)
    enc.eval()
    off = enc(x, mask)
    enc.train()
    enc.p_dropout = 0.0
    for m in enc.modules():
        if hasattr(m, "p_dropout"):
            m.p_dropout = 0.0
    torch.testing.assert_close(enc(x, mask), off, rtol=0, atol=0)
    assert (a - off).abs().max() > 1e-3


def test_dropout_masks_as_flax():
    """Keep with probability 1 - p, scale by 1 / (1 - p)."""
    x = torch.ones(20000)
    y = players.dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))


# ---- whole train steps --------------------------------------------------------

def _jax_step_grads(jsynth, jd, hp, mel_cfg):
    """-> jitted fn(pg, pd_before, pd_after, batch, rng) giving the gradients
    ``make_train_step`` takes, recomputed from the same functions: D's at its
    parameters before the step, G's against the updated D.  Returns
    (d_grads, g_grads, losses)."""
    seg_frames = hp.segment_size // mel_cfg.hop_length

    def fn(pg, pd_before, pd_after, batch, rng):
        rngs = {"slice": jax.random.fold_in(rng, 1),
                "latent": jax.random.fold_in(rng, 2),
                "dropout": jax.random.fold_in(rng, 3)}

        def forward(p):
            return jsynth.apply(
                {"params": p}, batch["ssl"], batch["spec"],
                batch["spec_lengths"], batch["text"], batch["text_lengths"],
                rngs=rngs)

        def slices(ids):
            mel = jstft.spec_to_mel(batch["spec"], mel_cfg)
            y_mel = jlayers.slice_segments(mel, ids, seg_frames)
            y = jlayers.slice_segments(batch["wav"][..., None],
                                       ids * mel_cfg.hop_length,
                                       hp.segment_size)
            return y_mel, y

        outs = forward(pg)
        y_mel, y = slices(outs[2])

        def d_loss(pd):
            real_l, fake_l, _, _ = jd.apply(
                {"params": pd}, y, jax.lax.stop_gradient(outs[0]))
            return jlosses.discriminator_loss(real_l, fake_l)[0]

        def g_loss(p):
            y_hat, commit, _, y_mask, latents, _ = forward(p)
            _, z_p, m_p, logs_p, _, logs_q = latents
            y_hat_mel = jstft.mel_spectrogram(y_hat[..., 0], mel_cfg)
            _, fake_l, fmap_r, fmap_g = jd.apply({"params": pd_after}, y,
                                                 y_hat)
            mel = jnp.mean(jnp.abs(y_mel - y_hat_mel)) * hp.c_mel
            kl = jlosses.kl_loss(z_p, logs_q, m_p, logs_p, y_mask) * hp.c_kl
            fm = jlosses.feature_matching_loss(fmap_r, fmap_g)
            adv, _ = jlosses.generator_adv_loss(fake_l)
            total = adv + fm + mel + commit + kl
            return total, {"loss/g/total": total, "loss/g/adv": adv,
                           "loss/g/fm": fm, "loss/g/mel": mel,
                           "loss/g/kl": kl, "loss/g/commit": commit}

        loss_d, d_grads = jax.value_and_grad(d_loss)(pd_before)
        (_, losses), g_grads = jax.value_and_grad(g_loss, has_aux=True)(pg)
        losses = dict(losses, **{"loss/d/total": loss_d})
        return d_grads, g_grads, losses, outs[2], _eps_jnp(outs)

    return jax.jit(fn)


def _eps_jnp(outs):
    z, _, _, _, m_q, logs_q = outs[4]
    return (z - m_q) / jnp.exp(logs_q)


def _assert_grads_close(net, ref, rtol, name):
    """Per tensor: max|d| <= rtol * max|ref| + 1e-6 * (largest gradient of
    the model).  The second term is the rounding floor of gradients that are
    zero in exact arithmetic (an attention key's bias, which the softmax
    cancels), computed near 1e-9 by both frameworks."""
    floor = 1e-6 * max(float(v.abs().max()) for v in ref.values())
    for pname, p in net.named_parameters():
        want = ref[pname]
        if p.grad is None:     # frozen (ssl_proj): JAX's gradient is 0 too
            assert not p.requires_grad and float(want.abs().max()) == 0.0
            continue
        err = float((p.grad - want).abs().max())
        bound = rtol * float(want.abs().max()) + floor
        assert err <= bound, f"{name} {pname}: {err:.3g} > {bound:.3g}"


def _jax_state(gp, dp, hp):
    """``create_train_state`` without the model inits, whose values the test
    replaces anyway (they take half a minute to compile): the same arenas,
    optimizers and state type, from the given parameters."""
    arena_g = arena.build_arena(gp, jstep._text_lr_label)
    arena_d = arena.build_arena(dp)
    packed_g, packed_d = arena.pack(arena_g, gp), arena.pack(arena_d, dp)
    optim_g, optim_d = jstep.make_optimizers(hp, arena_g, arena_d, 1)
    return jstep.S2TrainState(
        step=jnp.zeros((), jnp.int32), params_g=packed_g, params_d=packed_d,
        opt_g=optim_g.init(packed_g), opt_d=optim_d.init(packed_d),
        arena_g=arena_g, arena_d=arena_d)


def test_two_train_steps_match_jax(monkeypatch):
    """Two D-then-G steps of ``S2TrainStep`` against the JAX package's
    ``make_train_step`` under fp32 moments, with the JAX forward's slice
    starts and posterior noise given to the port (dropout is 0 at this
    size).  Per step:

    * every loss of the metrics within 1e-5 relative, both grad norms within
      1e-4 (the JAX step's own norm and the norm of the same gradients
      recomputed by ``_jax_step_grads`` already differ by 2.5e-5);
    * every gradient of G and D against the gradients the JAX step takes
      (recomputed by ``_jax_step_grads``, which reproduces the step's losses
      and grad norms): 1e-4 relative at the first step; 2e-3 for G at the
      second, whose parameters already differ by up to 2 lr where a first
      gradient was ~0 (see below);
    * every parameter after the step within 2.5 lr per step taken, absolute:
      with eps = 1e-9, Adam moves a parameter by about +-lr whatever the
      size of its gradient, so a gradient that is zero up to rounding (the
      key biases) moves it by +-lr in either framework.  The JAX package
      also decays the frozen ssl_proj and codebook by lr * 0.01 * |p| a
      step, which the port (as the reference) does not: far inside this.
    """
    monkeypatch.setenv("EASEVOICE_OPT_STATE", "fp32")
    periods = (2, 3)
    net_g, gp = tiny_sovits_train(seed=12)
    net_d, dp = tiny_mpd(periods, seed=13)
    jsynth = JS(CFG)
    jd = jdisc.MultiPeriodDiscriminator(periods=periods)
    lr = 2e-4
    hp_j = jstep.S2TrainHP(segment_size=2560, learning_rate=lr)
    mel_cfg = jstft.MelConfig()
    batch = _batch(14)
    state = _jax_state(gp, dp, hp_j)
    jax_step = jax.jit(jstep.make_train_step(jsynth, jd, hp_j, mel_cfg,
                                             steps_per_epoch=1))
    replica = _jax_step_grads(jsynth, jd, hp_j, mel_cfg)
    port_step = pstep.S2TrainStep(
        net_g, net_d, pstep.S2TrainHP(segment_size=2560, learning_rate=lr),
        pstft.MelConfig(), steps_per_epoch=1)
    tbatch = _torch_batch(batch)
    for i in range(2):
        rng = jax.random.PRNGKey(100 + i)
        pg = jstep.params_tree(state, "g")
        pd = jstep.params_tree(state, "d")
        state, metrics = jax_step(state, batch, rng)
        d_grads, g_grads, losses, ids, eps = replica(
            pg, pd, jstep.params_tree(state, "d"), batch, rng)
        got = port_step(tbatch, ids_slice=_t(np.asarray(ids), torch.int64),
                        eps=_t(np.asarray(eps)))
        for k, v in losses.items():
            assert_close(float(v), float(metrics[k]), 1e-5, "replica " + k)
            assert_close(float(got[k]), float(metrics[k]), 1e-5, k)
        for k, tree in (("grad_norm/g", g_grads), ("grad_norm/d", d_grads)):
            assert_close(float(optax.global_norm(tree)), float(metrics[k]),
                         1e-4, "replica " + k)
            assert_close(float(got[k]), float(metrics[k]), 1e-4, k)
        _assert_grads_close(net_g, convert.sovits_state_dict(g_grads, True),
                            1e-4 if i == 0 else 2e-3, f"step {i} G")
        _assert_grads_close(net_d, convert.discriminator_state_dict(
            d_grads, periods), 1e-4, f"step {i} D")
        cb = ckpt.flatten_tree(g_grads)["quantizer/codebooks"]
        assert float(np.abs(cb).max()) == 0.0
        for net, ref in (
                (net_g, convert.sovits_state_dict(
                    jstep.params_tree(state, "g"), True)),
                (net_d, convert.discriminator_state_dict(
                    jstep.params_tree(state, "d"), periods))):
            sd = net.state_dict()
            assert set(sd) == set(ref)
            for k, v in ref.items():
                np.testing.assert_allclose(
                    _np(sd[k]), v.numpy(), rtol=0, atol=2.5 * lr * (i + 1),
                    err_msg=f"step {i} {k}")


# ---- the driver -----------------------------------------------------------------


def test_sovits_train_end_to_end_on_cpu(workspace, capsys):
    """SovitsTrain.train() for one epoch at the tiny size (the JAX driver's
    fixture: 3 clips replicated to 99 items, batch 8): finite losses, a
    deployable export that loads ``strict=True`` into the inference build,
    resume files that a second run picks up, loss lines on the connector,
    and Generator ResBlock weights that moved."""
    norm, project = workspace
    params = ptrain.SovitsTrainParams(
        batch_size=8, total_epochs=1, save_every_epoch=1,
        train_input_dir=norm, output_model_name="tiny", project_dir=project)
    trainer = ptrain.SovitsTrain(params)
    assert trainer.model_cfg == SovitsConfig.from_json_dict(TINY_S2)
    history = []
    resp = trainer.train(on_step=lambda step, m: history.append(
        (step, {k: float(v) for k, v in m.items()})))
    assert resp.ok, resp.message
    assert [s for s, _ in history] == list(range(1, len(history) + 1))
    assert len(history) == resp.data["global_step"] == 13
    assert all(np.isfinite(v) for _, m in history for v in m.values())
    assert len(trainer.step_seconds) == 13
    assert "loss-of-easevoice" in capsys.readouterr().out

    path = resp.data["model_path"]
    assert path.endswith("tiny_e1_s13.pth")
    obj = torch.load(path, map_location="cpu", weights_only=False)
    assert set(obj) >= {"weight", "config", "info"}
    assert obj["weight"]["enc_p.text_embedding.weight"].dtype == torch.float16
    model = SynthesizerTrn(trainer.model_cfg)
    model.load_state_dict({k: v.float() for k, v in obj["weight"].items()},
                          strict=True)
    logs = trainer.train_logs_dir
    for name in ("G_latest.pth", "D_latest.pth", "resume.json"):
        assert os.path.exists(os.path.join(logs, name))

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(trainer.seed)
        init = SynthesizerTrn(trainer.model_cfg, with_enc_q=True)
    trained = trainer.step_fn.net_g.state_dict()
    for k, v in init.state_dict().items():
        if k.startswith("dec.resblocks.") and k.endswith("weight_v"):
            assert not torch.equal(trained[k], v), k

    again = ptrain.SovitsTrain(params)
    resp2 = again.train()
    assert resp2.ok and resp2.data["global_step"] == 13
    assert again.step_seconds == []
    for k, v in again.step_fn.net_g.state_dict().items():
        torch.testing.assert_close(v, trained[k], rtol=0, atol=0)


_NO_JAX_S2 = r"""
import importlib, pkgutil, sys
import torch
import easevoice_trainer_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
from easevoice_trainer_tpu_torch.models.sovits import (
    MultiPeriodDiscriminator, SovitsConfig, SynthesizerTrn)
from easevoice_trainer_tpu_torch.ops.stft import MelConfig, spectrogram
from easevoice_trainer_tpu_torch.train.sovits_step import S2TrainHP, \
    S2TrainStep
cfg = SovitsConfig(spec_channels=1025, segment_size=2560, inter_channels=16,
                   hidden_channels=16, filter_channels=32, n_heads=2,
                   n_layers=2, upsample_initial_channel=32, gin_channels=16,
                   ssl_dim=32, p_dropout=0.1)
gen = torch.Generator().manual_seed(0)
wav = torch.rand((2, 10240), generator=gen) - 0.5
batch = {"ssl": torch.randn((2, 16, 32), generator=gen),
         "spec": spectrogram(wav), "spec_lengths": torch.tensor([16, 12]),
         "wav": wav, "text": torch.randint(1, 700, (2, 5), generator=gen),
         "text_lengths": torch.tensor([5, 3])}
step = S2TrainStep(SynthesizerTrn(cfg, with_enc_q=True),
                   MultiPeriodDiscriminator((2,)),
                   S2TrainHP(segment_size=2560), MelConfig())
m = step(batch, gen)
assert all(torch.isfinite(v) for v in m.values())
print(sorted(m for m in ("jax", "flax", "optax", "yaml", "psutil")
             if m in sys.modules))
"""


def test_port_imports_and_trains_without_jax_subprocess():
    """Every module of the port imports, and one train step (dropout on,
    randomness from the generator) runs, in a fresh interpreter that loads
    no jax, flax, optax, yaml or psutil (the card's machine has none)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_S2], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout
