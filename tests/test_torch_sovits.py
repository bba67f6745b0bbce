"""Parity of the PyTorch port's SoVITS inference modules with the JAX
package: K3's twin inside ResBlock1 (unfolded and at the Generator's folded
width), the Generator, TextEncoder (speed 1 and 1.25), flow reverse,
MelStyleEncoder, the quantizer and SynthesizerTrn.decode / extract_latent.
fp32 on the CPU; each tolerance is relative to the reference's largest
magnitude (1e-4 for one block, 2e-4 through a whole model: the frameworks
sum convs and matmuls in different orders, and the JAX Generator runs its
narrow stages space-to-depth folded)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from easevoice_trainer_tpu.models.sovits import generator as jgen
from easevoice_trainer_tpu.models.sovits import synthesizer as jsyn
from easevoice_trainer_tpu_torch.models.sovits import synthesizer as psyn
from easevoice_trainer_tpu_torch.nn.layers import WNConv1d

from _torch_port_tiny import SOVITS_KW, assert_close, tiny_sovits

JS = jsyn.SynthesizerTrn


@pytest.fixture(scope="module")
def sovits():
    port, params, state = tiny_sovits()
    return port, JS(jsyn.SovitsConfig(**SOVITS_KW)), params, state


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def _apply(jmodel, params, fn, *args):
    return jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, method=fn))(
        params, *args)


def test_convert_roundtrip_is_exact(sovits):
    port, _, _, state = sovits
    got = port.state_dict()
    assert set(got) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_sovits_config_matches_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jsyn.SovitsConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(psyn.SovitsConfig)]
    assert jf == pf
    d = {"model": {"hidden_channels": 96, "resblock_dilation_sizes":
                   [[1, 2], [3, 4]]}, "data": {"filter_length": 1024}}
    assert (dataclasses.asdict(psyn.SovitsConfig.from_json_dict(d))
            == dataclasses.asdict(jsyn.SovitsConfig.from_json_dict(d)))


def test_weight_norm_folds_at_load(sovits):
    port, _, _, _ = sovits
    conv = port.dec.resblocks[4].convs1[2]
    assert isinstance(conv, WNConv1d)
    v = conv.weight_v
    want = conv.weight_g * v / v.flatten(1).norm(dim=1)[:, None, None]
    torch.testing.assert_close(conv.weight, want)
    assert "weight" not in dict(conv.state_dict())


@pytest.mark.parametrize("fold", [1, 8])
@pytest.mark.parametrize("block", [0, 2])
def test_resblock1_mrf_twin_vs_jax(sovits, fold, block):
    """K3's twin (two launches per dilation step) against the JAX ResBlock1
    at fold=1 and at fold=8, the width the Generator uses for C=16."""
    port, _, params, _ = sovits
    k = (3, 7, 11)[block]
    jblock = jgen.ResBlock1(16, k, (1, 3, 5), fold=fold)
    x = np.random.default_rng(block).normal(0, 1, (2, 200, 16)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jblock.apply({"params": p}, x))(
        params["dec"][f"resblock_0_{block}"], x)
    with torch.no_grad():
        got = port.dec.resblocks[block](_t(x).transpose(1, 2))
    assert_close(got.transpose(1, 2).numpy(), want, 1e-4, "resblock")


def test_generator_matches_jax(sovits):
    port, jmodel, params, _ = sovits
    rng = np.random.default_rng(2)
    z = rng.normal(0, 1, (2, 12, 32)).astype(np.float32)
    g = rng.normal(0, 1, (1, 1, 32)).astype(np.float32)
    want = _apply(jmodel, params, lambda m, z, g: m.dec(z, g), z, g)
    with torch.no_grad():
        got = port.dec(_t(z).transpose(1, 2), _t(g).transpose(1, 2))
    assert_close(got.transpose(1, 2).numpy(), want, 2e-4, "generator")


@pytest.mark.parametrize("speed", [1.0, 1.25])
def test_text_encoder_matches_jax(sovits, speed):
    port, jmodel, params, _ = sovits
    rng = np.random.default_rng(3)
    y = rng.normal(0, 1, (2, 24, 64)).astype(np.float32)
    y_lens = np.array([24, 15], np.int32)
    text = rng.integers(1, 700, (2, 10)).astype(np.int32)
    t_lens = np.array([10, 6], np.int32)
    ge = rng.normal(0, 1, (1, 1, 32)).astype(np.float32)
    want = jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a,
        method=lambda m, *a: m.enc_p(*a, speed=speed)))(
            params, y, y_lens, text, t_lens, ge)
    with torch.no_grad():
        got = port.enc_p(_t(y).transpose(1, 2), _t(y_lens, torch.int64),
                         _t(text, torch.int64), _t(t_lens, torch.int64),
                         _t(ge).transpose(1, 2), speed=speed)
    for name, g_, w_ in zip(("y", "m_p", "logs_p", "mask"), got, want):
        assert_close(g_.transpose(1, 2).numpy(), w_, 1e-4, name)


def test_flow_reverse_matches_jax(sovits):
    port, jmodel, params, _ = sovits
    rng = np.random.default_rng(4)
    z = rng.normal(0, 1, (2, 20, 32)).astype(np.float32)
    mask = (np.arange(20)[None, :, None] < np.array([20, 13])[:, None, None]
            ).astype(np.float32)
    g = rng.normal(0, 1, (1, 1, 32)).astype(np.float32)
    want = _apply(jmodel, params,
                  lambda m, z, mk, g: m.flow(z, mk, g=g, reverse=True),
                  z, mask, g)
    with torch.no_grad():
        got = port.flow(_t(z).transpose(1, 2), _t(mask).transpose(1, 2),
                        g=_t(g).transpose(1, 2), reverse=True)
    assert_close(got.transpose(1, 2).numpy(), want, 1e-4, "flow")


def test_mel_style_encoder_matches_jax(sovits):
    port, jmodel, params, _ = sovits
    rng = np.random.default_rng(5)
    spec = rng.random((2, 30, 1025)).astype(np.float32)
    mask = (np.arange(30)[None, :, None] < np.array([30, 21])[:, None, None]
            ).astype(np.float32)
    want = _apply(jmodel, params, JS._style, spec, mask)
    with torch.no_grad():
        got = port._style(_t(spec), _t(mask))
    assert_close(got.numpy(), want, 1e-4, "style")


def test_quantizer_and_extract_latent_match_jax(sovits):
    port, jmodel, params, _ = sovits
    rng = np.random.default_rng(6)
    ssl = rng.normal(0, 1, (2, 32, 64)).astype(np.float32)
    want = _apply(jmodel, params, JS.extract_latent, ssl)
    with torch.no_grad():
        got = port.extract_latent(_t(ssl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    codes = np.asarray(want)[None]
    want_q = _apply(jmodel, params, lambda m, c: m.quantizer.decode(c), codes)
    got_q = port.quantizer.decode(_t(codes, torch.int64))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))


def test_synthesizer_decode_matches_jax(sovits):
    port, jmodel, params, _ = sovits
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 1024, (2, 16)).astype(np.int32)
    codes_lens = np.array([16, 11], np.int32)
    text = rng.integers(1, 700, (2, 16)).astype(np.int32)
    t_lens = np.array([16, 9], np.int32)
    refer = rng.random((1, 40, 1025)).astype(np.float32)
    r_lens = np.array([40], np.int32)
    want = jax.jit(lambda p, c, t, tl, r, rl, cl: jmodel.apply(
        {"params": p}, c, t, tl, r, rl, codes_lengths=cl,
        method=JS.decode))(params, codes, text, t_lens, refer, r_lens,
                           codes_lens)
    with torch.no_grad():
        got = port.decode(_t(codes, torch.int64), _t(text, torch.int64),
                          _t(t_lens, torch.int64), _t(refer),
                          _t(r_lens, torch.int64),
                          codes_lengths=_t(codes_lens, torch.int64))
    assert got.shape == want.shape == (2, 16 * 2 * 640, 1)
    assert_close(got.numpy(), want, 2e-4, "decode")
