"""The port's MDX-Net, BS-Roformer and Mel-Band Roformer separators
(audiokit/mdxnet.py, audiokit/bs_roformer.py) against the JAX package's, on
the CPU with seeded random weights in the released key layouts, at
tests/test_mdxnet.py's SMALL config and tests/test_uvr5.py's tiny
BS-Roformer (``_torch_uvr5_tiny``).  The Roformers' attention runs
``encoder_attention``'s plain twin here.

Tolerances: each net's output and each separator's stems within 1e-5 of
the largest JAX magnitude (fp32; the convolutions, GEMMs and the
attention sum in another order); the weight converters' round trips
exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easevoice_trainer_tpu.audiokit import bs_roformer as jbs
from easevoice_trainer_tpu.audiokit import mdxnet as jmdx
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch.audiokit import bs_roformer as pbs
from easevoice_trainer_tpu_torch.audiokit import mdxnet as pmdx
from easevoice_trainer_tpu_torch.audiokit import uvr5 as puvr5
from easevoice_trainer_tpu_torch.ops import attention

from _torch_port_tiny import assert_close
from _torch_uvr5_tiny import (BS, MDX, MEL, Reads, jax_config, numpy_state,
                              random_state, stereo_clip)

TOL = 1e-5

JMDX = jax_config(jmdx.MDXConfig, MDX)
JBS = jax_config(jbs.BSRoformerConfig, BS)
JMEL = jax_config(jbs.MelBandRoformerConfig, MEL)


@functools.lru_cache(maxsize=None)
def _jax_apply(kind: str):
    """The JAX net's jitted apply, one a net for the whole module."""
    model = {"mdx": lambda: jmdx.ConvTDFNet(JMDX),
             "bs": lambda: jbs.BSRoformer(JBS),
             "mel": lambda: jbs.MelBandRoformer(JMEL)}[kind]()
    return jax.jit(model.apply)


def _mdx_state(seed=0, cfg=MDX):
    return random_state(pmdx.ConvTDFNet(cfg), seed)


# ---- MDX-Net ----------------------------------------------------------------

def test_mdx_config_matches_jax():
    assert jax_config(jmdx.MDXConfig, pmdx.MDXConfig()) == jmdx.MDXConfig()
    assert pmdx.MDXConfig().chunk_size == jmdx.MDXConfig().chunk_size


@pytest.mark.parametrize("norm,bias", [("group", False), ("batch", True)])
def test_mdx_net_matches_jax(norm, bias):
    """ConvTDFNet in the reference's (B, dim_c, dim_f, dim_t) layout, with
    GroupNorm(2, C) (the released config) and with BatchNorm and biased
    TDF layers; the config inferred from the weights by both packages."""
    cfg = pmdx.MDXConfig(**{**MDX.__dict__, "norm": norm, "bias": bias})
    state = _mdx_state(seed=1, cfg=cfg)
    shape = dict(dim_f=cfg.dim_f, dim_t=cfg.dim_t, n_fft=cfg.n_fft)
    inferred = pmdx.infer_mdx_config(state, **shape)
    assert jax_config(jmdx.MDXConfig, inferred) == \
        jmdx.infer_mdx_config(numpy_state(state), **shape)
    assert inferred == pmdx.MDXConfig(**{**cfg.__dict__, "hop": 1024})
    params, stats = jmdx.convert_mdx_weights(numpy_state(state),
                                             jax_config(jmdx.MDXConfig, cfg))
    x = np.random.default_rng(2).normal(
        size=(2, cfg.dim_c, cfg.dim_f, cfg.dim_t)).astype(np.float32)
    variables = {"params": params, **({"batch_stats": stats} if stats
                                      else {})}
    want = jmdx.ConvTDFNet(jax_config(jmdx.MDXConfig, cfg)).apply(
        variables, jnp.asarray(x.transpose(0, 3, 2, 1)))
    net = puvr5.load_net(pmdx.ConvTDFNet(cfg), state, "cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert_close(got, np.asarray(want).transpose(0, 3, 2, 1), TOL, "mdx")


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_mdx_state_dict_round_trips_and_loads_strict(norm):
    cfg = pmdx.MDXConfig(**{**MDX.__dict__, "norm": norm})
    state = _mdx_state(seed=3, cfg=cfg)
    reads = Reads(numpy_state(state))
    back = convert.mdx_state_dict(*jmdx.convert_mdx_weights(
        reads, jax_config(jmdx.MDXConfig, cfg)))
    assert back.keys() == state.keys() == reads.read
    for k in state:
        assert torch.equal(back[k], state[k]), k
    module = pmdx.ConvTDFNet(cfg)
    assert {k for k in module.state_dict()
            if not k.endswith("num_batches_tracked")} == reads.read
    module.load_state_dict(back, strict=True)


def test_mdx_separator_matches_jax():
    """``MDXSeparator.separate`` on a 2.3 s stereo clip in 1 s segments with
    0.1 s margins (three segments, 13-14 windows each) and the ``denoise``
    pass (net(x) and net(-x) in one batch here, two calls in JAX)."""
    state = _mdx_state(seed=4)
    params, stats = jmdx.convert_mdx_weights(numpy_state(state), JMDX)
    kw = dict(chunks=1, margin=4410, denoise=True)
    jsep = jmdx.MDXSeparator.from_params(params, stats, JMDX, **kw)
    jsep._apply = _jax_apply("mdx")
    psep = pmdx.MDXSeparator.from_state(state, MDX, "cpu", **kw)
    wav = stereo_clip(2.3, seed=5)
    jv, ji = jsep.separate(wav, 44100)
    pv, pi = psep.separate(wav, 44100)
    assert pv.shape == jv.shape == wav.shape
    assert_close(pi, ji, TOL, "instrument")
    assert_close(pv, jv, TOL, "vocal")
    np.testing.assert_allclose(pv + pi, wav, rtol=0, atol=1e-6)


def test_mdx_reads_onnx_initializers(tmp_path):
    """An ``.onnx`` whose initializers carry the torch names loads through
    the copied protobuf reader; one without them raises."""
    state = _mdx_state(seed=6)
    blob = _onnx_with(state)
    (tmp_path / "m.onnx").write_bytes(blob)
    got = pmdx.MDXSeparator._load_state(str(tmp_path / "m.onnx"))
    assert got.keys() == state.keys()
    for k in state:
        assert torch.equal(got[k], state[k]), k
    (tmp_path / "bad.onnx").write_bytes(_onnx_with({"w": state[
        "first_conv.0.weight"]}))
    with pytest.raises(ValueError):
        pmdx.MDXSeparator._load_state(str(tmp_path / "bad.onnx"))


def _onnx_with(state) -> bytes:
    """A ModelProto holding only ``state`` as float initializers (raw)."""
    def varint(n):
        out = b""
        while True:
            b = n & 0x7F
            n >>= 7
            out += bytes([b | (0x80 if n else 0)])
            if not n:
                return out

    def field(num, payload):
        return varint(num << 3 | 2) + varint(len(payload)) + payload

    graph = b""
    for name, v in state.items():
        a = v.numpy().astype("<f4")
        tensor = b"".join(varint(1 << 3) + varint(d) for d in a.shape)
        tensor += varint(2 << 3) + varint(1)
        tensor += field(8, name.encode()) + field(9, a.tobytes())
        graph += field(5, tensor)
    return field(7, graph)


# ---- BS-Roformer and Mel-Band Roformer --------------------------------------

NETS = {"bs": (pbs.BSRoformer, BS, jbs.convert_bs_roformer, JBS,
               convert.bs_roformer_state_dict, 18),
        "mel": (pbs.MelBandRoformer, MEL, jbs.convert_mel_band_roformer,
                JMEL, convert.mel_band_roformer_state_dict, 34)}


def _roformer_state(kind, seed):
    net_cls, cfg = NETS[kind][:2]
    return random_state(net_cls(cfg), seed)


def test_roformer_configs_match_jax():
    assert jax_config(jbs.BSRoformerConfig, pbs.BSRoformerConfig()) == \
        jbs.BSRoformerConfig()
    assert jax_config(jbs.MelBandRoformerConfig,
                      pbs.MelBandRoformerConfig()) == \
        jbs.MelBandRoformerConfig()


@pytest.mark.parametrize("kind", ["bs", "mel"])
def test_roformer_net_matches_jax(kind):
    """The whole net (band split, 2 axial time / frequency blocks with the
    attention through ``encoder_attention``'s twin, the mask estimator; for
    Mel-Band the gather and the band-count average) on a folded stereo
    spec of 7 frames."""
    net_cls, cfg, jconvert, jcfg, _, fs = NETS[kind]
    state = _roformer_state(kind, seed=7)
    params = jconvert(numpy_state(state), jcfg)
    x = np.random.default_rng(8).normal(size=(1, fs, 7, 2)).astype(
        np.float32)
    want = _jax_apply(kind)({"params": params}, jnp.asarray(x))
    net = puvr5.load_net(net_cls(cfg), state, "cpu")
    before = attention.encoder_attention.launches
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert attention.encoder_attention.launches == before   # the twin ran
    assert_close(got, np.asarray(want), TOL, kind)


@pytest.mark.parametrize("kind", ["bs", "mel"])
def test_roformer_state_dict_round_trips_and_loads_strict(kind):
    net_cls, cfg, jconvert, jcfg, to_torch, _ = NETS[kind]
    state = _roformer_state(kind, seed=9)
    reads = Reads(numpy_state(state))
    back = to_torch(jconvert(reads, jcfg))
    assert back.keys() == state.keys() == reads.read
    for k in state:
        assert torch.equal(back[k], state[k]), k
    net_cls(cfg).load_state_dict(back, strict=True)


def test_roformer_checkpoint_drops_rotary_freqs(tmp_path):
    """A released checkpoint's ``rotary_embed.freqs`` (recomputed here) are
    dropped; the rest loads strict."""
    state = _roformer_state("bs", seed=10)
    blob = dict(state)
    blob["layers.0.0.layers.0.0.rotary_embed.freqs"] = torch.ones(4)
    torch.save({"state_dict": blob}, tmp_path / "m.ckpt")
    got = pbs.read_roformer_state(str(tmp_path / "m.ckpt"))
    assert got.keys() == state.keys()
    puvr5.load_net(pbs.BSRoformer(BS), got, "cpu")


@pytest.mark.parametrize("kind", ["bs", "mel"])
def test_roformer_separator_matches_jax(kind):
    """``separate`` on a 0.05 s stereo clip with the chunk cut to 800
    samples (fades of 80): four chunks whose fades overlap; vocal + instrument
    is the mix."""
    net_cls, cfg, jconvert, jcfg, _, _ = NETS[kind]
    state = _roformer_state(kind, seed=11)
    jcls = (jbs.BSRoformerSeparator if kind == "bs"
            else jbs.MelBandRoformerSeparator)
    jsep = jcls.from_params(jconvert(numpy_state(state), jcfg), jcfg)
    jsep._apply = _jax_apply(kind)
    pcls = (pbs.BSRoformerSeparator if kind == "bs"
            else pbs.MelBandRoformerSeparator)
    psep = pcls.from_state(state, cfg, "cpu")
    for sep in (jsep, psep):
        sep.CHUNK, sep.FADE = 800, 80
    wav = stereo_clip(0.05, seed=12)
    jv, ji = jsep.separate(wav, 44100)
    pv, pi = psep.separate(wav, 44100)
    assert pv.shape == jv.shape == wav.shape
    assert_close(pv, jv, TOL, "vocal")
    assert_close(pi, ji, TOL, "instrument")
    np.testing.assert_allclose(pv + pi, wav, rtol=0, atol=1e-6)
