"""The port's VR and DeEcho separators (audiokit/uvr5.py,
audiokit/uvr5_deecho.py), ``get_separator``, ``AudioService.uvr5`` and
``cmd/audio_uvr5.py`` against the JAX package's, on the CPU with seeded
random weights in the released key layouts (``_torch_uvr5_tiny``).

Tolerances: each net's output and each separator's stems within 1e-5 of
the largest JAX magnitude (fp32; the convolutions and the LSTM sum in
another order); the weight converters' round trips exact; the service's
written stems (int16 wav) within 1 LSB.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easevoice_trainer_tpu import native as jnative
from easevoice_trainer_tpu.audiokit import uvr5 as juvr5
from easevoice_trainer_tpu.audiokit import uvr5_deecho as jdeecho
from easevoice_trainer_tpu.service import audio as jaudio
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch import native as pnative
from easevoice_trainer_tpu_torch.audiokit import uvr5 as puvr5
from easevoice_trainer_tpu_torch.audiokit import uvr5_deecho as pdeecho
from easevoice_trainer_tpu_torch.cmd import audio_uvr5
from easevoice_trainer_tpu_torch.service import audio as paudio
from easevoice_trainer_tpu_torch.utils import audio_io, paths

import chip_smoke
from _torch_port_tiny import assert_close
from _torch_uvr5_tiny import (DEECHO, N_FFT, VR, Reads, band_params,
                              deecho_state, numpy_state, stereo_clip,
                              vr_state)

TOL = 1e-5


@pytest.fixture(autouse=True)
def scipy_resampling(monkeypatch):
    """Both packages resample with scipy (the native libraries may differ
    in which one is built)."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(pnative, "_lib", None)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's torch runs on one thread here: oneDNN's CPU LSTM (the
    DeEcho net's) takes ~1 s on its first call with eight threads, and
    minutes when the cores are shared by several test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mag(seed, n):
    """n windows of the separators' shape (2, 65, 512), so that the JAX
    ops compiled here serve the separator tests too."""
    return np.random.default_rng(seed).uniform(
        0, 1, (n, 2, N_FFT // 2 + 1, 512)).astype(np.float32)


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


@functools.lru_cache(maxsize=None)
def _jax_apply(deecho: bool, enlarge: bool = False):
    """The JAX net's jitted apply, one a net for the whole module."""
    model = (jdeecho.CascadedNet(n_fft=N_FFT, **DEECHO) if deecho else
             juvr5.CascadedASPPNet(n_fft=N_FFT, enlarge=enlarge, **VR))
    return jax.jit(model.apply)


# ---- the nets ---------------------------------------------------------------

@pytest.mark.parametrize("enlarge", [False, True])
def test_vr_net_matches_jax(enlarge):
    """CascadedASPPNet at n_fft 128, ch 4 / 2 / 4 (with the 4th and 5th ASPP
    branches when ``enlarge``), its layout inferred from the weights."""
    state = vr_state(seed=3, enlarge=enlarge)
    params, stats, layout = juvr5.convert_vr_weights(numpy_state(state))
    assert puvr5.infer_vr_layout(state) == layout == dict(VR,
                                                          enlarge=enlarge)
    net = puvr5.load_net(puvr5.CascadedASPPNet(N_FFT, **layout), state, "cpu")
    x = _mag(1, 3)
    want = _jax_apply(False, enlarge)(
        {"params": params, "batch_stats": stats}, _nhwc(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert_close(got, np.asarray(want).transpose(0, 3, 1, 2), TOL, "vr")


def test_deecho_net_matches_jax():
    """CascadedNet at n_fft 128, nout 8, LSTM 16: the mask."""
    state = deecho_state(seed=4)
    params, stats = jdeecho.convert_deecho_weights(numpy_state(state))
    net = puvr5.load_net(pdeecho.CascadedNet(N_FFT, **DEECHO), state, "cpu")
    x = _mag(2, 2)
    want = _jax_apply(True)(
        {"params": params, "batch_stats": stats}, _nhwc(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert_close(got, np.asarray(want).transpose(0, 3, 1, 2), TOL, "deecho")


@pytest.mark.parametrize("enlarge", [False, True])
def test_vr_state_dict_round_trips_and_loads_strict(enlarge):
    """torch state -> the JAX ``convert_vr_weights`` -> ``vr_state_dict``:
    the same keys and tensors, and the port's module keys (without
    BatchNorm's counters) are exactly the keys the JAX converter reads."""
    state = vr_state(seed=5, enlarge=enlarge)
    reads = Reads(numpy_state(state))
    params, stats, _ = juvr5.convert_vr_weights(reads)
    back = convert.vr_state_dict(params, stats)
    assert back.keys() == state.keys() == reads.read
    for k in state:
        assert torch.equal(back[k], state[k]), k
    module = puvr5.CascadedASPPNet(N_FFT, enlarge=enlarge, **VR)
    assert {k for k in module.state_dict()
            if not k.endswith("num_batches_tracked")} == reads.read
    module.load_state_dict(back, strict=True)


def test_deecho_state_dict_round_trips_and_loads_strict():
    """As the VR test; the JAX LSTM cell keeps torch's two biases summed,
    so the round trip gives bias_ih + bias_hh in bias_ih and zero in
    bias_hh."""
    state = deecho_state(seed=6)
    reads = Reads(numpy_state(state))
    back = convert.deecho_state_dict(*jdeecho.convert_deecho_weights(reads))
    assert back.keys() == state.keys() == reads.read
    for k in state:
        if ".bias_hh_l0" in k:
            assert not back[k].any(), k
        elif ".bias_ih_l0" in k:
            hh = k.replace("bias_ih", "bias_hh")
            assert torch.equal(back[k], state[k] + state[hh]), k
        else:
            assert torch.equal(back[k], state[k]), k
    module = pdeecho.CascadedNet(N_FFT, **DEECHO)
    assert {k for k in module.state_dict()
            if not k.endswith("num_batches_tracked")} == reads.read
    module.load_state_dict(back, strict=True)


def test_released_checkpoint_keys_load_strict(tmp_path):
    """A checkpoint saved as torch saves a trained net (with BatchNorm's
    ``num_batches_tracked``) loads through ``read_state`` strict."""
    module = puvr5.CascadedASPPNet(N_FFT, **VR)
    full = module.state_dict()
    full.update(vr_state(seed=7))
    torch.save(full, tmp_path / "m.pth")
    state = puvr5.read_state(str(tmp_path / "m.pth"))
    assert not any(k.endswith("num_batches_tracked") for k in state)
    puvr5.load_net(puvr5.CascadedASPPNet(N_FFT, **VR), state, "cpu")


# ---- the separators ---------------------------------------------------------

def _jax_vr(state, mp, agg, tta, deecho=False):
    sep = juvr5.VRSeparator.__new__(juvr5.VRSeparator)
    sep.mp, sep.agg, sep.tta = mp, agg, tta
    if deecho:
        params, stats = jdeecho.convert_deecho_weights(numpy_state(state))
        sep._apply = lambda v, x: _jax_apply(True)(v, x) * x
        sep.OFFSET = 64                         # JAX DeEchoSeparator's
    else:
        params, stats, _ = juvr5.convert_vr_weights(numpy_state(state))
        sep._apply = _jax_apply(False)
    sep.variables = {"params": params, "batch_stats": stats}
    return sep


def _port_vr(state, mp, agg, tta, deecho=False):
    cls = puvr5.DeEchoSeparator if deecho else puvr5.VRSeparator
    sep = cls.__new__(cls)
    sep.device, sep.mp, sep.agg, sep.tta = torch.device("cpu"), mp, agg, tta
    net = (pdeecho.CascadedNet(N_FFT, **DEECHO) if deecho
           else puvr5.CascadedASPPNet(N_FFT, **VR))
    sep.net = puvr5.load_net(net, state, "cpu")
    return sep


@pytest.mark.parametrize("agg,tta", [(0, False), (10, True)])
def test_vr_separator_matches_jax(agg, tta):
    """``VRSeparator.separate`` on a 1.6 s stereo clip over a 3-band
    config of 64 bins (600 frames: three 512-frame windows in one batch),
    with and without the mask power and the shifted second pass."""
    state = vr_state(seed=8)
    wav = stereo_clip(1.6, seed=9)
    jv, ji = _jax_vr(state, band_params(), agg, tta).separate(wav, 44100)
    pv, pi = _port_vr(state, band_params(), agg, tta).separate(wav, 44100)
    assert pv.shape == jv.shape and pv.shape[0] == 2
    assert_close(pv, jv, TOL, "vocal")
    assert_close(pi, ji, TOL, "instrument")


def test_deecho_separator_matches_jax():
    """``DeEchoSeparator``'s mask * input, 64-frame offset and no mask
    power, on the same clip and band config."""
    state = deecho_state(seed=10)
    wav = stereo_clip(1.6, seed=11)
    jv, ji = _jax_vr(state, band_params(), 0, False, True).separate(
        wav, 44100)
    pv, pi = _port_vr(state, band_params(), 0, False, True).separate(
        wav, 44100)
    assert_close(pv, jv, TOL, "vocal")
    assert_close(pi, ji, TOL, "instrument")


# ---- get_separator, the service and the cmd ---------------------------------

def _weights_root(tmp_path, monkeypatch):
    monkeypatch.setenv("EASEVOICE_BASE_PATH", str(tmp_path / "base"))
    root = tmp_path / "base" / "models" / "uvr5_weights"
    root.mkdir(parents=True, exist_ok=True)
    assert puvr5.weights_root() == str(root)
    return root


@pytest.mark.parametrize("model_name,file_name,family", [
    ("HP5_only_main_vocal", "HP5_only_main_vocal.pth", "VRSeparator"),
    ("VR-DeEchoNormal", "VR-DeEchoNormal.pth", "DeEchoSeparator"),
    ("UVR-MDX-NET-Inst", "UVR-MDX-NET-Inst.onnx", "MDXSeparator"),
    ("UVR-MDX-NET-Inst", "vocals.onnx", "MDXSeparator"),
    ("onnx_dereverb_By_FoxJoy", "onnx_dereverb_By_FoxJoy/vocals.onnx",
     "MDXSeparator"),
    ("model_bs_roformer_ep_317", "model_bs_roformer_ep_317.ckpt",
     "BSRoformerSeparator"),
    ("mel_band_roformer_vocals", "mel_band_roformer_vocals.pth",
     "MelBandRoformerSeparator"),
])
def test_get_separator_dispatch(tmp_path, monkeypatch, model_name,
                                file_name, family):
    """The JAX dispatcher's name rules and file candidates, each family
    built with the path found and the device asked for."""
    from easevoice_trainer_tpu_torch.audiokit import bs_roformer, mdxnet

    root = _weights_root(tmp_path, monkeypatch)
    (root / file_name).parent.mkdir(parents=True, exist_ok=True)
    (root / file_name).write_bytes(b"")
    built = {}

    def stub(name):
        def make(path, device="cuda"):
            built.update(family=name, path=path, device=device)
        return make

    for mod, name in ((puvr5, "VRSeparator"), (puvr5, "DeEchoSeparator"),
                      (mdxnet, "MDXSeparator"),
                      (bs_roformer, "BSRoformerSeparator"),
                      (bs_roformer, "MelBandRoformerSeparator")):
        monkeypatch.setattr(mod, name, stub(name))
    puvr5.get_separator(model_name, "cpu")
    assert built == dict(family=family, path=str(root / file_name),
                         device="cpu")
    os.remove(root / file_name)
    with pytest.raises(FileNotFoundError):
        puvr5.get_separator(model_name, "cpu")


def _workspace(tmp_path, seconds=(1.2, 0.7)):
    src = tmp_path / "src"
    src.mkdir()
    for i, s in enumerate(seconds):
        chip_smoke.write_song_source(str(src / f"song{i}.wav"), 20 + i, s)
    return str(src), str(tmp_path / "out")


def _stems(out_dir):
    got = {}
    for sub in (paths.VOCALS_OUTPUT, paths.ACCOMPANIMENTS_OUTPUT):
        for name in sorted(os.listdir(os.path.join(out_dir, sub))):
            got[name] = audio_io.read_wav(os.path.join(out_dir, sub, name),
                                          mono=False)
    return got


def test_audio_service_uvr5_matches_jax(tmp_path, monkeypatch):
    """Both services over one folder of two stereo clips with an
    ``HP5_only_main_vocal.pth`` of ch 4 / 2 / 4 (4band_v2, 672 bins): the
    same stem files within 1 LSB, the same trace, every file SUCCESS; the
    port's through ``cmd/audio_uvr5.py main`` on the CPU."""
    root = _weights_root(tmp_path, monkeypatch)
    torch.save(vr_state(seed=12, n_fft=1344),
               root / "HP5_only_main_vocal.pth")
    src, out = _workspace(tmp_path)
    want = jaudio.AudioService(src, out + "_jax").uvr5()
    assert want.ok and want.message == "UVR5 Success", want
    got = audio_uvr5.main({"source_dir": src, "output_dir": out,
                           "device": "cpu"})
    assert (got.status, got.message, got.data) == \
        (want.status, want.message, want.data)
    assert got.data == {"song0.wav": "success", "song1.wav": "success"}
    ref, stems = _stems(out + "_jax"), _stems(out)
    assert sorted(stems) == ["instrument_song0.wav.wav",
                             "instrument_song1.wav.wav",
                             "vocal_song0.wav.wav", "vocal_song1.wav.wav"]
    for name, (data, sr) in stems.items():
        assert sr == 44100 and data.shape == ref[name][0].shape
        assert data.shape[0] == 2 and np.abs(data).max() > 0
        assert np.abs(data - ref[name][0]).max() <= 1.0 / 32768 + 1e-9, name


def test_audio_service_uvr5_passthrough_only_for_absent_weights(
        tmp_path, monkeypatch):
    """No weights: FAILED, or (with ``EASEVOICE_ALLOW_PASSTHROUGH=1``) the
    sources copied as vocals with silent accompaniments, as the JAX service
    does; the port's message says that the weights are absent."""
    _weights_root(tmp_path, monkeypatch)
    src, out = _workspace(tmp_path, seconds=(0.5,))
    for allow in ("0", "1"):
        monkeypatch.setenv("EASEVOICE_ALLOW_PASSTHROUGH", allow)
        want = jaudio.AudioService(src, out + "_jax").uvr5()
        got = paudio.AudioService(src, out, "cpu").uvr5()
        assert (got.status, got.data) == (want.status, want.data)
        assert got.ok == (allow == "1")
        assert "absent" in got.message if got.ok else \
            "unavailable" in got.message
    stems = _stems(out)
    vocal, _ = stems["vocal_song0.wav.wav"]
    inst, _ = stems["instrument_song0.wav.wav"]
    source, _ = audio_io.read_wav(os.path.join(src, "song0.wav"), mono=False)
    np.testing.assert_array_equal(vocal, source)
    assert not inst.any()


def test_divergence_bad_checkpoint_fails(tmp_path, monkeypatch):
    """A checkpoint that is present but does not load: the port's request
    FAILS whatever the passthrough switch says, where the JAX service
    with the switch set copies the sources through (ROADMAP §3)."""
    root = _weights_root(tmp_path, monkeypatch)
    (root / "HP5_only_main_vocal.pth").write_bytes(b"not a checkpoint")
    src, out = _workspace(tmp_path, seconds=(0.5,))
    monkeypatch.setenv("EASEVOICE_ALLOW_PASSTHROUGH", "1")
    want = jaudio.AudioService(src, out + "_jax").uvr5()
    assert want.ok and "passthrough" in want.message
    got = paudio.AudioService(src, out, "cpu").uvr5()
    assert not got.ok and "did not load" in got.message
    assert not os.listdir(os.path.join(out, paths.VOCALS_OUTPUT))


def test_a_file_that_fails_is_marked_failed(tmp_path, monkeypatch):
    """A source that does not decode is FAILED in the trace and the other
    files are separated, as in the JAX service."""
    root = _weights_root(tmp_path, monkeypatch)
    torch.save(vr_state(seed=13, n_fft=1344),
               root / "HP5_only_main_vocal.pth")
    src, out = _workspace(tmp_path, seconds=(0.5,))
    with open(os.path.join(src, "broken.wav"), "wb") as f:
        f.write(b"RIFF....WAVEjunk")
    monkeypatch.setattr(audio_io, "have_ffmpeg", lambda: False)
    got = paudio.AudioService(src, out, "cpu").uvr5()
    assert got.ok and got.data == {"broken.wav": "failed",
                                   "song0.wav": "success"}
