"""The port's FRCRN denoiser (audiokit/frcrn.py, audiokit/denoise.py)
against the JAX package's, on the CPU at the tiny config of
tests/test_frcrn.py, with the seeded torch replica there as the weights.

Tolerances: the net's estimate and mask within 1e-5 of the largest JAX
magnitude (fp32; the convolutions and dense layers sum in another order),
the STFT within 1e-5 absolute; the written 16 kHz files within 1 int16
LSB; the weight converter's round trip and the spectral gate exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from easevoice_trainer_tpu import native as jnative
from easevoice_trainer_tpu.audiokit import denoise as jdenoise
from easevoice_trainer_tpu.audiokit import frcrn as J
from easevoice_trainer_tpu.utils import audio_io as jaudio
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch import native as pnative
from easevoice_trainer_tpu_torch.audiokit import denoise as pdenoise
from easevoice_trainer_tpu_torch.audiokit import frcrn as P
from easevoice_trainer_tpu_torch.service.audio import AudioService

from _torch_port_tiny import assert_close
from test_frcrn import TINY, _random_replica, _to_modelscope_names

TOL = 1e-5


def _to_port(spec: np.ndarray) -> torch.Tensor:
    """(B, F, T, 1, 2) -> the port's (2B, 1, F, T): real parts, then
    imaginary."""
    x = torch.from_numpy(spec)
    return torch.cat([x[..., 0, 0], x[..., 0, 1]])[:, None]


def _from_port(t: torch.Tensor) -> np.ndarray:
    re, im = t[:, 0].chunk(2)
    return torch.stack([re, im], -1)[..., None, :].numpy()


def test_frcrn_config_matches_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(J.FRCRNConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(P.FRCRNConfig)]
    assert jf == pf and P.FRCRNConfig().n_bins == J.FRCRNConfig().n_bins


@pytest.mark.parametrize("layout", ["replica", "modelscope"])
def test_frcrn_net_matches_jax(layout):
    """The whole net, weights in the replica key scheme or in modelscope's
    (adapted by ``adapt_modelscope_state``, then loaded strict)."""
    state = _random_replica(seed=3).state_dict()
    params, stats = J.convert_frcrn_weights(state, TINY)
    src = dict(state) if layout == "replica" else _to_modelscope_names(state)
    model = P.load_frcrn(P.replica_state(src), TINY)
    spec = np.random.default_rng(5).normal(
        size=(2, TINY.n_bins, 9, 1, 2)).astype(np.float32)
    j_est, j_mask = J.FRCRN(TINY).apply(
        {"params": params, "batch_stats": stats}, spec)
    with torch.no_grad():
        p_est, p_mask = model(_to_port(spec))
    assert_close(_from_port(p_mask), j_mask, TOL, "mask")
    assert_close(_from_port(p_est), j_est, TOL, "estimate")


def test_frcrn_state_dict_inverts_the_jax_converter():
    state = _random_replica(seed=6).state_dict()
    got = convert.frcrn_state_dict(*J.convert_frcrn_weights(state, TINY))
    want = {k: v for k, v in state.items()
            if not k.endswith(".num_batches_tracked")}
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    P.FRCRN(TINY).load_state_dict(got, strict=True)


def test_stft_and_istft_match_jax():
    wav = np.random.default_rng(2).uniform(-0.8, 0.8, (2, 4001)).astype(
        np.float32)
    want = np.asarray(J.stft(wav, 640, 320, 640))
    got = P.stft(torch.from_numpy(wav), 640, 320, 640).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    back = P.istft(torch.from_numpy(want.copy()), 4001).numpy()
    np.testing.assert_allclose(back, np.asarray(J.istft(want, 4001)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(back, wav, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", ["replica", "modelscope"])
def test_denoiser_matches_jax_file_to_file(layout, tmp_path, monkeypatch):
    """``FRCRNDenoiser.denoise`` on files: a 16 kHz clip of 1.5 s (not a
    multiple of the 2 s bucket) and a 32 kHz clip of 2.3 s (resampled to
    16 kHz first, on both sides through numpy's resampler); the config
    inferred from the checkpoint."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setenv("EASEVOICE_FRCRN_STFT", "64,32,64")
    state = _random_replica(seed=4).state_dict()
    ckpt = tmp_path / "pytorch_model.bin"
    torch.save(dict(state) if layout == "replica"
               else _to_modelscope_names(state), str(ckpt))
    jden = J.FRCRNDenoiser(str(ckpt))
    pden = P.FRCRNDenoiser(str(ckpt), "cpu")
    assert dataclasses.asdict(pden.cfg) == dataclasses.asdict(jden.cfg) \
        == dataclasses.asdict(TINY)
    rng = np.random.default_rng(7)
    for i, (sr, n) in enumerate(((16000, 24000), (32000, 73600))):
        src = str(tmp_path / f"in{i}.wav")
        jaudio.write_wav(src, rng.uniform(-0.5, 0.5, n).astype(np.float32),
                         sr)
        outs = []
        for den, tag in ((jden, "jax"), (pden, "port")):
            dst = str(tmp_path / f"out{i}_{tag}.wav")
            den.denoise(src, dst)
            outs.append(jaudio.read_wav(dst))
        (jw, jsr), (pw, psr) = outs
        assert jsr == psr == 16000 and len(pw) == len(jw) == n * 16000 // sr
        assert np.isfinite(pw).all() and np.abs(pw).max() > 0
        assert np.abs(pw - jw).max() <= 1.0 / 32768, np.abs(pw - jw).max()


def test_spectral_gate_matches_jax():
    wav = np.random.default_rng(1).normal(0, 0.2, 20000).astype(np.float32)
    np.testing.assert_array_equal(pdenoise.spectral_gate(wav, 16000),
                                  jdenoise.spectral_gate(wav, 16000))
    short = wav[:500]
    np.testing.assert_array_equal(pdenoise.spectral_gate(short, 16000),
                                  jdenoise.spectral_gate(short, 16000))


@pytest.mark.parametrize("case", ["not a checkpoint", "unknown keys",
                                  "a tensor missing"])
def test_bad_checkpoint_raises_where_jax_falls_back(case, tmp_path,
                                                    monkeypatch):
    """A checkpoint that is present but does not load raises in the port;
    the JAX Denoise logs it and runs the spectral gate instead."""
    path = tmp_path / "pytorch_model.bin"
    if case == "not a checkpoint":
        path.write_bytes(b"\x00corrupt" * 64)
    elif case == "unknown keys":
        torch.save({"alien.weight": torch.zeros(3)}, str(path))
    else:
        state = dict(_random_replica(seed=8).state_dict())
        del state["unet2.dec1_fr.fsmn.im.conv1.weight"]
        torch.save(state, str(path))
    monkeypatch.setenv("EASEVOICE_FRCRN_PATH", str(path))
    monkeypatch.setenv("EASEVOICE_FRCRN_STFT", "64,32,64")
    with pytest.raises(Exception):
        P.FRCRNDenoiser(str(path), "cpu")
    with pytest.raises(Exception):
        pdenoise.Denoise("cpu")
    assert jdenoise.Denoise().backend == "spectral-gate"


def test_denoise_backends_and_service(tmp_path, monkeypatch):
    """The backend the Denoise reports, the AudioService messages (the same
    as the JAX service's for the spectral gate and the passthrough), and
    the card by default."""
    ckpt = tmp_path / "frcrn.pth"
    torch.save(_random_replica(seed=9).state_dict(), str(ckpt))
    monkeypatch.setenv("EASEVOICE_FRCRN_STFT", "64,32,64")
    monkeypatch.setenv("EASEVOICE_FRCRN_PATH", str(tmp_path / "absent.bin"))
    assert pdenoise.Denoise("cpu").backend == "spectral-gate"
    out = tmp_path / "work"
    (out / "slices").mkdir(parents=True)
    jaudio.write_wav(str(out / "slices" / "a_0000000000_0000012800.wav"),
                     np.random.default_rng(3).uniform(
                         -0.3, 0.3, 12800).astype(np.float32), 32000)
    resp = AudioService("", str(out), "cpu").denoise()
    from easevoice_trainer_tpu.service.audio import AudioService as JService

    assert resp.to_dict() == JService("", str(out)).denoise().to_dict()
    monkeypatch.setattr(AudioService, "_load_denoiser",
                        staticmethod(lambda device: None))
    monkeypatch.setattr(JService, "_load_denoiser", staticmethod(lambda: None))
    for allow in ("0", "1"):
        monkeypatch.setenv("EASEVOICE_ALLOW_PASSTHROUGH", allow)
        assert AudioService("", str(out), "cpu").denoise().to_dict() == \
            JService("", str(out)).denoise().to_dict()
    monkeypatch.undo()
    monkeypatch.setenv("EASEVOICE_FRCRN_STFT", "64,32,64")
    monkeypatch.setenv("EASEVOICE_FRCRN_PATH", str(ckpt))
    resp = AudioService("", str(out), "cpu").denoise()
    assert resp.ok and resp.message == "Denoise Success (backend: frcrn-torch)"
    wav, sr = jaudio.read_wav(str(out / "denoises" /
                                  "a_0000000000_0000012800.wav"))
    assert sr == 16000 and len(wav) == 6400
    if not torch.cuda.is_available():
        for make in (lambda: pdenoise.Denoise(),
                     lambda: P.FRCRNDenoiser(str(ckpt)),
                     lambda: AudioService("", str(out))):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                make()
