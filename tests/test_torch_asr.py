"""The port's zh ASR chain against the JAX package's on the CPU: Paraformer,
the fsmn-VAD and CT-punc at tiny widths (``tests/_torch_asr_tiny.py``),
loaded by both packages from the same FunASR-layout directories, on the
same seeded inputs; then ``AudioService.asr`` of both services over one
folder, and the port's three deliberate divergences from the JAX service
(no external backend, a bad checkpoint raises, a failing file is marked
FAILED)."""
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easevoice_trainer_tpu.audiokit import asr_paraformer as japara
from easevoice_trainer_tpu.audiokit import punc_ct as jpunc
from easevoice_trainer_tpu.audiokit import vad_fsmn as jvad
from easevoice_trainer_tpu.service import audio as jaudio
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch.audiokit import asr_paraformer as ppara
from easevoice_trainer_tpu_torch.audiokit import punc_ct as ppunc
from easevoice_trainer_tpu_torch.audiokit import vad_fsmn as pvad
from easevoice_trainer_tpu_torch.cmd import audio_asr
from easevoice_trainer_tpu_torch.service import audio as paudio
from easevoice_trainer_tpu_torch.utils import audio_io, paths

from _torch_asr_tiny import PARA, PUNC, VAD, write_clips, \
    write_zh_dirs

ENV = ("EASEVOICE_PARAFORMER_DIR", "EASEVOICE_VAD_DIR", "EASEVOICE_PUNC_DIR",
       "EASEVOICE_WHISPER_DIR")


@pytest.fixture(autouse=True)
def jax_punc_writes_a_copy(monkeypatch):
    """The JAX ``CTPunc._predict_puncs`` writes -inf into
    ``np.asarray(<jax array>)``, a read-only view, so it raises on every
    input (punc_ct.py:373-376); the port's does not.  Its loaded forward
    is made to hand back a writable copy, so that the JAX side can be
    compared at all."""
    load = jpunc.CTPunc._load

    def patched(self, model_path):
        load(self, model_path)
        forward = self._forward
        self._forward = lambda *args: np.array(forward(*args))

    monkeypatch.setattr(jpunc.CTPunc, "_load", patched)


@pytest.fixture(scope="module")
def zh_dirs(tmp_path_factory):
    return write_zh_dirs(tmp_path_factory.mktemp("asr_models"))


@pytest.fixture(scope="module")
def paraformers(zh_dirs):
    jax_asr = japara.ParaformerASR(zh_dirs[0])
    assert jax_asr.available
    return jax_asr, ppara.ParaformerASR(zh_dirs[0], "cpu")


def _feats(asr, seconds, seed=3):
    wav = np.random.default_rng(seed).uniform(
        -0.3, 0.3, int(16000 * seconds)).astype(np.float32)
    return asr.features(wav)


# ---- Paraformer ---------------------------------------------------------------

@pytest.mark.parametrize("seconds", [1.2, 1.94])
def test_paraformer_matches_jax(paraformers, seconds):
    """Encoder output, alphas and decoder logits within 1e-4 of the JAX
    net and the same ids, at a clip below its time bucket (20 LFR frames
    padded to 32) and at one of a power of two (32 frames)."""
    jax_asr, asr = paraformers
    feats = _feats(asr, seconds)
    t = feats.shape[0]
    assert t == (20 if seconds < 1.5 else 32)
    np.testing.assert_array_equal(
        feats, (japara.apply_lfr(japara.kaldi_fbank(
            np.random.default_rng(3).uniform(
                -0.3, 0.3, int(16000 * seconds)).astype(np.float32),
            n_mels=16)) + jax_asr.cmvn_shift) * jax_asr.cmvn_scale)
    t_pad = ppara.bucket(t, 16)
    x = np.zeros((1, t_pad, feats.shape[1]), np.float32)
    x[0, :t] = feats
    mask = np.zeros((1, t_pad, 1), np.float32)
    mask[0, :t] = 1.0
    j_enc, j_alphas = (np.asarray(a) for a in jax_asr._encode(
        jax_asr.params, jnp.asarray(x), jnp.asarray(mask)))
    out = asr._infer(feats)
    np.testing.assert_allclose(out.enc.numpy(), j_enc, rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.alphas.numpy(), j_alphas, rtol=0,
                               atol=1e-4)
    ids = jax_asr._infer_ids(feats)
    assert out.ids == ids and len(ids) > 2
    n = len(ids)
    emb, _ = japara.cif_fire(
        np.concatenate([j_enc, np.zeros((1, 1, PARA.d_model), np.float32)],
                       1), japara.tail_alphas(j_alphas, np.array([t])))
    n_pad = ppara.bucket(n, 8)
    e = np.zeros((1, n_pad, PARA.d_model), np.float32)
    e[0, :n] = emb[0, :n]
    tm = np.zeros((1, n_pad, 1), np.float32)
    tm[0, :n] = 1.0
    j_logits = np.asarray(jax_asr._decode(
        jax_asr.params, jnp.asarray(j_enc), jnp.asarray(mask),
        jnp.asarray(e), jnp.asarray(tm)))[:, :n]
    np.testing.assert_allclose(out.logits.numpy(), j_logits, rtol=0,
                               atol=1e-4)
    assert asr.transcribe(np.zeros(100, np.float32)) == ""


def test_paraformer_time_bucket_reaches_the_last_alpha(paraformers):
    """The padded frames reach ``alpha[t-1]`` through the predictor's 3-tap
    conv (and the tail firing through ``enc[t]``): the same clip run
    unpadded gives another ``alpha[t-1]``, while every padded length at or
    above t + 1 gives the same one, and the valid encoder frames do not
    depend on the padding."""
    _, asr = paraformers
    feats = _feats(asr, 1.2)
    t = feats.shape[0]
    assert ppara.bucket(t, 16) == 32
    runs = {}
    for p in (t, t + 1, 32, 64):
        x = torch.zeros((1, p, feats.shape[1]))
        x[0, :t] = torch.from_numpy(feats)
        mask = torch.zeros((1, p, 1))
        mask[0, :t] = 1.0
        with torch.no_grad():
            runs[p] = asr.model.encode(x, mask)
    last = {p: float(alphas[0, t - 1]) for p, (_, alphas) in runs.items()}
    assert abs(last[t] - last[32]) > 1e-3, last
    np.testing.assert_allclose(asr._infer(feats).alphas[0, t - 1], last[32],
                               rtol=0, atol=0)
    for p in (t, t + 1, 64):
        assert p == t or abs(last[p] - last[32]) < 1e-6, last
        np.testing.assert_allclose(runs[p][0][0, :t], runs[32][0][0, :t],
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(runs[t][1][0, :t - 1],
                               runs[32][1][0, :t - 1], rtol=0, atol=1e-5)


def test_paraformer_loads_strict_without_the_training_only_tensors(zh_dirs):
    """The directory's model.pt carries the decoder's token embedding, as a
    released one does; it is dropped and every other key must match."""
    state = torch.load(os.path.join(zh_dirs[0], "model.pt"))
    assert "decoder.embed.0.weight" in state
    model = ppara.Paraformer(PARA)
    keys = set(model.state_dict())
    assert keys == {k for k in state if not k.startswith(
        ppara.TRAINING_ONLY)}
    assert keys == set(japara.expected_key_manifest(PARA))


def test_paraformer_state_dict_round_trips_through_the_jax_converter():
    state = convert.random_state_dict(ppara.Paraformer(PARA),
                                      torch.Generator().manual_seed(1))
    back = convert.paraformer_state_dict(
        japara.convert_paraformer_weights(state, PARA))
    assert back.keys() == state.keys()
    for k in state:
        torch.testing.assert_close(back[k], state[k], rtol=0, atol=0)


# ---- fsmn-VAD -------------------------------------------------------------------

def test_vad_probs_and_segments_match_jax(zh_dirs, tmp_path):
    """Speech probabilities within 1e-5, segments identical, on a 6 s
    speech-like clip; FunASR's ``encoder.`` prefix is taken off."""
    jax_vad = jvad.FsmnVAD(zh_dirs[1])
    vad = pvad.FsmnVAD(zh_dirs[1], "cpu")
    assert jax_vad.available and vad.available
    assert vad.cfg == VAD
    path = str(tmp_path / "speech.wav")
    from _torch_bert_tiny import chip_smoke
    chip_smoke.write_speech_source(path, 5, 6.0, 16000)
    wav = audio_io.load_audio(path, 16000)
    np.testing.assert_allclose(vad.speech_probs(wav),
                               jax_vad.speech_probs(wav), rtol=0, atol=1e-5)
    assert vad.segments(wav) == jax_vad.segments(wav)
    assert vad.segments(wav)
    assert vad.speech_probs(np.zeros(10, np.float32)).shape == (0,)


def test_vad_state_dict_round_trips_through_the_jax_converter():
    state = convert.random_state_dict(pvad.FSMN(VAD),
                                      torch.Generator().manual_seed(2))
    flax = jvad.convert_fsmn_vad_weights(state, VAD)
    back = convert.fsmn_vad_state_dict(flax)
    assert back.keys() == state.keys()
    for k in state:
        torch.testing.assert_close(back[k], state[k], rtol=0, atol=0)
    prefixed = {"encoder." + k: v for k, v in state.items()}
    assert pvad.strip_encoder_prefix(prefixed).keys() == state.keys()
    assert set(prefixed) == set(jvad.expected_key_manifest(VAD))


# ---- CT-punc ----------------------------------------------------------------------

# 47 words (CJK characters singly, latin words whole): three chunks of 20
TEXT = ("我们都去了北京 hello world 银行的行长今天还在重新调整数据 我们都去了"
        "北京银行的行长 today 今天还在重新调整数据我们都去了北京")


def test_punc_logits_and_restore_match_jax(zh_dirs):
    """Logits within 1e-4 of the JAX net, and ``restore`` (20-word chunks,
    the tail after the last sentence end carried into the next one)
    gives the same text."""
    jax_punc = jpunc.CTPunc(zh_dirs[2])
    punc = ppunc.CTPunc(zh_dirs[2], "cpu")
    assert jax_punc.available and punc.available and punc.cfg == PUNC
    words = ppunc.code_mix_split_words(TEXT)
    assert len(words) > 40 and "hello" in words
    t = len(words[:20])
    ids = np.zeros((1, 32), np.int32)
    ids[0, :t] = [punc.vocab.get(w, punc.unk_id) for w in words[:20]]
    mask = np.zeros((1, 32, 1), np.float32)
    mask[0, :t] = 1.0
    want = np.asarray(jax_punc._forward(jax_punc.params, jnp.asarray(ids),
                                        jnp.asarray(mask)))[0, :t]
    np.testing.assert_allclose(punc._logits(words[:20]).numpy(), want,
                               rtol=0, atol=1e-4)
    calls = []
    predict = punc._predict_puncs

    def spy(ws):
        calls.append(len(ws))
        return predict(ws)

    punc._predict_puncs = spy
    out = punc.restore(TEXT)
    assert out == jax_punc.restore(TEXT)
    assert len(calls) == 3 and out[-1] in "。？"


def test_punc_state_dict_round_trips_through_the_jax_converter():
    state = convert.random_state_dict(ppunc.CTTransformer(PUNC),
                                      torch.Generator().manual_seed(3))
    back = convert.ct_punc_state_dict(
        jpunc.convert_ct_punc_weights(state, PUNC))
    assert back.keys() == state.keys() == set(
        jpunc.expected_key_manifest(PUNC))
    for k in state:
        torch.testing.assert_close(back[k], state[k], rtol=0, atol=0)


# ---- the service -----------------------------------------------------------------

def _env(monkeypatch, dirs, whisper=None):
    for key, value in zip(ENV, list(dirs) + [whisper]):
        if value is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, str(value))
    monkeypatch.setenv("EASEVOICE_BASE_PATH", str(dirs[0]) + "_no_base")


def _asr_rows(out_dir):
    with open(os.path.join(str(out_dir), paths.ASRS_OUTPUT, paths.ASR_FILE),
              encoding="utf8") as f:
        return f.read().split("\n")


def test_audio_service_asr_matches_jax(zh_dirs, tmp_path, monkeypatch):
    """Both services over one folder of three clips (fsmn-VAD, Paraformer,
    CT-punc): identical ``asr.list`` lines and refinement dump, every file
    SUCCESS; the port's through ``cmd/audio_asr.py main`` on the CPU."""
    _env(monkeypatch, zh_dirs)
    clips = write_clips(tmp_path)
    resp = jaudio.AudioService(str(tmp_path), str(tmp_path)).asr()
    assert resp.ok and resp.message == "asr success", resp
    want = _asr_rows(tmp_path)
    resp = audio_asr.main({"source_dir": str(tmp_path),
                           "output_dir": str(tmp_path), "device": "cpu"})
    assert resp.ok and resp.message == "asr success", resp
    assert set(resp.data.values()) == {"success"} and len(resp.data) == 3
    got = _asr_rows(tmp_path)
    assert got == want and len(got) == 3
    for row, clip in zip(got, clips):
        path, lang, text = row.split("|", 2)
        assert path == clip and lang == "zh" and text[-1] in "。？"
    with open(os.path.join(str(tmp_path), paths.REFINEMENTS_OUTPUT,
                           paths.REFINEMENT_FILE), encoding="utf8") as f:
        assert f.read().split("\n") == want


def test_audio_service_asr_without_models_is_passthrough_or_fails(
        tmp_path, monkeypatch):
    """No model directory: FAILED, or empty transcripts under
    ``EASEVOICE_ALLOW_PASSTHROUGH=1``, as in the JAX service."""
    _env(monkeypatch, [str(tmp_path / "none")] * 3,
         str(tmp_path / "none_w"))
    write_clips(tmp_path, seconds=(1.0,))
    for allow in ("0", "1"):
        monkeypatch.setenv("EASEVOICE_ALLOW_PASSTHROUGH", allow)
        want = jaudio.AudioService(str(tmp_path), str(tmp_path)).asr()
        got = paudio.AudioService(str(tmp_path), str(tmp_path), "cpu").asr()
        assert (got.status, got.message, got.data) == \
            (want.status, want.message, want.data)


def test_divergence_no_external_backend(zh_dirs, tmp_path, monkeypatch):
    """(a) Where ``funasr`` imports, the JAX service transcribes with it;
    the port goes straight to its own nets."""
    _env(monkeypatch, zh_dirs)
    write_clips(tmp_path, seconds=(2.0,))

    class AutoModel:
        def __init__(self, **kw):
            pass

        def generate(self, input):
            return [{"text": "EXTERNAL"}]

    monkeypatch.setitem(sys.modules, "funasr",
                        types.SimpleNamespace(AutoModel=AutoModel))
    assert jaudio.AudioService(str(tmp_path), str(tmp_path)).asr().ok
    assert _asr_rows(tmp_path)[0].endswith("|zh|EXTERNAL")
    assert paudio.AudioService(str(tmp_path), str(tmp_path), "cpu").asr().ok
    text = _asr_rows(tmp_path)[0].split("|", 2)[2]
    assert text and text != "EXTERNAL"


@pytest.mark.parametrize("stage", ["paraformer", "vad", "punc"])
def test_divergence_bad_checkpoint_raises(zh_dirs, tmp_path, monkeypatch,
                                          stage):
    """(b) A checkpoint that is present and does not load: the JAX loaders
    log it and drop the stage (or fall through to Whisper); the port's
    constructor raises, and the cmd answers FAILED."""
    import shutil

    dirs = []
    for i, d in enumerate(zh_dirs):
        copy = tmp_path / os.path.basename(d)
        shutil.copytree(d, copy)
        dirs.append(str(copy))
    bad = dirs[["paraformer", "vad", "punc"].index(stage)]
    state = torch.load(os.path.join(bad, "model.pt"))
    state.pop(sorted(state)[-1])
    torch.save(state, os.path.join(bad, "model.pt"))
    cls = {"paraformer": (japara.ParaformerASR, ppara.ParaformerASR),
           "vad": (jvad.FsmnVAD, pvad.FsmnVAD),
           "punc": (jpunc.CTPunc, ppunc.CTPunc)}[stage]
    assert not cls[0](bad).available
    with pytest.raises((RuntimeError, KeyError)):
        cls[1](bad, "cpu")
    _env(monkeypatch, dirs)
    write_clips(tmp_path, seconds=(2.0,))
    assert jaudio.AudioService(str(tmp_path), str(tmp_path)).asr().ok \
        or stage == "paraformer"
    with pytest.raises((RuntimeError, KeyError)):
        audio_asr.main({"source_dir": str(tmp_path),
                        "output_dir": str(tmp_path), "device": "cpu"})
    assert not ppara.ParaformerASR(str(tmp_path / "absent"),
                                   "cpu").available


def test_divergence_failed_file_is_marked_not_swallowed(
        zh_dirs, tmp_path, monkeypatch):
    """(c) A file whose recognition raises (here its attention call) is
    FAILED in the trace and has no row, the others go on; nothing falls
    back to another computation."""
    _env(monkeypatch, zh_dirs)
    clips = write_clips(tmp_path, seconds=(1.0, 6.0))
    real = ppara.Paraformer.encode

    def encode(self, feats, mask):
        if feats.shape[1] > 64:
            raise RuntimeError("encoder_attention: launch failed")
        return real(self, feats, mask)

    monkeypatch.setattr(ppara.Paraformer, "encode", encode)
    resp = paudio.AudioService(str(tmp_path), str(tmp_path), "cpu").asr()
    assert resp.ok
    assert resp.data == {clips[0]: "success", clips[1]: "failed"}
    rows = _asr_rows(tmp_path)
    assert len(rows) == 1 and rows[0].startswith(clips[0] + "|zh|")


def test_asr_entry_points_raise_without_a_card(zh_dirs, tmp_path,
                                               monkeypatch):
    """Asked for the card (the default) where there is none, each net and
    the cmd raise; no quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls, d in ((ppara.ParaformerASR, zh_dirs[0]),
                   (pvad.FsmnVAD, zh_dirs[1]), (ppunc.CTPunc, zh_dirs[2])):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cls(d)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        audio_asr.main({"source_dir": str(tmp_path),
                        "output_dir": str(tmp_path)})
