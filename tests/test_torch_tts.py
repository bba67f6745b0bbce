"""The PyTorch port's synthesis slice as a whole: TTS.run against the JAX
TTS.run with greedy sampling (top_k=1 draws no randomness), the service
path through .pth files, and the rule that the port never imports JAX."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from easevoice_trainer_tpu import native as jnative
from easevoice_trainer_tpu.inference import tts as jtts
from easevoice_trainer_tpu.models.cnhubert import CNHubert as JHubert, \
    HubertConfig as JHubertConfig
from easevoice_trainer_tpu.models.gpt import T2SConfig as JT2SConfig, \
    Text2SemanticDecoder as JT2S
from easevoice_trainer_tpu.models.sovits import SovitsConfig as JSovitsConfig, \
    SynthesizerTrn as JSynth
from easevoice_trainer_tpu.utils import audio_io
from easevoice_trainer_tpu_torch import native as pnative
from easevoice_trainer_tpu_torch.inference import tts as ptts
from easevoice_trainer_tpu_torch.service.voice import VoiceCloneService

from _torch_port_tiny import HUBERT_KW, SOVITS_KW, T2S_KW, tiny_gpt, \
    tiny_hubert, tiny_sovits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = ("The quick brown fox jumps over the lazy dog. "
        "A journey of a thousand miles begins with one step. "
        "Voice cloning needs a reference clip.")
# int16 LSBs: fp32 summation order differs between the frameworks (and the
# JAX Generator folds its narrow stages), ~1e-5 relative on the waveform
WAV_ATOL = 4


@pytest.fixture(scope="module")
def models():
    return tiny_sovits(), tiny_gpt(), tiny_hubert()


def _port_tts(models, tmp, max_sec=8):
    (vits, _, _), (t2s, _, _), (hub, _, _) = models
    cfg = ptts.TTSConfig(os.path.join(tmp, "port_tts.json"))
    cfg.device = "cpu"
    cfg.max_sec = max_sec
    return ptts.TTS(cfg, models=dict(vits=vits, t2s=t2s, cnhubert=hub))


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ref"))
    path = os.path.join(tmp, "ref.wav")
    audio_io.write_wav(path, np.random.default_rng(0).uniform(
        -0.3, 0.3, 32000 * 4).astype(np.float32), 32000)
    return tmp, path


def test_task_schema_matches_jax():
    jf = [(f.name, f.default) for f in
          dataclasses.fields(jtts.InferenceTaskData)]
    pf = [(f.name, f.default) for f in
          dataclasses.fields(ptts.InferenceTaskData)]
    assert jf == pf


@pytest.mark.parametrize("lens,batch_size,threshold", [
    ((30, 5, 18, 7, 7, 22), 2, 0.75), ((1, 1, 100), 3, 0.75),
    ((12, 3, 40, 41, 39, 5, 6), 4, 0.5)])
def test_to_batch_matches_jax(lens, batch_size, threshold):
    segs = [{"phones": [0] * n} for n in lens]
    for split in (True, False):
        want = jtts.TTS.to_batch(segs, batch_size, threshold, split)[1]
        got = ptts.TTS.to_batch(segs, batch_size, threshold, split)[1]
        assert got == want


def test_tts_config_reads_yaml_writes_json(tmp_path):
    path = str(tmp_path / "tts_infer.yaml")
    jcfg = jtts.TTSConfig(path)
    jcfg.t2s_weights_path = "/models/g.ckpt"
    jcfg.save_configs()                      # YAML, as the JAX package writes
    pcfg = ptts.TTSConfig(path)
    assert pcfg.t2s_weights_path == "/models/g.ckpt"
    pcfg.device = "cuda:0"
    pcfg.save_configs()                      # JSON, which YAML readers read
    assert jtts.TTSConfig(path).device == "cuda:0"
    assert ptts.TTSConfig(str(tmp_path / "absent.json")).device == "cuda"


def test_tts_run_greedy_matches_jax(models, ref_wav, monkeypatch):
    """Whole slice: same weights, same reference, greedy tokens; the
    fragments must have equal lengths and waveforms within WAV_ATOL.  Both
    packages resample the reference with scipy (neither native library is
    loaded), so HuBERT sees the same 16 kHz input whichever library a
    checkout has built."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(pnative, "_lib", None)
    tmp, ref = ref_wav
    (_, vparams, _), (_, tparams, _), (_, hparams, _) = models
    jcfg = jtts.TTSConfig(os.path.join(tmp, "jax_tts.yaml"))
    jcfg.max_sec = 8
    jax_tts = jtts.TTS(jcfg, models=dict(
        vits=JSynth(JSovitsConfig(**SOVITS_KW)),
        vits_cfg=JSovitsConfig(**SOVITS_KW), vits_params=vparams,
        t2s=JT2S(JT2SConfig(**T2S_KW)), t2s_cfg=JT2SConfig(**T2S_KW),
        t2s_params=tparams, cnhubert=JHubert(JHubertConfig(**HUBERT_KW)),
        cnhubert_params={"params": hparams}, bert=None))
    port_tts = _port_tts(models, tmp)
    task = dict(text=TEXT, text_lang="en", ref_audio_path=ref,
                text_split_method="by_english_period", batch_size=2,
                parallel_infer=True, top_k=1, seed=7, keep_random=False,
                return_fragment=True)
    want = list(jax_tts.run(jtts.InferenceTaskData(**task)))
    got = list(port_tts.run(ptts.InferenceTaskData(**task)))
    np.testing.assert_array_equal(
        port_tts.prompt_cache["prompt_semantic"],
        np.asarray(jax_tts.prompt_cache["prompt_semantic"]))
    assert [len(a) for _, a in got] == [len(a) for _, a in want]
    for (_, g), (_, w) in zip(got, want):
        d = np.abs(g.astype(np.int32) - w.astype(np.int32)).max()
        assert d <= WAV_ATOL, d
        assert np.abs(w).max() > 100  # not silence


def test_single_row_vocode_matches_batch_vocode(models, ref_wav):
    """parallel_infer=False decodes each row alone: same waveform as the
    padded batch decode on the valid samples (the flow and decoder mask by
    length; the HiFi-GAN receptive field smears padding into the tail)."""
    tmp, ref = ref_wav
    tts = _port_tts(models, tmp)
    tts.set_ref_audio(ref)
    rng = np.random.default_rng(3)
    lengths = np.asarray([40, 72, 17], np.int64)
    tokens = rng.integers(0, 1024, (3, 72))
    batch = [{"phones": list(rng.integers(1, 50, 6))} for _ in lengths]
    whole = tts._vocode_batch(tokens, lengths, batch, 1.0)
    for n, w, tok, seg in zip(lengths, whole, tokens, batch):
        alone = tts._vocode(tok[:n], seg["phones"], 1.0)
        assert alone.shape == w.shape
        interior = int(n) * tts.cfg.hop_length
        np.testing.assert_allclose(alone[:interior], w[:interior], atol=5e-4)


def _save(state, path, prefix=""):
    torch.save({"weight": {prefix + k: v for k, v in state.items()},
                "config": {}, "info": "test"}, path)


def test_voice_clone_service_through_pth_files(models, ref_wav, tmp_path):
    """The service loads weights from released-style files (GPT keys with
    the lightning "model." prefix, SoVITS with the training-only enc_q)."""
    (vits, _, _), (t2s, _, _), _ = models
    sovits_path = str(tmp_path / "s.pth")
    gpt_path = str(tmp_path / "g.ckpt")
    sd = dict(vits.state_dict())
    sd["enc_q.proj.weight"] = torch.zeros(4, 4, 1)
    _save(sd, sovits_path)
    _save(t2s.state_dict(), gpt_path, prefix="model.")
    _, ref = ref_wav
    tts = _port_tts(models, str(tmp_path))

    class Sessions:
        def __init__(self):
            self.info, self.ended = [], []

        def update_session_info(self, uuid, info):
            self.info.append(info)

        def end_session_with_response(self, uuid, response):
            self.ended.append(response)

    sessions = Sessions()
    result = VoiceCloneService(sessions, tts).clone("u1", dict(
        text=TEXT, text_lang="en", ref_audio_path=ref, prompt_text="",
        text_split_method="by_english_period", batch_size=4, top_k=15,
        seed=1234, keep_random=False, sovits_path=sovits_path,
        gpt_path=gpt_path, output_dir=str(tmp_path / "out")))
    assert result.ok and sessions.ended == [result]
    assert result.data["actual_seed"] == 1234
    wav, sr = audio_io.read_wav(result.data["output_path"])
    assert sr == 32000 and np.isfinite(wav).all() and np.abs(wav).max() > 0
    assert tts.vits is not vits and tts.t2s is not t2s  # reloaded from files
    assert ptts.TTSConfig(tts.cfg.config_path).vits_weights_path == \
        sovits_path


@pytest.mark.parametrize("files,refuses", [
    (("pytorch_model.bin", "vocab.txt"), True),
    (("model.safetensors", "tokenizer.json"), True),
    (("pytorch_model.bin",), False),   # no tokenizer: JAX gives zeros too
    ((), False),                       # no weights: the same
])
def test_chinese_bert_refused_where_jax_would_run_it(models, tmp_path,
                                                     monkeypatch, files,
                                                     refuses):
    """With a BERT directory that the JAX package's BertFeatureExtractor
    loads (weights and tokenizer), Chinese text would get real BERT
    features there; the port, which has not ported BERT, raises
    NotImplementedError naming it instead of feeding the GPT zeros.  English
    text, and Chinese text where the JAX extractor is unavailable, give
    what the JAX preprocessor without BERT gives (zero features)."""
    from easevoice_trainer_tpu.inference.preprocessor import \
        TextPreprocessor as JPre

    monkeypatch.setenv("EASEVOICE_DISABLE_G2PW", "1")
    bert_dir = tmp_path / "chinese-roberta-wwm-ext-large"
    bert_dir.mkdir()
    for name in files:
        (bert_dir / name).write_bytes(b"")
    (vits, _, _), (t2s, _, _), (hub, _, _) = models
    cfg = ptts.TTSConfig(str(tmp_path / "tts.json"))
    cfg.device = "cpu"
    cfg.bert_base_path = str(bert_dir)
    pre = ptts.TTS(cfg, models=dict(vits=vits, t2s=t2s,
                                    cnhubert=hub)).preprocessor
    jpre = JPre(None)
    cases = [("Hello world, this is a test.", "en")]
    if refuses:
        with pytest.raises(NotImplementedError, match="BERT"):
            pre.get_phones_and_bert("我们都去了北京。", "all_zh")
    else:
        cases.append(("我们都去了北京。", "all_zh"))
    for text, lang in cases:
        got, want = pre.get_phones_and_bert(text, lang), \
            jpre.get_phones_and_bert(text, lang)
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_array_equal(got[1], want[1])
        assert not got[1].any()


_NO_JAX_SCRIPT = r"""
import os, sys, tempfile
import numpy as np, torch
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch.inference.tts import TTS, TTSConfig, \
    InferenceTaskData
from easevoice_trainer_tpu_torch.models.cnhubert import CNHubert, HubertConfig
from easevoice_trainer_tpu_torch.models.gpt import T2SConfig, \
    Text2SemanticDecoder
from easevoice_trainer_tpu_torch.models.sovits import SovitsConfig, \
    SynthesizerTrn
from easevoice_trainer_tpu_torch.service import voice
from easevoice_trainer_tpu_torch.utils import audio_io
import json
SOVITS_KW, T2S_KW, HUBERT_KW = json.loads(sys.argv[1])
g = torch.Generator().manual_seed(0)
mods = {}
for name, m in (("vits", SynthesizerTrn(SovitsConfig(**SOVITS_KW))),
                ("t2s", Text2SemanticDecoder(T2SConfig(**T2S_KW))),
                ("cnhubert", CNHubert(HubertConfig(**HUBERT_KW)))):
    m.load_state_dict(convert.random_state_dict(m, g))
    mods[name] = m.eval()
tmp = tempfile.mkdtemp()
cfg = TTSConfig(os.path.join(tmp, "tts.json"))
cfg.device, cfg.max_sec = "cpu", 6
ref = os.path.join(tmp, "ref.wav")
audio_io.write_wav(ref, np.random.default_rng(0).uniform(
    -0.3, 0.3, 32000 * 4).astype(np.float32), 32000)
out = list(TTS(cfg, models=mods).run(InferenceTaskData(
    text="Hello there. General Kenobi.", text_lang="en", ref_audio_path=ref,
    text_split_method="by_english_period", batch_size=2)))
assert len(out[0][1]) > 0
print(sorted(m for m in ("jax", "flax", "optax", "yaml", "psutil")
             if m in sys.modules))
"""


def test_port_runs_without_jax_subprocess():
    """tests/conftest.py imports jax into this process, so the check runs
    the port's import + a tiny TTS.run in a fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=REPO)
    sizes = json.dumps([SOVITS_KW, T2S_KW, HUBERT_KW])
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT, sizes],
                          cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout
