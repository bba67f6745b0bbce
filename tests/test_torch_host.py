"""The port's copies of the JAX package's host-side modules against the
originals, on the same inputs: text frontend and segmentation, spectrogram
and mel filterbank, resampling, the s2 data loader and the checkpoint name
rules.  The copies must agree exactly; they differ from the originals only in
their imports (and the port's Chinese frontend never loads the flax G2PW
model, as the JAX package does not when no G2PWModel directory exists).

One subprocess test shows that the port stands alone: with an import hook
that refuses ``easevoice_trainer_tpu``, ``jax`` and ``flax``, every module of
the port imports, the text frontend runs in every language and a wav loads
and resamples.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from easevoice_trainer_tpu import native as jnative
from easevoice_trainer_tpu.inference import preprocessor as jpre
from easevoice_trainer_tpu.inference import segmentation as jseg
from easevoice_trainer_tpu.ops import mel as jmel
from easevoice_trainer_tpu.text import chinese as jchinese
from easevoice_trainer_tpu.text import cleaner as jcleaner
from easevoice_trainer_tpu.train import ckpt as jckpt
from easevoice_trainer_tpu.train import data as jdata
from easevoice_trainer_tpu.utils import audio_io as jaudio
from easevoice_trainer_tpu_torch import native as pnative
from easevoice_trainer_tpu_torch.inference import preprocessor as ppre
from easevoice_trainer_tpu_torch.inference import segmentation as pseg
from easevoice_trainer_tpu_torch.ops import mel as pmel
from easevoice_trainer_tpu_torch.ops import stft as pstft
from easevoice_trainer_tpu_torch.text import chinese as pchinese
from easevoice_trainer_tpu_torch.text import cleaner as pcleaner
from easevoice_trainer_tpu_torch.train import ckpt as pckpt
from easevoice_trainer_tpu_torch.train import data as pdata
from easevoice_trainer_tpu_torch.utils import audio_io as paudio

from _torch_port_tiny import tiny_gpt, tiny_mpd, tiny_sovits_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# sentences of tests/test_text.py, test_japanese.py and test_cantonese.py
SENTENCES = [
    ("hello world", "en"),
    ("I have 25 cats.", "en"),
    ("成熟是一种明亮而不刺眼的光辉，一种不再需要对别人察言观色的从容。", "zh"),
    ("我们都去了北京。", "zh"),
    ("你好，世界！", "zh"),
    ("こんにちは", "ja"),
    ("私は学校に行きます。", "ja"),
    ("안녕하세요. 반갑습니다.", "ko"),
    ("你今日食咗飯未呀？", "yue"),
]


@pytest.fixture
def dictionary_frontend(monkeypatch):
    """Both Chinese frontends on the dictionary path, caches cleared."""
    monkeypatch.setenv("EASEVOICE_DISABLE_G2PW", "1")
    monkeypatch.delenv("EASEVOICE_PINYIN_TABLE", raising=False)
    for mod in (jchinese, pchinese):
        mod._backend.cache_clear()
    jchinese._g2pw_predictor.cache_clear()
    yield
    for mod in (jchinese, pchinese):
        mod._backend.cache_clear()
    jchinese._g2pw_predictor.cache_clear()


@pytest.mark.parametrize("text,lang", SENTENCES)
def test_clean_text_matches_jax(text, lang, dictionary_frontend):
    """phones, word2ph and normalized text of ``clean_text``."""
    assert pcleaner.clean_text(text, lang) == jcleaner.clean_text(text, lang)


@pytest.mark.parametrize("text,lang", SENTENCES)
@pytest.mark.parametrize("mode", ["plain", "all", "auto"])
def test_text_preprocessor_matches_jax(text, lang, mode, dictionary_frontend):
    """``TextPreprocessor.preprocess``: segments, phone ids, norm text and
    the (zero) BERT features, through the language's own route (``en`` /
    ``all_*``) and the script-run route (``zh``/``ja``/... and ``auto`` /
    ``auto_yue``)."""
    language = {"plain": lang, "all": lang if lang == "en" else "all_" + lang,
                "auto": "auto_yue" if lang == "yue" else "auto"}[mode]
    got = ppre.TextPreprocessor(None).preprocess(text, language,
                                                 "by_punctuation")
    want = jpre.TextPreprocessor(None).preprocess(text, language,
                                                  "by_punctuation")
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g["phones"]) == list(w["phones"])
        assert g["norm_text"] == w["norm_text"]
        np.testing.assert_array_equal(g["bert_features"], w["bert_features"])


@pytest.mark.parametrize("name", jseg.get_split_names())
def test_segmentation_matches_jax(name):
    text = ("First sentence here. Second one, with a comma! 第三句。"
            "第四句，还有逗号？ A fifth: short. And the sixth.")
    assert pseg.get_split_names() == jseg.get_split_names()
    assert pseg.get_split_method(name)(text) == \
        jseg.get_split_method(name)(text)


def test_spectrogram_and_mel_filterbank_match_jax():
    wav = np.random.default_rng(0).uniform(-0.5, 0.5, 12345).astype(
        np.float32)
    np.testing.assert_array_equal(pdata.spectrogram_np(wav),
                                  jdata.spectrogram_np(wav))
    np.testing.assert_array_equal(
        pdata.spectrogram_np(wav, 1024, 256, 1024),
        jdata.spectrogram_np(wav, 1024, 256, 1024))
    for args in ((32000, 2048, 128, 0.0, None), (16000, 1024, 80, 50.0,
                                                 7600.0)):
        np.testing.assert_array_equal(pmel.mel_filterbank(*args),
                                      jmel.mel_filterbank(*args))
    assert pstft.mel_filterbank is pmel.mel_filterbank


@pytest.mark.parametrize("shape", [(4801,), (2, 4801)])
def test_resample_matches_jax(shape, monkeypatch):
    """Both packages on scipy's ``resample_poly`` (neither native library
    loaded): bit-equal, mono and (channels, samples)."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(pnative, "_lib", None)
    x = np.random.default_rng(1).uniform(-0.5, 0.5, shape).astype(np.float32)
    for sr_in, sr_out in ((32000, 16000), (44100, 32000), (16000, 16000)):
        np.testing.assert_array_equal(paudio.resample(x, sr_in, sr_out),
                                      jaudio.resample(x, sr_in, sr_out))


def test_native_library_builds_from_the_repo_source(tmp_path, monkeypatch):
    """``native.build`` compiles the repository's ``csrc/evaudio.cpp`` into
    the given path and loads it; its functions agree with the numpy
    fallbacks (and, where the JAX package's library is loaded, bit for bit
    with it)."""
    monkeypatch.setattr(pnative, "_lib", None)
    x = np.random.default_rng(2).uniform(-0.9, 0.9, 9601).astype(np.float32)
    fallback = (pnative.peak(x), pnative.float_to_int16(x),
                pnative.frame_rms(x, 2048, 512))
    path = pnative.build(str(tmp_path / "libevaudio.so"))
    assert os.path.exists(path) and pnative.available()
    assert pnative.peak(x) == fallback[0]
    np.testing.assert_array_equal(pnative.float_to_int16(x), fallback[1])
    np.testing.assert_allclose(pnative.frame_rms(x, 2048, 512), fallback[2],
                               rtol=1e-5)
    if jnative.available():
        np.testing.assert_array_equal(pnative.resample_poly(x, 1, 2),
                                      jnative.resample_poly(x, 1, 2))


def _write_normalize_dir(root, rng):
    """A tiny normalize output: 2-name2text / 4-cnhubert / 5-wav32k."""
    os.makedirs(os.path.join(root, "4-cnhubert"))
    os.makedirs(os.path.join(root, "5-wav32k"))
    phones = "HH AH0 L OW1 W ER1 L D".split()
    lines = []
    for i, frames in enumerate((40, 57, 33, 90)):
        name = f"clip{i}.wav"
        jaudio.write_wav(os.path.join(root, "5-wav32k", name),
                         rng.uniform(-0.3, 0.3, frames * 640), 32000)
        ssl = rng.normal(size=(768, frames + i % 2)).astype(np.float32)
        np.save(os.path.join(root, "4-cnhubert", name + ".npy"), ssl)
        lines.append(f"{name}\t{' '.join(phones[:4 + i])}\t1\ttext")
    with open(os.path.join(root, "2-name2text.txt"), "w",
              encoding="utf8") as f:
        f.write("\n".join(lines))


def test_s2_data_loader_matches_jax(tmp_path):
    """``S2Dataset``, ``BucketBatcher`` and ``collate_s2``: the same items,
    batches and padded arrays."""
    root = str(tmp_path / "norm")
    _write_normalize_dir(root, np.random.default_rng(3))
    pds, jds = pdata.S2Dataset(root), jdata.S2Dataset(root)
    assert pds.lengths == jds.lengths and len(pds) == len(jds)
    pb = pdata.BucketBatcher(pds.lengths, 3)
    jb = jdata.BucketBatcher(jds.lengths, 3)
    for epoch in (1, 2):
        batches = pb.epoch_batches(epoch)
        assert batches == jb.epoch_batches(epoch)
        for bucket, idxs in batches:
            assert pb.padded_frames(bucket) == jb.padded_frames(bucket)
            got = pdata.collate_s2([pds.load_item(i) for i in idxs],
                                   pb.padded_frames(bucket), 16)
            want = jdata.collate_s2([jds.load_item(i) for i in idxs],
                                    jb.padded_frames(bucket), 16)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("which", ["sovits_generator", "sovits_discriminator",
                                   "gpt"])
def test_flax_to_torch_rules_match_jax(which, tmp_path):
    """``flax_to_torch`` with each rule set on the tiny models' JAX
    parameters: identical keys and arrays; and ``save_torch_state`` /
    ``load_torch_state`` read each other's files."""
    params = {"sovits_generator": lambda: tiny_sovits_train()[1],
              "sovits_discriminator": lambda: tiny_mpd()[1],
              "gpt": lambda: tiny_gpt()[1]}[which]()
    rules = which + "_rules"
    got = pckpt.flax_to_torch(params, getattr(pckpt, rules)())
    want = jckpt.flax_to_torch(params, getattr(jckpt, rules)())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    pckpt.save_torch_state(got, str(tmp_path / "p.pth"), half=True)
    jckpt.save_torch_state(want, str(tmp_path / "j.pth"), half=True)
    a = pckpt.load_torch_state(str(tmp_path / "j.pth"))
    b = jckpt.load_torch_state(str(tmp_path / "p.pth"))
    assert a.keys() == b.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(a[k], b[k])
    flat = pckpt.flatten_tree(params)
    assert flat.keys() == jckpt.flatten_tree(params).keys()


def test_flatten_tree_and_conv_transposes_match_jax():
    w = np.random.default_rng(4).normal(size=(6, 5, 3)).astype(np.float32)
    for name in ("t2f_convT", "f2t_convT", "t2f_conv", "f2t_conv",
                 "t2f_dense"):
        np.testing.assert_array_equal(getattr(pckpt, name)(w),
                                      getattr(jckpt, name)(w))
    tree = {"a": {"b": np.ones(2), "c": {"d": np.zeros((1, 2))}}}
    got, want = pckpt.flatten_tree(tree), jckpt.flatten_tree(tree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


_ISOLATED = r"""
import importlib, importlib.abc, pkgutil, sys

REFUSED = ("easevoice_trainer_tpu", "jax", "jaxlib", "flax")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
import numpy as np
import easevoice_trainer_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
from easevoice_trainer_tpu_torch.inference.preprocessor import \
    TextPreprocessor
from easevoice_trainer_tpu_torch.utils import audio_io
pre = TextPreprocessor(None)
for text, lang in [("Hello world, this is a test.", "en"),
                   ("我们都去了北京。", "zh"), ("私は学校に行きます。", "ja"),
                   ("안녕하세요. 반갑습니다.", "ko"),
                   ("你今日食咗飯未呀？", "yue")]:
    out = pre.preprocess(text, lang, "by_punctuation")
    assert out and all(len(o["phones"]) for o in out), (lang, out)
path = sys.argv[1]
audio_io.write_wav(path, np.random.default_rng(0).uniform(
    -0.3, 0.3, 32000).astype(np.float32), 32000)
wav = audio_io.load_audio(path, 16000)
assert wav.shape == (16000,) and np.isfinite(wav).all()
print(sorted(m for m in sys.modules if m.split(".")[0] in REFUSED))
"""


def test_port_stands_alone_subprocess(tmp_path):
    """A fresh interpreter that refuses to import the JAX package, jax and
    flax imports every module of the port, runs the text frontend in every
    language and loads and resamples a wav."""
    env = dict(os.environ, PYTHONPATH=REPO, EASEVOICE_DISABLE_G2PW="1")
    env.pop("EASEVOICE_PINYIN_TABLE", None)
    proc = subprocess.run([sys.executable, "-c", _ISOLATED,
                           str(tmp_path / "ref.wav")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout
