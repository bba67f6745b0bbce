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
import struct
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


@pytest.fixture
def g2pw_frontend(monkeypatch):
    """Both Chinese frontends free to look for a G2PWModel directory."""
    monkeypatch.delenv("EASEVOICE_DISABLE_G2PW", raising=False)
    monkeypatch.delenv("EASEVOICE_PINYIN_TABLE", raising=False)
    monkeypatch.delenv("EASEVOICE_G2PW_DIR", raising=False)
    for mod in (jchinese, pchinese):
        mod._backend.cache_clear()
    jchinese._g2pw_predictor.cache_clear()
    yield
    for mod in (jchinese, pchinese):
        mod._backend.cache_clear()
    jchinese._g2pw_predictor.cache_clear()


G2PW_TABLE_TEXT = {"POLYPHONIC_CHARS.txt": "行\txing2\n行\thang2\n",
                   "MONOPHONIC_CHARS.txt": "我\two3\n",
                   "bopomofo_to_pinyin_wo_tune_dict.json": "{}"}
G2PW_TOKENIZER = {"vocab.txt": "[PAD]\n[UNK]\n[CLS]\n[SEP]\n[MASK]\n我\n",
                  "tokenizer_config.json": '{"tokenizer_class": '
                                           '"BertTokenizer"}'}


def _onnx_bytes(initializer_name: str) -> bytes:
    """A ModelProto whose graph holds one initializer of that name: a float
    tensor of shape (1,)."""
    def ld(field, payload):     # a length-delimited field (len < 128)
        return bytes([field << 3 | 2, len(payload)]) + payload

    tensor = (bytes([1 << 3, 1, 2 << 3, 1])             # dims [1], FLOAT
              + bytes([4 << 3 | 5]) + struct.pack("<f", 0.5)  # float_data
              + ld(8, initializer_name.encode()))       # name
    return ld(7, ld(5, tensor))          # ModelProto.graph.initializer


def _g2pw_dir(path, complete=True, tokenizer=True,
              weights=("g2pW.pth", b"")):
    """A G2PWModel directory: the files the JAX package's loader reads
    first (tables that parse, a tokenizer under tokenizer/, a weights
    file), or nothing."""
    os.makedirs(path, exist_ok=True)
    if not complete:
        return str(path)
    for name, text in G2PW_TABLE_TEXT.items():
        with open(os.path.join(path, name), "w", encoding="utf8") as f:
            f.write(text)
    if tokenizer:
        os.makedirs(os.path.join(path, "tokenizer"))
        for name, text in G2PW_TOKENIZER.items():
            with open(os.path.join(path, "tokenizer", name), "w",
                      encoding="utf8") as f:
                f.write(text)
    name, data = weights
    with open(os.path.join(path, name), "wb") as f:
        f.write(data)
    return str(path)


@pytest.fixture
def no_network(monkeypatch):
    """The JAX G2PW loader asks transformers for a tokenizer: keep it to
    local files."""
    import socket

    def refuse(*args, **kwargs):
        raise OSError("network access refused in tests")

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)


@pytest.mark.parametrize("where", ["env", "base path"])
def test_chinese_polyphones_refused_where_jax_would_run_g2pw(
        where, tmp_path, monkeypatch, g2pw_frontend):
    """With a G2PWModel directory ($EASEVOICE_G2PW_DIR, or models/ under the
    base path) the JAX package would read polyphones with its G2PW model,
    which the port has not ported: Chinese text raises NotImplementedError
    naming it instead of taking the dictionary path.  English does not read
    polyphones and is unchanged; EASEVOICE_DISABLE_G2PW restores the
    dictionary path, as in the JAX package."""
    if where == "env":
        monkeypatch.setenv("EASEVOICE_G2PW_DIR",
                           _g2pw_dir(tmp_path / "G2PWModel"))
    else:
        _g2pw_dir(tmp_path / "models" / "G2PWModel")
        monkeypatch.setenv("EASEVOICE_BASE_PATH", str(tmp_path))
    with pytest.raises(NotImplementedError, match="G2PW"):
        pcleaner.clean_text("我们都去了北京。", "zh")
    assert pcleaner.clean_text("I have 25 cats.", "en") == \
        jcleaner.clean_text("I have 25 cats.", "en")
    monkeypatch.setenv("EASEVOICE_DISABLE_G2PW", "1")
    assert pchinese._g2pw_predictor() is None
    assert pcleaner.clean_text("我们都去了北京。", "zh") == \
        jcleaner.clean_text("我们都去了北京。", "zh")


def test_chinese_frontend_unchanged_where_jax_takes_the_dictionary(
        tmp_path, monkeypatch, g2pw_frontend):
    """A G2PWModel directory the JAX package cannot load (no tables, no
    weights) sends both frontends down the dictionary path: the same
    phones."""
    monkeypatch.setenv("EASEVOICE_G2PW_DIR",
                       _g2pw_dir(tmp_path / "G2PWModel", complete=False))
    assert pchinese.g2pw_model_dir() is None
    for text, lang in SENTENCES:
        if lang == "zh":
            assert pcleaner.clean_text(text, lang) == \
                jcleaner.clean_text(text, lang)


@pytest.mark.parametrize("case", ["no tokenizer", "empty tables",
                                  "anonymized onnx"])
def test_chinese_frontend_unchanged_where_jax_g2pw_does_not_load(
        case, tmp_path, monkeypatch, g2pw_frontend, no_network):
    """A directory with tables and weights but no tokenizer (the usual
    G2PWModel download), tables that do not parse, or a g2pW.onnx whose
    initializers carry no parameter names: the JAX package's predictor
    reports itself unavailable and both frontends give the dictionary
    phones."""
    kw = {"no tokenizer": dict(tokenizer=False),
          "empty tables": {},
          "anonymized onnx": dict(weights=("g2pW.onnx",
                                           _onnx_bytes("onnx::MatMul_1")))}
    model_dir = _g2pw_dir(tmp_path / "G2PWModel", **kw[case])
    if case == "empty tables":
        for name in G2PW_TABLE_TEXT:
            open(os.path.join(model_dir, name), "w").close()
    monkeypatch.setenv("EASEVOICE_G2PW_DIR", model_dir)
    assert pchinese.g2pw_model_dir() is None
    assert jchinese._g2pw_predictor() is None
    for text, lang in SENTENCES:
        if lang == "zh":
            assert pcleaner.clean_text(text, lang) == \
                jcleaner.clean_text(text, lang)


@pytest.mark.parametrize("name,refused", [
    ("bert.embeddings.word_embeddings.weight", True),
    ("onnx::MatMul_1", False)])
def test_g2pw_onnx_rule_matches_jax_loader(name, refused, tmp_path):
    """The port reads g2pW.onnx's initializer names as the JAX loader does:
    named BERT weights count (the port refuses), anonymized ones do not
    (the JAX loader raises)."""
    model_dir = _g2pw_dir(tmp_path, weights=("g2pW.onnx", _onnx_bytes(name)))
    assert pchinese._g2pw_weights_load(model_dir) is refused
    from easevoice_trainer_tpu.text.g2pw import G2PWPredictor

    if refused:
        assert G2PWPredictor._load_state(model_dir)
    else:
        with pytest.raises(ValueError, match="anonymized"):
            G2PWPredictor._load_state(model_dir)


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


def _write_s1_dir(root: str, rng) -> None:
    """A synthetic s1 normalize output: 2-name2text.txt, a
    6-name2semantic.tsv (with its header line) and 3-bert features for one
    item (one more of the wrong length, which both loaders replace by
    zeros)."""
    os.makedirs(os.path.join(root, "3-bert"))
    phones = ["AA1", "b", "a1", "SP", ".", "HH", "AH0"]
    text, sem = [], ["item_name\tsemantic_audio"]
    for i, n_sem in enumerate((30, 41, 57, 25, 90)):
        name = f"clip{i}.wav"
        ph = (phones * 4)[:6 + 3 * i]
        text.append(f"{name}\t{' '.join(ph)}\t1\ttext")
        tokens = " ".join(map(str, rng.integers(0, 1024, n_sem)))
        sem.append(f"{name}\t{tokens}")
        if i < 2:
            n = len(ph) if i == 0 else len(ph) + 1
            np.save(os.path.join(root, "3-bert", name + ".npy"),
                    rng.normal(size=(1024, n)).astype(np.float32))
    text.append("clip9.wav\tZZZ-not-a-phone\t1\ttext")
    sem.append(f"clip9.wav\t{' '.join(['7'] * 30)}")
    for name, lines in (("2-name2text.txt", text),
                        ("6-name2semantic.tsv", sem)):
        with open(os.path.join(root, name), "w", encoding="utf8") as f:
            f.write("\n".join(lines))


def test_s1_data_loader_matches_jax(tmp_path):
    """``GPTDataset`` and ``collate_gpt``: the same filtered and replicated
    items, lengths, loaded items (3-bert features attached, transposed, or
    replaced by zeros) and padded batches."""
    root = str(tmp_path / "s1")
    _write_s1_dir(root, np.random.default_rng(8))
    pds, jds = pdata.GPTDataset(root), jdata.GPTDataset(root)
    assert len(pds) == len(jds) and pds.lengths == jds.lengths
    for (pn, pp, ps), (jn, jp, js) in zip(pds.items, jds.items):
        assert pn == jn
        np.testing.assert_array_equal(pp, jp)
        np.testing.assert_array_equal(ps, js)
    items = [(pds.load_item(i), jds.load_item(i)) for i in range(6)]
    for got, want in items:
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    got = pdata.collate_gpt([a for a, _ in items], 16, 64)
    want = jdata.collate_gpt([b for _, b in items], 16, 64)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_gpt_checkpoint_io_matches_jax(tmp_path):
    """``export_gpt_weights`` of both packages on the tiny GPT's JAX
    parameters write the same state (``model.``-prefixed reference names,
    fp16) and config; ``load_gpt_pretrained`` of both read either file into
    the same tree with no unmatched key."""
    _, params, _ = tiny_gpt()
    cfg = {"model": {"n_layer": 2}}
    paths = {"port": str(tmp_path / "p.ckpt"), "jax": str(tmp_path / "j.ckpt")}
    pckpt.export_gpt_weights(params, paths["port"], config=cfg, info="e1")
    jckpt.export_gpt_weights(params, paths["jax"], config=cfg, info="e1")
    import torch

    objs = {k: torch.load(v, map_location="cpu", weights_only=False)
            for k, v in paths.items()}
    assert objs["port"]["config"] == objs["jax"]["config"] == cfg
    assert objs["port"]["weight"].keys() == objs["jax"]["weight"].keys()
    for k, v in objs["jax"]["weight"].items():
        assert k.startswith("model.") and v.dtype == torch.float16
        assert torch.equal(objs["port"]["weight"][k], v)
    for path in paths.values():
        got, pun = pckpt.load_gpt_pretrained(path)
        want, jun = jckpt.load_gpt_pretrained(path)
        assert pun == jun == []
        gf, wf = pckpt.flatten_tree(got), jckpt.flatten_tree(want)
        assert gf.keys() == wf.keys()
        for k in wf:
            np.testing.assert_array_equal(gf[k], wf[k])


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
# the s1 slice: the config reader on configs/gpt.yaml, and two micro-batches
# of the train step (forward, K5's twin under autograd, ScaledAdam) at a
# tiny width
import torch
from easevoice_trainer_tpu_torch.models.gpt import T2SConfig, \
    Text2SemanticDecoder
from easevoice_trainer_tpu_torch.train.gpt_step import GPTTrainHP, \
    GPTTrainStep
from easevoice_trainer_tpu_torch.utils import simple_yaml
cfg = T2SConfig.from_yaml_dict(simple_yaml.load("configs/gpt.yaml"))
assert (cfg.n_layers, cfg.hidden_dim, cfg.n_heads) == (24, 512, 16)
torch.manual_seed(0)
model = Text2SemanticDecoder(T2SConfig(embedding_dim=32, hidden_dim=32,
                                       n_heads=2, n_layers=1, ffn_dim=64))
step = GPTTrainStep(model, GPTTrainHP(grad_accum=2))
batch = {"phoneme_ids": torch.randint(1, 700, (2, 8)),
         "phoneme_ids_len": torch.tensor([8, 5]),
         "semantic_ids": torch.randint(0, 1024, (2, 12)),
         "semantic_ids_len": torch.tensor([12, 7]),
         "bert_feature": torch.zeros(2, 8, 1024)}
before = model.h.layers[0].self_attn.in_proj_weight.detach().clone()
for _ in range(2):
    m = step(batch)
assert all(torch.isfinite(v) for v in m.values())
assert not torch.equal(before, model.h.layers[0].self_attn.in_proj_weight)
print(sorted(m for m in sys.modules if m.split(".")[0] in REFUSED))
"""


def test_port_stands_alone_subprocess(tmp_path):
    """A fresh interpreter that refuses to import the JAX package, jax and
    flax imports every module of the port, runs the text frontend in every
    language, loads and resamples a wav, reads configs/gpt.yaml and takes
    two micro-batches of the s1 train step."""
    env = dict(os.environ, PYTHONPATH=REPO, EASEVOICE_DISABLE_G2PW="1")
    env.pop("EASEVOICE_PINYIN_TABLE", None)
    proc = subprocess.run([sys.executable, "-c", _ISOLATED,
                           str(tmp_path / "ref.wav")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout
