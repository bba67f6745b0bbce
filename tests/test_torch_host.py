"""The port's copies of the JAX package's host-side modules against the
originals, on the same inputs: text frontend and segmentation, spectrogram
and mel filterbank, resampling, the s2 data loader and the checkpoint name
rules, the ONNX initializer reader and the G2PW host functions.  The copies
must agree exactly; they differ from the originals only in their imports.
Where a G2PWModel directory exists, both Chinese frontends read polyphones
with their G2PW model and give the same phones.

The ASR chain's host copies (fbank / LFR / CMVN, CIF, ``tokens_to_text``,
the VAD's segmenter, CT-punc's word split, Whisper's log-mel) are held to
theirs too, and the port's YAML reader to PyYAML on FunASR's configs.

One subprocess test shows that the port stands alone: with an import hook
that refuses ``easevoice_trainer_tpu``, ``jax``, ``flax``, ``transformers``,
``safetensors`` and ``yaml``, every module of the port imports, the text
frontend runs in every language, a wav loads and resamples, and the data
preparation and ASR cmds run on the CPU.
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

from _torch_bert_tiny import VOCAB, chip_smoke, write_g2pw_dir

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
        mod._g2pw_predictor.cache_clear()
    yield
    for mod in (jchinese, pchinese):
        mod._backend.cache_clear()
        mod._g2pw_predictor.cache_clear()


@pytest.fixture
def g2pw_frontend(monkeypatch):
    """Both Chinese frontends free to look for a G2PWModel directory."""
    monkeypatch.delenv("EASEVOICE_DISABLE_G2PW", raising=False)
    monkeypatch.delenv("EASEVOICE_PINYIN_TABLE", raising=False)
    monkeypatch.delenv("EASEVOICE_G2PW_DIR", raising=False)
    pchinese.set_g2pw_device("cpu")
    for mod in (jchinese, pchinese):
        mod._backend.cache_clear()
        mod._g2pw_predictor.cache_clear()
    yield
    pchinese.set_g2pw_device("cuda")
    for mod in (jchinese, pchinese):
        mod._backend.cache_clear()
        mod._g2pw_predictor.cache_clear()


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
def test_chinese_polyphones_match_jax_where_g2pw_runs(
        where, tmp_path, monkeypatch, g2pw_frontend):
    """With a G2PWModel directory ($EASEVOICE_G2PW_DIR, or models/ under the
    base path) both frontends read polyphones with their G2PW model: the
    same phones, word2ph and normalized text as the JAX package, and
    readings that are not the dictionary's everywhere.  English does not
    read polyphones; EASEVOICE_DISABLE_G2PW restores the dictionary path in
    both."""
    if where == "env":
        model_dir, _, _ = write_g2pw_dir(tmp_path / "G2PWModel")
        monkeypatch.setenv("EASEVOICE_G2PW_DIR", model_dir)
    else:
        model_dir, _, _ = write_g2pw_dir(tmp_path / "models" / "G2PWModel")
        monkeypatch.setenv("EASEVOICE_BASE_PATH", str(tmp_path))
    assert pchinese._g2pw_predictor() is not None
    assert jchinese._g2pw_predictor() is not None
    texts = [t for t, lang in SENTENCES if lang == "zh"] + [
        chip_smoke.ZH_TEXT, "朝阳升起的时候，少年背着行李出发了。"]
    model = [pcleaner.clean_text(t, "zh") for t in texts]
    for text, got in zip(texts, model):
        assert got == jcleaner.clean_text(text, "zh"), text
    assert pcleaner.clean_text("I have 25 cats.", "en") == \
        jcleaner.clean_text("I have 25 cats.", "en")
    monkeypatch.setenv("EASEVOICE_DISABLE_G2PW", "1")
    for mod in (jchinese, pchinese):
        mod._g2pw_predictor.cache_clear()
    assert pchinese._g2pw_predictor() is None
    dictionary = [pcleaner.clean_text(t, "zh") for t in texts]
    assert dictionary == [jcleaner.clean_text(t, "zh") for t in texts]
    assert dictionary != model


def test_chinese_frontend_unchanged_where_jax_takes_the_dictionary(
        tmp_path, monkeypatch, g2pw_frontend):
    """A G2PWModel directory the JAX package cannot load (no tables, no
    weights) sends both frontends down the dictionary path: the same
    phones."""
    monkeypatch.setenv("EASEVOICE_G2PW_DIR",
                       _g2pw_dir(tmp_path / "G2PWModel", complete=False))
    assert pchinese._g2pw_predictor() is None
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
    assert pchinese._g2pw_predictor() is None
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
    named BERT weights are read, anonymized ones refused (both loaders
    raise)."""
    model_dir = _g2pw_dir(tmp_path, weights=("g2pW.onnx", _onnx_bytes(name)))
    from easevoice_trainer_tpu.text.g2pw import G2PWPredictor

    from easevoice_trainer_tpu_torch.text.g2pw import \
        G2PWPredictor as PortPredictor

    if refused:
        assert G2PWPredictor._load_state(model_dir)
        assert PortPredictor._load_state(model_dir).keys() == \
            G2PWPredictor._load_state(model_dir).keys()
    else:
        for loader in (G2PWPredictor, PortPredictor):
            with pytest.raises(ValueError, match="anonymized"):
                loader._load_state(model_dir)


def _onnx_model(tensors):
    """A ModelProto with named initializers of several layouts: raw_data
    of each dtype, packed float_data, unpacked dims and float_data."""
    def varint(n):
        out = bytearray()
        while True:
            out.append((n & 0x7F) | (0x80 if n >> 7 else 0))
            n >>= 7
            if not n:
                return bytes(out)

    def ld(field, payload):
        return varint(field << 3 | 2) + varint(len(payload)) + payload

    inits = b""
    for name, (code, arr, layout) in tensors.items():
        t = b""
        if layout == "packed dims":
            t += ld(1, b"".join(varint(d) for d in arr.shape))
        else:
            t += b"".join(varint(1 << 3) + varint(d) for d in arr.shape)
        t += varint(2 << 3) + varint(code)
        if layout == "float_data packed":
            t += ld(4, struct.pack(f"<{arr.size}f", *arr.ravel()))
        elif layout == "float_data":
            t += b"".join(bytes([4 << 3 | 5]) + struct.pack("<f", x)
                          for x in arr.ravel())
        else:
            t += ld(9, arr.tobytes())
        inits += ld(5, t + ld(8, name.encode()))
    return ld(7, inits + ld(1, b"node"))


def test_onnx_reader_matches_jax(tmp_path):
    """The copied ``load_onnx_initializers`` (and the ``_fields`` walk the
    Chinese frontend uses) against the JAX package's audiokit/mdxnet.py."""
    from easevoice_trainer_tpu.audiokit import mdxnet as jmdx
    from easevoice_trainer_tpu_torch.audiokit import mdxnet as pmdx

    rng = np.random.default_rng(5)
    tensors = {
        "bert.embeddings.word_embeddings.weight":
            (1, rng.standard_normal((40, 8)).astype("<f4"), "raw"),
        "half": (10, rng.standard_normal((3, 5)).astype("<f2"), "raw"),
        "double": (11, rng.standard_normal(7).astype("<f8"), "raw"),
        "ids": (7, rng.integers(0, 99, (2, 3)).astype("<i8"), "packed dims"),
        "packed": (1, rng.standard_normal((2, 2)).astype("<f4"),
                   "float_data packed"),
        "loose": (1, rng.standard_normal(3).astype("<f4"), "float_data"),
    }
    path = str(tmp_path / "m.onnx")
    with open(path, "wb") as f:
        f.write(_onnx_model(tensors))
    want = jmdx.load_onnx_initializers(path)
    got = pmdx.load_onnx_initializers(path)
    assert got.keys() == want.keys() == tensors.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    with open(path, "rb") as f:
        data = memoryview(f.read())

    def walk(fields):
        return [(f, w, bytes(v) if w == 2 else v) for f, w, v in fields]

    assert walk(pmdx._fields(data)) == walk(jmdx._fields(data))


def test_g2pw_host_functions_match_jax():
    """wordize_and_map, tokenize_and_map (over the port's tokenizer) and
    get_phoneme_labels against the JAX module's."""
    from easevoice_trainer_tpu.text import g2pw as jg2pw
    from easevoice_trainer_tpu_torch.text import g2pw as pg2pw
    from easevoice_trainer_tpu_torch.text.bert_tokenizer import \
        BertTokenizer

    tok = BertTokenizer({t: i for i, t in enumerate(VOCAB)})
    for text in ("银行的行长 今天python3 还在,", "中 ab文", "  a1b2 c ",
                 "我们用python写了一个voice cloning的小程序."):
        assert pg2pw.wordize_and_map(text) == jg2pw.wordize_and_map(text)
        assert pg2pw.tokenize_and_map(tok, text) == \
            jg2pw.tokenize_and_map(tok, text)
    rows = [("行", "xing2"), ("行", "hang2"), ("了", "le5"),
            ("了", "liao3"), ("好", "hao3")]
    assert pg2pw.get_phoneme_labels(rows) == jg2pw.get_phoneme_labels(rows)
    assert (pg2pw.NON_POLYPHONIC, pg2pw.NON_MONOPHONIC) == \
        (jg2pw.NON_POLYPHONIC, jg2pw.NON_MONOPHONIC)


def test_chip_smoke_pinned_runs_match_clean_text(dictionary_frontend):
    """chip_smoke's ZH_PINNED (the G2P results its Chinese phase takes
    where jieba does not import) equals the port's and the JAX package's
    ``clean_text`` on the dictionary path, for exactly the Chinese runs the
    preprocessor cleans in that phase's two clones."""
    runs = {}

    class Record(ppre.TextPreprocessor):
        def _clean(self, text, language):
            out = super()._clean(text, language)
            if language == "zh":
                runs[text] = out
            return out

    pre = Record(None)
    pre.preprocess(chip_smoke.ZH_TEXT, "zh", "by_chinese_period")
    pre.preprocess(chip_smoke.ZH_MIXED, "auto", "by_chinese_period")
    assert runs.keys() == chip_smoke.ZH_PINNED.keys()
    for text, (phones, word2ph, norm) in chip_smoke.ZH_PINNED.items():
        assert runs[text] == (phones, word2ph, norm)
        jphones, jw2p, jnorm = jcleaner.clean_text(text, "zh")
        assert (jw2p, jnorm) == (word2ph, norm)
        assert jpre.cleaned_text_to_sequence(jphones) == phones


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


def _speech_like(seed: int, seconds: float, sr: int = 32000) -> np.ndarray:
    """Harmonic bursts of 1-3 s between 0.4-1.0 s of low noise."""
    rng = np.random.default_rng(seed)
    parts, total = [], 0
    while total < seconds * sr:
        n = int(sr * rng.uniform(1.0, 3.0))
        t = np.arange(n) / sr
        f0 = rng.uniform(110, 240)
        burst = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in (1, 2, 3))
        parts.append(0.25 * burst * np.hanning(n) ** 0.2)
        parts.append(rng.normal(0, 0.002, int(sr * rng.uniform(0.4, 1.0))))
        total += len(parts[-2]) + len(parts[-1])
    return np.concatenate(parts)[:int(seconds * sr)].astype(np.float32)


@pytest.mark.parametrize("kwargs", [
    {}, {"threshold": -40, "min_length": 2000, "min_interval": 200,
         "hop_size": 20, "max_sil_kept": 300}])
def test_slicer_matches_jax(kwargs):
    from easevoice_trainer_tpu.audiokit import slicer as jslicer
    from easevoice_trainer_tpu_torch.audiokit import slicer as pslicer

    wav = _speech_like(0, 20.0)
    want = jslicer.Slicer(32000, **kwargs).slice(wav)
    got = pslicer.Slicer(32000, **kwargs).slice(wav)
    assert len(got) == len(want) > 1
    for (pc, ps, pe), (jc, js, je) in zip(got, want):
        assert (ps, pe) == (js, je)
        np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(
        pslicer.frame_rms(wav, 1280, 320), jslicer.frame_rms(wav, 1280, 320))


def test_audio_service_slicer_and_refinement_match_jax(tmp_path):
    """``AudioService.slicer`` writes the same files, and the four
    refinement methods give the same responses and list files, in both
    packages."""
    from easevoice_trainer_tpu.service.audio import AudioService as JService
    from easevoice_trainer_tpu_torch.service.audio import \
        AudioService as PService

    src = tmp_path / "src"
    src.mkdir()
    for i in range(2):
        jaudio.write_wav(str(src / f"talk{i}.wav"), _speech_like(i, 14.0),
                         32000)
    services = {"jax": JService(str(src), str(tmp_path / "jax")),
                "port": PService(str(src), str(tmp_path / "port"), "cpu")}
    resps = {k: s.slicer().to_dict() for k, s in services.items()}
    assert resps["port"] == resps["jax"]
    files = {k: sorted(os.listdir(tmp_path / k / "slices"))
             for k in services}
    assert files["port"] == files["jax"] and len(files["jax"]) > 2
    for name in files["jax"]:
        a, _ = jaudio.read_wav(str(tmp_path / "jax" / "slices" / name))
        b, _ = jaudio.read_wav(str(tmp_path / "port" / "slices" / name))
        np.testing.assert_array_equal(b, a)
    for k in services:
        (tmp_path / k / "asrs").mkdir()
        (tmp_path / k / "asrs" / "asr.list").write_text(
            "".join(f"/p/{n}|ZH|第{i}句\n" for i, n in enumerate(files[k])),
            encoding="utf-8")

    def calls(svc):
        first = files["jax"][0]
        return [svc.refinement_load_source(),
                svc.refinement_reload_source(),
                svc.refinement_submit_text(f"/p/{first}", "EN", "hello\n"),
                svc.refinement_submit_text("/p/new.wav", "zh", "新的"),
                svc.refinement_delete_text(f"/p/{files['jax'][1]}"),
                svc.refinement_load_source()]

    got = {k: [r.to_dict() for r in calls(s)] for k, s in services.items()}
    assert got["port"] == got["jax"]
    lists = {k: (tmp_path / k / "refinements" / "refinement.list").read_text(
        encoding="utf-8") for k in services}
    assert lists["port"] == lists["jax"] and "new.wav|zh|新的" in lists["jax"]


@pytest.mark.parametrize("env", ["defaults", "set"])
def test_global_config_paths_match_jax(env, monkeypatch, tmp_path):
    """The port's GlobalCFG path fields against the JAX singleton's (reset
    before and after, so that it reads this environment)."""
    from easevoice_trainer_tpu.utils import config as jconfig
    from easevoice_trainer_tpu_torch.utils import config as pconfig

    names = ("gpt_path", "bert_path", "cnhubert_path", "sovits_path",
             "is_g2pw")
    monkeypatch.setenv("EASEVOICE_BASE_PATH", str(tmp_path))
    for name in names:
        if env == "set":
            monkeypatch.setenv(name, "false" if name == "is_g2pw"
                               else str(tmp_path / name))
        else:
            monkeypatch.delenv(name, raising=False)
    jconfig.GlobalCFG.reset()
    try:
        j = jconfig.GlobalCFG()
        p = pconfig.GlobalCFG()
        assert {n: getattr(p, n) for n in names} == \
            {n: getattr(j, n) for n in names}
    finally:
        jconfig.GlobalCFG.reset()


_ISOLATED = r"""
import importlib, importlib.abc, pkgutil, sys

REFUSED = ("easevoice_trainer_tpu", "jax", "jaxlib", "flax", "transformers",
           "safetensors", "yaml")


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
# dataset preparation through the cmds' main(): slice two sources, denoise
# with a tiny FRCRN checkpoint, write a refinement list, normalize (en rows:
# a tiny HuBERT and s2G, no BERT needed) on the CPU
import json, os
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch.audiokit.frcrn import FRCRN, FRCRNConfig
from easevoice_trainer_tpu_torch.cmd import audio_denoise, audio_slicer, \
    normalize
from easevoice_trainer_tpu_torch.models.cnhubert import CNHubert, \
    HubertConfig
from easevoice_trainer_tpu_torch.models.sovits import SovitsConfig, \
    SynthesizerTrn
from easevoice_trainer_tpu_torch.service.audio import AudioService
root = os.path.dirname(path)
gen = torch.Generator().manual_seed(0)
src = os.path.join(root, "src")
os.makedirs(src)
for i in range(2):
    t = np.arange(5 * 32000) / 32000
    burst = 0.3 * np.sin(2 * np.pi * 180 * t) * (np.sin(np.pi * t) > 0.15)
    audio_io.write_wav(os.path.join(src, f"s{i}.wav"), burst.astype(
        np.float32), 32000)
work = os.path.join(root, "work")
frcrn_cfg = FRCRNConfig(channels=4, depth=2, fsmn_hidden=4, lorder=3)
state = convert.random_state_dict(FRCRN(frcrn_cfg), gen)
for k in state:
    if k.endswith("running_var"):
        state[k] = state[k].abs() + 0.5
torch.save(state, os.path.join(root, "frcrn.pth"))
os.environ["EASEVOICE_FRCRN_PATH"] = os.path.join(root, "frcrn.pth")
base = {"source_dir": src, "output_dir": work, "device": "cpu"}
r = audio_slicer.main(dict(base, min_length=1000, min_interval=100))
assert r.ok and os.listdir(os.path.join(work, "slices")), r
r = audio_denoise.main(base)
assert r.ok and "frcrn-torch" in r.message, r
for name in os.listdir(os.path.join(work, "denoises")):
    den, sr = audio_io.read_wav(os.path.join(work, "denoises", name))
    assert sr == 16000 and np.isfinite(den).all() and np.abs(den).max() > 0
svc = AudioService(src, work, "cpu")
for name in sorted(os.listdir(os.path.join(work, "denoises"))):
    svc.refinement_submit_text(name, "en", "hello world")
hub = os.path.join(root, "hubert")
os.makedirs(hub)
hcfg = HubertConfig(conv_dim=(16,) * 7, hidden_size=64, num_layers=1,
                    num_heads=1, intermediate_size=64, pos_conv_kernel=16,
                    pos_conv_groups=4)
json.dump({"conv_dim": [16] * 7, "hidden_size": 64, "num_hidden_layers": 1,
           "num_attention_heads": 1, "intermediate_size": 64,
           "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4},
          open(os.path.join(hub, "config.json"), "w"))
torch.save(convert.random_state_dict(CNHubert(hcfg), gen),
           os.path.join(hub, "pytorch_model.bin"))
s2 = dict(spec_channels=1025, segment_size=2560, inter_channels=16,
          hidden_channels=16, filter_channels=32, n_heads=2, n_layers=1,
          upsample_initial_channel=32, gin_channels=16, ssl_dim=64)
os.makedirs(os.path.join(root, "configs"))
json.dump({"model": s2}, open(os.path.join(root, "configs", "s2.json"), "w"))
torch.save(convert.random_state_dict(SynthesizerTrn(SovitsConfig(**s2)), gen),
           os.path.join(root, "s2G.pth"))
os.environ.update(EASEVOICE_BASE_PATH=root, cnhubert_path=hub,
                  sovits_path=os.path.join(root, "s2G.pth"),
                  bert_path=os.path.join(root, "absent"))
r = normalize.main({"processing_path": work, "device": "cpu"})
assert r.ok, r
out = r.data["output_path"]
n = len(os.listdir(os.path.join(work, "denoises")))
assert len(os.listdir(os.path.join(out, "4-cnhubert"))) == n
assert len(open(os.path.join(out, "6-name2semantic.tsv")).read().strip(
    ).splitlines()) == n + 1
# the ASR chain through the ASR cmd's main() on the CPU at tiny widths: zh
# (fsmn-VAD, Paraformer, CT-punc; FunASR config.yaml files through the
# port's reader) and en (Whisper; the port's own tokenizer)
sys.path.insert(0, "tests")
from _torch_asr_tiny import write_clips, write_whisper_dir, write_zh_dirs
from easevoice_trainer_tpu_torch.cmd import audio_asr
asr_root = os.path.join(root, "asr")
dirs = write_zh_dirs(os.path.join(asr_root, "models"))
write_whisper_dir(os.path.join(asr_root, "whisper"))
os.environ.update(EASEVOICE_PARAFORMER_DIR=dirs[0], EASEVOICE_VAD_DIR=dirs[1],
                  EASEVOICE_PUNC_DIR=dirs[2],
                  EASEVOICE_WHISPER_DIR=os.path.join(asr_root, "whisper"))
for lang in ("zh", "en"):
    out = os.path.join(asr_root, lang)
    write_clips(out, seconds=(1.5,))
    r = audio_asr.main({"source_dir": out, "output_dir": out,
                        "language": lang, "device": "cpu"})
    assert r.ok and r.message == "asr success", r
    assert set(r.data.values()) == {"success"}, r
print(sorted(m for m in sys.modules if m.split(".")[0] in REFUSED))
"""


def test_port_stands_alone_subprocess(tmp_path):
    """A fresh interpreter that refuses to import the JAX package, jax,
    flax, transformers, safetensors and yaml imports every module of the
    port, runs the text frontend in every language, loads and resamples a
    wav, reads configs/gpt.yaml, takes two micro-batches of the s1 train
    step, prepares a dataset through the slicer, denoise and normalize
    cmds on the CPU, and transcribes through the ASR cmd in zh and en."""
    env = dict(os.environ, PYTHONPATH=REPO, EASEVOICE_DISABLE_G2PW="1")
    env.pop("EASEVOICE_PINYIN_TABLE", None)
    proc = subprocess.run([sys.executable, "-c", _ISOLATED,
                           str(tmp_path / "ref.wav")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


# ---- the ASR chain's host copies and the YAML reader ------------------------

from easevoice_trainer_tpu.audiokit import asr_paraformer as japara  # noqa: E402
from easevoice_trainer_tpu.audiokit import asr_whisper as jwhisper  # noqa: E402
from easevoice_trainer_tpu.audiokit import punc_ct as jpunc  # noqa: E402
from easevoice_trainer_tpu.audiokit import vad_fsmn as jvad  # noqa: E402
from easevoice_trainer_tpu_torch.audiokit import asr_paraformer as ppara  # noqa: E402
from easevoice_trainer_tpu_torch.audiokit import asr_whisper as pwhisper  # noqa: E402
from easevoice_trainer_tpu_torch.audiokit import punc_ct as ppunc  # noqa: E402
from easevoice_trainer_tpu_torch.audiokit import vad_fsmn as pvad  # noqa: E402
from easevoice_trainer_tpu_torch.utils import simple_yaml  # noqa: E402


def test_asr_frontends_match_jax(tmp_path):
    """kaldi fbank (and its filterbank), LFR 7/6 and 5/1, the am.mvn
    reader, and Whisper's mel filters and log-mel, on the same waves."""
    rng = np.random.default_rng(0)
    for n in (300, 16000, 40123):
        wav = rng.uniform(-0.5, 0.5, n).astype(np.float32)
        for n_mels in (80, 16):
            f = ppara.kaldi_fbank(wav, n_mels=n_mels)
            np.testing.assert_array_equal(
                f, japara.kaldi_fbank(wav, n_mels=n_mels))
            for m, s in ((7, 6), (5, 1)):
                np.testing.assert_array_equal(ppara.apply_lfr(f, m, s),
                                              japara.apply_lfr(f, m, s))
    np.testing.assert_array_equal(ppara.kaldi_fbank_mats(),
                                  japara.kaldi_fbank_mats())
    chip_smoke.write_am_mvn(str(tmp_path / "am.mvn"), 560, 3)
    for a, b in zip(ppara.load_cmvn(str(tmp_path / "am.mvn")),
                    japara.load_cmvn(str(tmp_path / "am.mvn"))):
        np.testing.assert_array_equal(a, b)
    wav = rng.uniform(-0.5, 0.5, pwhisper.CHUNK_SAMPLES).astype(np.float32)
    for n_mels in (80, 128):
        np.testing.assert_array_equal(pwhisper.mel_filters(n_mels),
                                      jwhisper.mel_filters(n_mels))
        np.testing.assert_array_equal(
            pwhisper.log_mel_spectrogram(wav, n_mels),
            jwhisper.log_mel_spectrogram(wav, n_mels))
    np.testing.assert_array_equal(pwhisper._sinusoids(1500, 768),
                                  jwhisper._sinusoids(1500, 768))


def test_cif_and_tokens_to_text_match_jax():
    rng = np.random.default_rng(1)
    for t in (1, 7, 40):
        hidden = rng.normal(size=(2, t, 5)).astype(np.float32)
        alphas = rng.uniform(0, 0.9, (2, t)).astype(np.float32)
        lens = np.array([t, max(1, t - 3)])
        a = ppara.tail_alphas(alphas, lens, 0.45)
        np.testing.assert_array_equal(a, japara.tail_alphas(alphas, lens,
                                                            0.45))
        h = np.concatenate([hidden, np.zeros((2, 1, 5), np.float32)], 1)
        for x, y in zip(ppara.cif_fire(h, a), japara.cif_fire(h, a)):
            np.testing.assert_array_equal(x, y)
    tokens = ["<blank>", "<s>", "</s>", "你", "好", "hel@@", "lo", "wor@@",
              "ld", "ok", "<unk>", "a@@", "。"]
    for _ in range(200):
        ids = rng.integers(-1, len(tokens) + 1, rng.integers(0, 12)).tolist()
        assert ppara.tokens_to_text(ids, tokens) == \
            japara.tokens_to_text(ids, tokens)


def test_vad_segmenter_and_punc_words_match_jax():
    rng = np.random.default_rng(2)
    cfgs = [(pvad.FsmnVadConfig(), jvad.FsmnVadConfig()),
            (pvad.FsmnVadConfig(max_single_segment_time=1000),
             jvad.FsmnVadConfig(max_single_segment_time=1000))]
    for _ in range(20):
        n = int(rng.integers(0, 900))
        probs = np.repeat(rng.uniform(0, 1, (n + 29) // 30), 30)[:n]
        for p, j in cfgs:
            assert pvad.segment_speech_probs(probs, p) == \
                jvad.segment_speech_probs(probs, j)
    for text in ("我们都去了北京", "hello world 你好 ok2 再见", "", "  a  b ",
                 "数据data科学 AI"):
        words = ppunc.code_mix_split_words(text)
        assert words == jpunc.code_mix_split_words(text)
        puncs = [["_", "，", "。", "<unk>", "？"][i % 5]
                 for i in range(len(words))]
        assert ppunc._join(words, puncs) == jpunc._join(words, puncs)


@pytest.mark.parametrize("kind", ["paraformer", "vad", "punc"])
def test_funasr_configs_read_as_pyyaml_reads_them(kind):
    """chip_smoke's FunASR config.yaml files (the released layout: nested
    mappings, block sequences at the key's indentation and deeper, a
    sequence of sequences, flow sequences, comments) read as
    ``yaml.safe_load`` reads them, and give the configs they were written
    from through the port's and the JAX package's ``from_yaml``."""
    import yaml

    cfgs = {"paraformer": (ppara.ParaformerConfig(), japara.ParaformerConfig),
            "vad": (pvad.FsmnVadConfig(), jvad.FsmnVadConfig),
            "punc": (ppunc.CTPuncConfig(), jpunc.CTPuncConfig)}
    cfg, jcls = cfgs[kind]
    text = chip_smoke.funasr_yaml(kind, cfg)
    got = simple_yaml.loads(text)
    assert got == yaml.safe_load(text)
    assert type(cfg).from_yaml(got) == cfg
    assert jcls.from_yaml(got) == jcls(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n  - [2, x]\n", "a: [1, 2.5, 'b c', \"d\", ~, true]\n",
    "a:\n  b:\n    c:\n      d: 1\n    e: []\n  f: {}\n",
    "a:\n- x\n- y\nb: 2\n", "a:\n  -   - 1\n      - 2\n  - 3\n",
    "a:\n  -\n    - 1\n  - k: v\n    j: [0]\n", "  a: 1\n  b:\n  - 2\n",
    "punc_list:\n- <unk>\n- _\n- ，\n- 。\n- ？\n- 、\n",
    "a: [ ]\nb: 1.0e-4\nc: 1e-4\nd: .5\n"])
def test_simple_yaml_reads_sequences_and_deep_mappings_as_pyyaml(text):
    import yaml

    assert simple_yaml.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "- 1\n", "a: [1, 2,]\n", "a: [1\n", "a:\n  hello\n", "a: 1\n- 2\n",
    "a:\n  - 1\n - 2\n", "a: [{b: 1}]\n", "a:\n  - 1\n  b: 2\n"])
def test_simple_yaml_still_refuses_the_rest(text):
    """A document that is a sequence, trailing commas and unclosed flow
    sequences, multi-line plain scalars, items at the wrong indentation,
    flow mappings inside flow sequences: a raise, not another reading
    than PyYAML's (which reads some of them and refuses others)."""
    with pytest.raises(ValueError):
        simple_yaml.loads(text)
