"""The port's G2PW polyphone model (text/g2pw.py) against the JAX
package's, on G2PWModel directories the tests write (character tables, a
BERT tokenizer, weights as g2pW.pth or g2pW.onnx) at a small width with
the encoders' head width (128 wide, 2 heads of 64, 2 layers).  Tolerance:
1e-5 absolute on the label probabilities (fp32 softmax of logits within
~1e-6); the batches, labels and readings must be identical."""
import os
import shutil

import numpy as np
import pytest
import torch

from easevoice_trainer_tpu.text import g2pw as jg2pw
from easevoice_trainer_tpu_torch.text import chinese as pchinese
from easevoice_trainer_tpu_torch.text import g2pw as pg2pw

from _torch_bert_tiny import ZH_SENTENCES, chip_smoke, write_g2pw_dir

ATOL = 1e-5
SEGMENTS = ["银行的行长今天还在重新调整数据.", "我觉得这种音乐很好听,",
            "大家都乐了.", "朝阳升起的时候,", "少年背着行李出发了."]


def _fallback(ch):
    return {"今": "jin1", "天": "tian1"}.get(ch, ch + "5")


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _ld(field, payload):
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def write_onnx(path, state):
    """A ModelProto whose graph holds each tensor as a named fp32
    initializer with raw_data (the layout of a torch.onnx export)."""
    inits = b""
    for name, t in state.items():
        arr = np.ascontiguousarray(t.numpy(), "<f4")
        tensor = b"".join(_varint(1 << 3) + _varint(d) for d in arr.shape)
        tensor += _varint(2 << 3) + _varint(1)            # FLOAT
        tensor += _ld(8, name.encode()) + _ld(9, arr.tobytes())
        inits += _ld(5, tensor)
    with open(path, "wb") as f:
        f.write(_ld(7, inits))


@pytest.fixture(scope="module")
def g2pw_dirs(tmp_path_factory):
    """The same model as g2pW.pth and as g2pW.onnx, in two directories."""
    root = tmp_path_factory.mktemp("g2pw")
    pth_dir, _, state = write_g2pw_dir(root / "pth")
    onnx_dir = str(root / "onnx")
    shutil.copytree(pth_dir, onnx_dir)
    os.remove(os.path.join(onnx_dir, "g2pW.pth"))
    write_onnx(os.path.join(onnx_dir, "g2pW.onnx"), state)
    return {"g2pW.pth": pth_dir, "g2pW.onnx": onnx_dir}


@pytest.fixture(scope="module", params=["g2pW.pth", "g2pW.onnx"])
def predictors(request, g2pw_dirs):
    model_dir = g2pw_dirs[request.param]
    jp = jg2pw.G2PWPredictor(model_dir)
    pp = pg2pw.G2PWPredictor(model_dir, "cpu")
    assert jp.available and pp.available
    return jp, pp


def _queries(pred, seg):
    ids = [i for i, ch in enumerate(seg) if ch in pred.poly_set]
    return [seg] * len(ids), ids


@pytest.mark.parametrize("seg", SEGMENTS)
def test_g2pw_probabilities_match_jax(predictors, seg):
    """The batch (token ids padded to a power of two, phoneme masks, char
    ids, query positions) is identical; the probabilities agree within
    1e-5, are 0 outside each query's phonemes, and give the same labels."""
    jp, pp = predictors
    texts, ids = _queries(pp, seg)
    assert ids, seg
    jb, pb = jp._prepare_batch(texts, ids), pp._prepare_batch(texts, ids)
    assert jb.keys() == pb.keys()
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    want = np.asarray(jp._apply(jp.params, **jb))
    got = pp.probabilities(texts, ids)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (got[jb["phoneme_mask"] == 0] == 0).all()
    assert pp.predict(texts, ids) == jp.predict(texts, ids)


def test_lazy_pinyin_matches_jax(predictors):
    jp, pp = predictors
    for seg in SEGMENTS + ["我们都去了北京."]:
        assert pp.lazy_pinyin(seg, _fallback) == \
            jp.lazy_pinyin(seg, _fallback)


def test_onnx_and_torch_files_load_equal(g2pw_dirs):
    """g2pW.onnx through the copied protobuf reader loads the same weights
    as g2pW.pth."""
    a = pg2pw.G2PWPredictor(g2pw_dirs["g2pW.pth"], "cpu").model.state_dict()
    b = pg2pw.G2PWPredictor(g2pw_dirs["g2pW.onnx"], "cpu").model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_convert_g2pw_weights_reads_the_other_names(g2pw_dirs):
    """The alternative names JAX convert_g2pw_weights takes (an
    ``encoder.`` BERT prefix, out.*, descriptor_bias.weight as an (1, n)
    embedding, char_emb.weight) give the same state dict; a state with no
    classifier is refused."""
    state = pg2pw.G2PWPredictor._load_state(g2pw_dirs["g2pW.pth"])
    cfg = pg2pw.G2PWPredictor(g2pw_dirs["g2pW.pth"], "cpu").cfg
    renamed = {}
    for k, v in state.items():
        k = k.replace("bert.", "encoder.", 1) if k.startswith("bert.") else k
        k = {"classifier.weight": "out.weight", "classifier.bias": "out.bias",
             "char_descriptor.weight": "char_emb.weight"}.get(k, k)
        if k == "descriptor_bias":
            k, v = "descriptor_bias.weight", v[None]
        renamed[k] = v
    want = pg2pw.convert_g2pw_weights(state, cfg)
    got = pg2pw.convert_g2pw_weights(renamed, cfg)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    with pytest.raises(KeyError, match="classifier"):
        pg2pw.convert_g2pw_weights(
            {k: v for k, v in state.items() if "classifier" not in k}, cfg)


def test_predictor_raises_without_a_card(g2pw_dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pg2pw.G2PWPredictor(g2pw_dirs["g2pW.pth"])


def test_frontend_builds_the_predictor_on_the_asked_device(
        g2pw_dirs, monkeypatch):
    """``_g2pw_predictor`` builds (and caches) the predictor where the JAX
    package builds one, on ``set_g2pw_device``'s device: the card by
    default, which raises here; the CPU when asked."""
    monkeypatch.delenv("EASEVOICE_DISABLE_G2PW", raising=False)
    monkeypatch.setenv("EASEVOICE_G2PW_DIR", g2pw_dirs["g2pW.pth"])
    try:
        pchinese.set_g2pw_device("cuda")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA card"):
                pchinese._g2pw_predictor()
        pchinese.set_g2pw_device("cpu")
        pred = pchinese._g2pw_predictor()
        assert pred is pchinese._g2pw_predictor()
        assert pred.model.classifier.weight.device.type == "cpu"
    finally:
        pchinese.set_g2pw_device("cuda")


def test_chip_smoke_tables_cover_its_sentences():
    """The G2PW tables chip_smoke writes hold at least 20 polyphonic
    characters that its Chinese sentences read."""
    text = chip_smoke.ZH_TEXT + chip_smoke.ZH_MIXED
    used = {ch for ch in chip_smoke.G2PW_POLYPHONES if ch in text}
    assert len(used - jg2pw.NON_POLYPHONIC) >= 20, sorted(used)
    assert all(ch in "".join(ZH_SENTENCES) + text
               for ch in chip_smoke.G2PW_MONOPHONES)
