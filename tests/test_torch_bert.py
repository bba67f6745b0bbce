"""The port's BERT (models/bert.py), its WordPiece tokenizer and its
.safetensors reader against the JAX package and the ``transformers`` /
``safetensors`` packages they replace, on the CPU at a small width with the
encoders' head width (128 wide, 2 heads of 64, 2 layers).  Tolerances: 1e-4
absolute on hidden states and phone features (fp32; the JAX BERT scales q
before the product, the port's attention scales the scores); tokens, ids
and tensors read back must be identical."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from easevoice_trainer_tpu.models import bert as jbert
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch.models import bert as pbert
from easevoice_trainer_tpu_torch.text import cleaner as pcleaner
from easevoice_trainer_tpu_torch.text.bert_tokenizer import BertTokenizer, \
    loadable
from easevoice_trainer_tpu_torch.utils import safetensors_io

from _torch_bert_tiny import TINY_BERT, VOCAB, ZH_SENTENCES, write_bert_dir

ATOL = 1e-4

TOKENIZER_SENTENCES = [
    "我们都去了北京。",
    "Hello World, tests are testing!",
    "我们用Python写了一个voice cloning的小程序。",
    "你好，世界！（全角）：；“引号”",
    "12345 and 2026, 3.14",
    "Café naïve ÉCOLE Ümlaut\ttab\nline",
]


def _numpy_state(model, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: v.numpy() for k, v in
            convert.random_state_dict(model, gen).items()}


@pytest.fixture(scope="module")
def tiny():
    """(port BertModel loaded through convert.bert_state_dict, JAX params,
    the HF-named numpy state)."""
    model = pbert.BertModel(pbert.BertConfig(**TINY_BERT))
    state = _numpy_state(model, 0)
    params = jbert.convert_hf_bert(state)
    model.load_state_dict(convert.bert_state_dict(params), strict=True)
    return model.eval(), params, state


def _padded_batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, TINY_BERT["vocab_size"], (3, 24))
    mask = np.zeros((3, 24), np.int64)
    for i, n in enumerate((24, 17, 5)):
        mask[i, :n] = 1
    types = rng.integers(0, 2, (3, 24))
    return ids, mask, types


def test_bert_config_matches_jax(tmp_path):
    jf = [(f.name, f.default) for f in
          dataclasses.fields(jbert.BertConfig)]
    pf = [(f.name, f.default) for f in
          dataclasses.fields(pbert.BertConfig)]
    assert jf == pf
    (tmp_path / "config.json").write_text(json.dumps(dict(
        vocab_size=99, hidden_size=128, num_hidden_layers=3,
        num_attention_heads=2, intermediate_size=256,
        max_position_embeddings=64, type_vocab_size=2,
        layer_norm_eps=1e-7)))
    want = jbert.config_from_hf(str(tmp_path))
    assert pbert.config_from_hf(str(tmp_path)) == pbert.BertConfig(
        **dataclasses.asdict(want))


def test_bert_hidden_states_match_jax(tiny):
    """A padded batch (24, 17 and 5 valid tokens): every hidden state,
    pad rows included."""
    model, params, _ = tiny
    ids, mask, types = _padded_batch()
    want = jbert.BertModel(jbert.BertConfig(**TINY_BERT)).apply(
        {"params": params}, ids, mask, types)
    got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                torch.from_numpy(types))
    assert len(got) == len(want) == TINY_BERT["num_layers"] + 1
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0.5
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)


def test_bert_without_mask_and_rejected_mask(tiny):
    """No mask: every key visible (the JAX model with no pad bias).  A mask
    that is not a prefix of ones on its row is refused."""
    model, params, _ = tiny
    ids, _, _ = _padded_batch()
    want = jbert.BertModel(jbert.BertConfig(**TINY_BERT)).apply(
        {"params": params}, ids)
    got = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want[-1]),
                               rtol=0, atol=ATOL)
    holes = torch.ones(ids.shape, dtype=torch.int64)
    holes[0, 3] = 0
    with pytest.raises(ValueError, match="prefix"):
        model(torch.from_numpy(ids), holes)


def test_bert_state_dict_and_hf_load_agree(tiny):
    """convert.bert_state_dict of the JAX params, and a strict load of the
    HF-named state as a released checkpoint holds it (``bert.`` prefix, a
    pooler, the position_ids buffer), give the same model."""
    model, _, state = tiny
    released = {"bert." + k: torch.from_numpy(v) for k, v in state.items()}
    released["bert.pooler.dense.weight"] = torch.zeros(128, 128)
    released["bert.pooler.dense.bias"] = torch.zeros(128)
    released["bert.embeddings.position_ids"] = torch.arange(64)[None]
    other = pbert.BertModel(pbert.BertConfig(**TINY_BERT))
    other.load_state_dict(pbert.hf_state_for_load(released), strict=True)
    ids, mask, types = _padded_batch()
    args = (torch.from_numpy(ids), torch.from_numpy(mask),
            torch.from_numpy(types))
    for a, b in zip(model(*args), other.eval()(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _tokenizer_dir(root, source):
    """A tokenizer directory as transformers writes it, cut down to the
    vocabulary ``source`` (vocab.txt or tokenizer.json) and its config."""
    import transformers

    os.makedirs(root)
    full = os.path.join(root, "full")
    os.makedirs(full)
    with open(os.path.join(full, "vocab.txt"), "w", encoding="utf8") as f:
        f.write("\n".join(VOCAB) + "\n")
    transformers.BertTokenizerFast(
        os.path.join(full, "vocab.txt")).save_pretrained(full)
    out = os.path.join(root, source)
    os.makedirs(out)
    for name in (source, "tokenizer_config.json"):
        os.replace(os.path.join(full, name), os.path.join(out, name))
    return out


@pytest.fixture(scope="module", params=["vocab.txt", "tokenizer.json"])
def tokenizers(request, tmp_path_factory):
    """(port, transformers.BertTokenizer, AutoTokenizer) over one
    vocabulary; the port and AutoTokenizer read the directory, which holds
    only ``source`` and tokenizer_config.json."""
    import transformers

    root = tmp_path_factory.mktemp("tok")
    path = _tokenizer_dir(str(root / "t"), request.param)
    vocab = os.path.join(str(root), "vocab.txt")
    with open(vocab, "w", encoding="utf8") as f:
        f.write("\n".join(VOCAB) + "\n")
    assert loadable(path)
    return (BertTokenizer.from_pretrained(path),
            transformers.BertTokenizer(vocab),
            transformers.AutoTokenizer.from_pretrained(path))


@pytest.mark.parametrize("sentence", TOKENIZER_SENTENCES)
def test_tokenizer_matches_transformers(tokenizers, sentence):
    port, slow, auto = tokenizers
    got = port.tokenize(sentence)
    assert got == slow.tokenize(sentence) == auto.tokenize(sentence)
    enc = port(sentence)
    for ref in (slow, auto):
        want = ref(sentence)
        assert enc["input_ids"] == want["input_ids"]
        assert enc["attention_mask"] == want["attention_mask"]
    assert port.convert_tokens_to_ids(got) == \
        slow.convert_tokens_to_ids(got)


@pytest.mark.parametrize("files,ok", [
    ({"vocab.txt": "x", "config.json": '{"model_type": "bert"}'}, True),
    ({"vocab.txt": "x", "tokenizer_config.json":
      '{"tokenizer_class": "BertTokenizer"}'}, True),
    ({"vocab.txt": "x"}, False),
    ({"vocab.txt": "x", "tokenizer_config.json": "{}"}, False),
    ({"config.json": '{"model_type": "bert"}'}, False),
])
def test_tokenizer_loadable_where_autotokenizer_loads(files, ok, tmp_path):
    """A vocabulary and a config naming a BERT tokenizer (class or model
    type): the layouts AutoTokenizer.from_pretrained takes locally."""
    import transformers

    for name, text in files.items():
        (tmp_path / name).write_text(
            "\n".join(VOCAB) if name == "vocab.txt" else text,
            encoding="utf8")
    assert loadable(str(tmp_path)) is ok
    try:
        transformers.AutoTokenizer.from_pretrained(str(tmp_path))
        loads = True
    except Exception:
        loads = False
    assert loads is ok


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64])
def test_safetensors_reader_matches_package(dtype, tmp_path):
    """Files written by the safetensors package read back equal (floats as
    fp32); numpy has no bfloat16, so BF16 is held to the torch loader.  The
    port's writer makes a file the package reads back equal."""
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as torch_load
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(3)
    tensors = {"a.weight": torch.randn((5, 7), generator=gen),
               "b": torch.randn((3,), generator=gen),
               "empty": torch.zeros((0, 4))}
    tensors = {k: (v * 100).to(dtype) for k, v in tensors.items()}
    path = str(tmp_path / "m.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = safetensors_io.load_file(path)
    if dtype == torch.bfloat16:
        want = {k: v.float() for k, v in torch_load(path).items()}
    else:
        want = {k: torch.from_numpy(v.astype(np.float32)
                                    if v.dtype.kind == "f" else v)
                for k, v in np_load(path).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    out = str(tmp_path / "port.safetensors")
    safetensors_io.save_file(tensors, out)
    back = torch_load(out)
    for k in tensors:
        torch.testing.assert_close(back[k], tensors[k], rtol=0, atol=0)


@pytest.mark.parametrize("weights", ["pytorch_model.bin",
                                     "model.safetensors"])
def test_phone_features_match_jax(weights, tmp_path, monkeypatch):
    """BertFeatureExtractor.phone_features on a directory as HF lays it out
    (config.json, vocab.txt, weights): equal to the JAX extractor's on the
    norm text and word2ph of ``clean_text``."""
    monkeypatch.setenv("EASEVOICE_DISABLE_G2PW", "1")
    model_dir, cfg, _ = write_bert_dir(tmp_path / "bert", weights=weights)
    jx = jbert.BertFeatureExtractor(model_dir)
    px = pbert.BertFeatureExtractor(model_dir, "cpu")
    assert jx.available and px.available
    for text in ZH_SENTENCES:
        _, word2ph, norm = pcleaner.clean_text(text, "zh")
        want = jx.phone_features(norm, word2ph)
        got = px.phone_features(norm, word2ph)
        assert got.shape == want.shape == (cfg.hidden_size, sum(word2ph))
        assert np.abs(want).max() > 0.5
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("files", [("pytorch_model.bin",), ("vocab.txt",),
                                   ()])
def test_phone_features_zero_where_jax_gives_zero(files, tmp_path):
    """Without weights or a tokenizer both extractors are unavailable and
    give zeros of the right shape."""
    model_dir, cfg, _ = write_bert_dir(tmp_path / "bert")
    for name in ("pytorch_model.bin", "vocab.txt"):
        if name not in files:
            os.remove(os.path.join(model_dir, name))
    jx = jbert.BertFeatureExtractor(model_dir)
    px = pbert.BertFeatureExtractor(model_dir, "cpu")
    assert not jx.available and not px.available
    word2ph = [2, 2, 1]
    want = jx.phone_features("我们.", word2ph)
    np.testing.assert_array_equal(px.phone_features("我们.", word2ph), want)
    assert want.shape == (cfg.hidden_size, 5)


def test_extractor_raises_without_a_card(tmp_path):
    """The card is the default device; without one the extractor raises
    instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    model_dir, _, _ = write_bert_dir(tmp_path / "bert")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pbert.BertFeatureExtractor(model_dir)
