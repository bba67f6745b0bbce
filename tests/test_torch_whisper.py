"""The port's Whisper against the JAX package's on the CPU, at a tiny width
(2 + 2 layers, d 128, two heads of 64; ``tests/_torch_asr_tiny.py``): the
encoder, the teacher-forced decoder logits and the greedy ids against
``build_model`` / ``make_transcriber``, ``WhisperASR.transcribe`` and
``AudioService.asr`` in another language than zh against the JAX service,
and the port's byte-level BPE decoder against ``transformers``'
``WhisperTokenizer`` and ``WhisperTokenizerFast``."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easevoice_trainer_tpu.audiokit import asr_whisper as jw
from easevoice_trainer_tpu.service import audio as jaudio
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch.audiokit import asr_whisper as pw
from easevoice_trainer_tpu_torch.service import audio as paudio
from easevoice_trainer_tpu_torch.text.whisper_tokenizer import \
    WhisperTokenizer, bytes_to_unicode
from easevoice_trainer_tpu_torch.utils import paths, safetensors_io

from _torch_asr_tiny import WHISPER, WHISPER_TOKENIZER, write_clips, \
    write_whisper_dir

transformers = pytest.importorskip("transformers")

# a few hundred mel frames' worth of source positions: 200 (400 frames)
SHORT = dataclasses.replace(WHISPER, max_source_positions=200)


def _jax_cfg(cfg):
    return jw.WhisperConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def short_pair():
    """The port's Whisper at SHORT with seeded random weights (the decoder's
    positions 20 times larger, so greedy ids vary) and the JAX trees
    converted from its state dict."""
    model = pw.Whisper(SHORT).eval()
    state = convert.random_state_dict(model, torch.Generator().manual_seed(5))
    state["decoder.embed_positions.weight"] *= 20
    model.load_state_dict(state)
    hf = {"model." + k: v.numpy() for k, v in state.items()}
    trees = jw.convert_whisper_weights(hf, _jax_cfg(SHORT))
    return model, trees


def test_whisper_encoder_and_teacher_forced_logits_match_jax(short_pair):
    model, (enc_p, dec_p, cross_p) = short_pair
    encoder, decoder, crosskv = jw.build_model(_jax_cfg(SHORT))
    mel = np.random.default_rng(0).normal(size=(1, 80, 400)).astype(
        np.float32)
    j_enc = np.asarray(encoder.apply({"params": enc_p}, jnp.asarray(mel)))
    with torch.no_grad():
        enc = model.encoder(torch.from_numpy(mel))
    np.testing.assert_allclose(enc.numpy(), j_enc, rtol=0, atol=1e-4)

    tokens = np.asarray([[301, 302, 307, 311, 17, 99, 250, 4]], np.int32)
    cross = crosskv.apply({"params": cross_p}, jnp.asarray(j_enc))
    h, dk = SHORT.n_heads, SHORT.d_model // SHORT.n_heads
    empty = [{"k": jnp.zeros((1, SHORT.max_target_positions, h, dk)),
              "v": jnp.zeros((1, SHORT.max_target_positions, h, dk))}
             for _ in range(SHORT.decoder_layers)]
    q_pos = jnp.arange(tokens.shape[1])[:, None]
    k_pos = jnp.arange(SHORT.max_target_positions)[None, :]
    mask = jnp.where(k_pos <= q_pos, 0.0, -jnp.inf)[None, None]
    j_logits, _ = decoder.apply({"params": dec_p}, jnp.asarray(tokens),
                                jnp.asarray(j_enc), 0, empty, cross, mask)
    with torch.no_grad():
        state = model.decoder.start(enc)
        logits = model.decoder(torch.from_numpy(tokens).long(), 0, state)
        # one token at a time through the cache gives the same rows
        state = model.decoder.start(enc)
        steps = [model.decoder(torch.from_numpy(tokens[:, i:i + 1]).long(),
                               i, state) for i in range(tokens.shape[1])]
    j_logits = np.asarray(j_logits)
    np.testing.assert_allclose(logits.numpy(), j_logits, rtol=0, atol=1e-4)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), j_logits,
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("forced", [[301, 302, 307, 311], [301]])
def test_whisper_greedy_ids_match_make_transcriber(short_pair, forced):
    model, trees = short_pair
    mel = np.random.default_rng(1).normal(size=(1, 80, 400)).astype(
        np.float32)
    run = jw.make_transcriber(_jax_cfg(SHORT), *trees, max_new=24)
    tokens, n = run(jnp.asarray(mel), np.asarray(forced, np.int32), 300)
    want = np.asarray(tokens)[:int(n) + 1].tolist()
    got = model.greedy(torch.from_numpy(mel), forced, 300, 24)
    assert got == want
    assert len(set(got)) > 3


def test_whisper_state_dict_round_trips_through_the_jax_converter(
        short_pair):
    model, trees = short_pair
    back = convert.whisper_state_dict(*trees)
    state = model.state_dict()
    assert back.keys() == state.keys()
    for k in state:
        torch.testing.assert_close(back[k], state[k], rtol=0, atol=0)


@pytest.fixture(scope="module")
def whisper_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("whisper")
    write_whisper_dir(root)
    return str(root)


def test_whisper_asr_and_service_match_jax(whisper_dir, tmp_path,
                                           monkeypatch):
    """``WhisperASR.transcribe`` (30 s chunks, zero-padded; the weights
    from ``model.safetensors``, the tokenizer the port's own) gives the JAX
    class's text, with and without a language token; then both services
    over one folder in English write the same ``asr.list``."""
    jax_asr = jw.WhisperASR(whisper_dir)
    asr = pw.WhisperASR(whisper_dir, "cpu")
    assert jax_asr.available and asr.available
    for lang in ("en", "yue", None):
        assert asr._forced(lang).tolist() == jax_asr._forced(lang).tolist()
    clips = write_clips(tmp_path, seconds=(1.5, 2.2))
    assert asr.transcribe(clips[0], "en") == jax_asr.transcribe(clips[0],
                                                                "en")
    for key in ("EASEVOICE_PARAFORMER_DIR", "EASEVOICE_VAD_DIR",
                "EASEVOICE_PUNC_DIR"):
        monkeypatch.setenv(key, str(tmp_path / "absent"))
    monkeypatch.setenv("EASEVOICE_WHISPER_DIR", whisper_dir)
    texts = []
    for svc in (jaudio.AudioService(str(tmp_path), str(tmp_path)),
                paudio.AudioService(str(tmp_path), str(tmp_path), "cpu")):
        resp = svc.asr(language="en")
        assert resp.ok and resp.message == "asr success", resp
        assert list(resp.data) == clips
        with open(os.path.join(str(tmp_path), paths.ASRS_OUTPUT,
                               paths.ASR_FILE), encoding="utf8") as f:
            texts.append(f.read())
    # random weights decode to arbitrary bytes, newlines among them: the
    # files are compared whole
    assert texts[0] == texts[1]
    assert texts[1].startswith(clips[0] + "|en|")
    assert "\n" + clips[1] + "|en|" in texts[1]


def test_whisper_directory_without_weights_or_with_bad_ones(
        whisper_dir, tmp_path):
    """An absent directory, or one without weights, gives
    ``available=False``; weights that do not load raise (the JAX class
    logs it and reports ``available=False``)."""
    assert not pw.WhisperASR(str(tmp_path / "absent"), "cpu").available
    assert not pw.WhisperASR(str(tmp_path), "cpu").available
    import shutil

    bad = tmp_path / "bad"
    shutil.copytree(whisper_dir, bad)
    state = safetensors_io.load_file(str(bad / "model.safetensors"))
    del state["model.decoder.layers.1.fc2.bias"]
    safetensors_io.save_file(state, str(bad / "model.safetensors"))
    assert not jw.WhisperASR(str(bad)).available
    with pytest.raises(RuntimeError):
        pw.WhisperASR(str(bad), "cpu")


def test_whisper_reads_pytorch_model_bin(tmp_path):
    state = write_whisper_dir(tmp_path, seed=2, weights="pytorch_model.bin")
    asr = pw.WhisperASR(str(tmp_path), "cpu")
    for k, v in asr.model.state_dict().items():
        if k in state:
            torch.testing.assert_close(v, state[k], rtol=0, atol=0)


# ---- the byte-level BPE decoder --------------------------------------------------

def _slow_tokenizer(root):
    """transformers' slow WhisperTokenizer from vocab.json + merges.txt of
    the tiny tokenizer, the special tokens added as the released files
    add them, the timestamps as added tokens that are not special."""
    model = WHISPER_TOKENIZER["model"]
    with open(os.path.join(root, "vocab.json"), "w", encoding="utf8") as f:
        json.dump(model["vocab"], f, ensure_ascii=False)
    with open(os.path.join(root, "merges.txt"), "w", encoding="utf8") as f:
        f.write("#version: 0.2\n" + "\n".join(model["merges"]) + "\n")
    added = WHISPER_TOKENIZER["added_tokens"]
    special = [a["content"] for a in added if a["special"]]
    tok = transformers.WhisperTokenizer(
        os.path.join(root, "vocab.json"), os.path.join(root, "merges.txt"),
        unk_token="<|endoftext|>", bos_token="<|endoftext|>",
        eos_token="<|endoftext|>", additional_special_tokens=special[1:])
    tok.add_tokens([a["content"] for a in added if not a["special"]])
    assert len(tok) == WHISPER.vocab_size
    return tok


def test_whisper_tokenizer_decodes_as_transformers(whisper_dir, tmp_path):
    """Random id runs over pieces that split multi-byte UTF-8 characters,
    special tokens, timestamps and a ``<|startofprev|>`` prompt decode to
    the text of ``WhisperTokenizer`` (vocab.json + merges.txt) and of
    ``AutoTokenizer`` on the same ``tokenizer.json``, skip_special_tokens
    as the JAX ``WhisperASR`` asks; the forced-prompt lookups agree, an
    unknown token giving the unknown token's id."""
    slow = _slow_tokenizer(str(tmp_path))
    fast = transformers.AutoTokenizer.from_pretrained(whisper_dir)
    ours = WhisperTokenizer.from_pretrained(whisper_dir)
    byte = bytes_to_unicode()
    vocab = WHISPER_TOKENIZER["model"]["vocab"]
    ni = [vocab[byte[b] + byte[c]] for b, c in zip(
        "你好".encode(), "你好".encode()[1:]) if byte[b] + byte[c] in vocab]
    pieces = [vocab[byte[b]] for b in "你好 héllo, wörld.".encode()]
    rng = np.random.default_rng(0)
    cases = [pieces, pieces[:4] + [301, 302] + pieces[4:], ni + pieces]
    for i in range(200):
        ids = rng.integers(0, WHISPER.vocab_size, rng.integers(1, 24))
        ids = ids.tolist()
        if i % 4 == 0:
            ids = [ours.convert_tokens_to_ids("<|startofprev|>")] + ids
        if i % 8 == 0:
            ids += [301] + pieces
        cases.append(ids)
    for ids in cases:
        want = slow.decode(ids, skip_special_tokens=True)
        assert ours.decode(ids) == want, ids
        assert fast.decode(ids, skip_special_tokens=True) == want, ids
    assert "你好" in ours.decode(pieces)
    for token in ("<|startoftranscript|>", "<|en|>", "<|ko|>",
                  "<|transcribe|>", "<|notimestamps|>", "<|endoftext|>",
                  "<|0.02|>", "a"):
        assert ours.convert_tokens_to_ids(token) == \
            fast.convert_tokens_to_ids(token) == \
            slow.convert_tokens_to_ids(token), token
    # a token it does not hold: the unknown token's id, as AutoTokenizer's
    # fast tokenizer (the JAX WhisperASR's) gives it
    assert ours.convert_tokens_to_ids("<|yue|>") == \
        fast.convert_tokens_to_ids("<|yue|>") == \
        ours.convert_tokens_to_ids("<|endoftext|>")
