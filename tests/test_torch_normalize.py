"""The port's dataset normalization (normalization.py, service/normalize.py,
cmd/normalize.py) against the JAX package's, on the CPU at small widths.

One workspace, two ``zh`` rows and one ``en`` row over 16 kHz denoised
clips, goes through the JAX ``Normalize`` and the port's.  The weights are
carried as files both packages read: a BERT directory at the width the s1
loader reads (1024 wide, 2 layers of 16 heads of 64;
tests/_torch_bert_tiny.py), the tiny HuBERT of tests/_torch_port_tiny.py as
an HF directory, and a tiny s2G ``.pth`` (with ``enc_q``) beside a tiny
``configs/s2.json``.  Held:

* ``2-name2text.txt`` and ``6-name2semantic.tsv`` byte-identical;
* ``5-wav32k`` int16 identical;
* ``3-bert`` within 1e-4 absolute (tests/test_torch_bert.py's tolerance);
* ``4-cnhubert`` within 1e-4 of the largest JAX magnitude
  (tests/test_torch_hubert.py ``test_cnhubert_matches_jax``'s).

Then the port's s2 and s1 loaders read the port's folder, and
``cmd/normalize.py`` run as a subprocess with ``"device": "cpu"`` writes
the same folder.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from easevoice_trainer_tpu import native as jnative
from easevoice_trainer_tpu import normalization as jnorm
from easevoice_trainer_tpu.text import chinese as jchinese
from easevoice_trainer_tpu.utils import audio_io as jaudio
from easevoice_trainer_tpu_torch import native as pnative
from easevoice_trainer_tpu_torch import normalization as pnorm
from easevoice_trainer_tpu_torch.models.sovits import SovitsConfig, \
    SynthesizerTrn
from easevoice_trainer_tpu_torch.service.normalize import NormalizeService
from easevoice_trainer_tpu_torch.text import chinese as pchinese
from easevoice_trainer_tpu_torch.train import data as pdata
from easevoice_trainer_tpu_torch.utils.connector import RESP_PREFIX

from _torch_bert_tiny import TTS_BERT, ZH_SENTENCES, write_bert_dir
from _torch_port_tiny import HUBERT_KW, SOVITS_KW, _numpy_state, \
    assert_close, tiny_hubert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = ((ZH_SENTENCES[0], "zh", 1.3),
        ("Hello world, this is a test.", "en", 1.7),
        (ZH_SENTENCES[1], "zh", 2.1))
NAMES = [f"clip{i}.wav" for i in range(len(ROWS))]


def _write_workspace(root: str) -> str:
    os.makedirs(os.path.join(root, "refinements"))
    os.makedirs(os.path.join(root, "denoises"))
    rng = np.random.default_rng(0)
    lines = []
    for name, (text, lang, sec) in zip(NAMES, ROWS):
        jaudio.write_wav(os.path.join(root, "denoises", name),
                         rng.uniform(-0.4, 0.4, int(16000 * sec)).astype(
                             np.float32), 16000)
        lines.append(f"/data/denoises/{name}|{lang}|{text}")
    with open(os.path.join(root, "refinements", "refinement.list"), "w",
              encoding="utf8") as f:
        f.write("\n".join(lines))
    return root


def _write_models(root: str) -> dict:
    """BERT and HuBERT directories, an s2G .pth and configs/s2.json; the
    environment variables that name them."""
    bert_dir, _, _ = write_bert_dir(os.path.join(root, "bert"), **TTS_BERT)
    hub_dir = os.path.join(root, "hubert")
    os.makedirs(hub_dir)
    with open(os.path.join(hub_dir, "config.json"), "w") as f:
        json.dump({"conv_dim": list(HUBERT_KW["conv_dim"]),
                   "hidden_size": HUBERT_KW["hidden_size"],
                   "num_hidden_layers": HUBERT_KW["num_layers"],
                   "num_attention_heads": HUBERT_KW["num_heads"],
                   "intermediate_size": HUBERT_KW["intermediate_size"],
                   "num_conv_pos_embeddings": HUBERT_KW["pos_conv_kernel"],
                   "num_conv_pos_embedding_groups":
                       HUBERT_KW["pos_conv_groups"]}, f)
    _, _, state = tiny_hubert()
    torch.save({k: torch.from_numpy(v) for k, v in state.items()},
               os.path.join(hub_dir, "pytorch_model.bin"))
    base = os.path.join(root, "base")
    os.makedirs(os.path.join(base, "configs"))
    with open(os.path.join(base, "configs", "s2.json"), "w") as f:
        json.dump({"model": SOVITS_KW}, f)
    s2g = os.path.join(root, "s2G.pth")
    model = SynthesizerTrn(SovitsConfig(**SOVITS_KW), with_enc_q=True)
    torch.save({"weight": {k: torch.from_numpy(v) for k, v in
                           _numpy_state(model, 5).items()},
                "config": {}, "info": "random"}, s2g)
    return {"EASEVOICE_BASE_PATH": base, "bert_path": bert_dir,
            "cnhubert_path": hub_dir, "sovits_path": s2g,
            "EASEVOICE_DISABLE_G2PW": "1"}


def _point_jax_at(norm, env):
    # the JAX GlobalCFG is a process-wide singleton: name the files on the
    # instance instead of resetting it
    norm.bert_path = env["bert_path"]
    norm.cnhubert_path = env["cnhubert_path"]
    norm.s2g_path = env["sovits_path"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same workspace normalized by both packages: -> (JAX Normalize,
    port Normalize, env, root)."""
    root = str(tmp_path_factory.mktemp("normalize"))
    with pytest.MonkeyPatch.context() as mp:
        env = _write_models(root)
        for k, v in env.items():
            mp.setenv(k, v)
        mp.delenv("EASEVOICE_PINYIN_TABLE", raising=False)
        # both resample 32 kHz -> 16 kHz through the same (scipy) path
        mp.setattr(jnative, "_lib", None)
        mp.setattr(pnative, "_lib", None)
        for mod in (jchinese, pchinese):
            mod._backend.cache_clear()
            mod._g2pw_predictor.cache_clear()
        out = []
        for side in ("jax", "port"):
            ws = _write_workspace(os.path.join(root, side))
            norm = (jnorm.Normalize(ws, "out") if side == "jax"
                    else pnorm.Normalize(ws, "out", device="cpu"))
            if side == "jax":
                _point_jax_at(norm, env)
            for stage in (norm.text, norm.ssl, norm.token):
                resp = stage()
                assert resp.ok, (side, resp.message)
            out.append(norm)
        for mod in (jchinese, pchinese):
            mod._backend.cache_clear()
            mod._g2pw_predictor.cache_clear()
    return out[0], out[1], env, root


@pytest.mark.parametrize("name", ["2-name2text.txt", "6-name2semantic.tsv"])
def test_list_files_byte_identical(runs, name):
    jn, pn, _, _ = runs
    with open(os.path.join(jn.output_path, name), "rb") as f:
        want = f.read()
    with open(os.path.join(pn.output_path, name), "rb") as f:
        assert f.read() == want
    assert want.count(b"\n") == len(NAMES) + (name.endswith(".tsv"))


def test_wav32k_int16_identical(runs):
    jn, pn, _, _ = runs
    for name in NAMES:
        want, sr = jaudio.read_wav(os.path.join(jn.wav_dir, name))
        got, psr = jaudio.read_wav(os.path.join(pn.wav_dir, name))
        assert sr == psr == 32000
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["3-bert", "4-cnhubert"])
def test_features_match_jax(runs, kind):
    """The saved tensors: same shape, fp32, contiguous, on the CPU; within
    the stated tolerance.  3-bert holds the zh rows only."""
    jn, pn, _, _ = runs
    jdir, pdir = ((jn.bert_dir, pn.bert_dir) if kind == "3-bert"
                  else (jn.hubert_dir, pn.hubert_dir))
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    want_files = ([n + ".pt" for n, r in zip(NAMES, ROWS) if r[1] == "zh"]
                  if kind == "3-bert" else [n + ".pt" for n in NAMES])
    assert sorted(os.listdir(pdir)) == want_files
    for fname in want_files:
        want = torch.load(os.path.join(jdir, fname), weights_only=True)
        got = torch.load(os.path.join(pdir, fname), weights_only=True)
        assert got.dtype == want.dtype == torch.float32
        assert got.is_contiguous() and got.device.type == "cpu"
        assert got.shape == want.shape
        if kind == "3-bert":
            assert got.shape[0] == 1024
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-4)
        else:
            assert got.shape[:2] == (1, HUBERT_KW["hidden_size"])
            assert_close(got.numpy(), want.numpy(), 1e-4, fname)


def test_port_folder_loads_in_both_trainers(runs):
    """The port's s2 loader reads 2-name2text / 4-cnhubert / 5-wav32k, and
    its s1 loader 2-name2text / 6-name2semantic with the 3-bert features
    attached to the zh rows (zeros for the en row)."""
    _, pn, _, _ = runs
    s2 = pdata.S2Dataset(pn.output_path)
    names = [e.name for e in s2.examples]
    assert set(names) == set(NAMES)
    for i, e in enumerate(s2.examples[:len(NAMES)]):
        item = s2.load_item(i)
        want = torch.load(os.path.join(pn.hubert_dir, e.name + ".pt"),
                          weights_only=True)[0].numpy().T    # (T, C)
        n = min(len(want), len(item["ssl"]))
        assert abs(len(want) - len(item["ssl"])) <= 1
        np.testing.assert_array_equal(item["ssl"][:n], want[:n])
    s1 = pdata.GPTDataset(pn.output_path)
    seen = set()
    for i in range(len(s1)):
        item = s1.load_item(i)
        if item["name"] in seen:
            continue
        seen.add(item["name"])
        lang = ROWS[NAMES.index(item["name"])][1]
        bert = item["bert"]
        assert bert.shape == (len(item["phoneme_ids"]), 1024)
        if lang == "zh":
            want = torch.load(os.path.join(pn.bert_dir, item["name"] + ".pt"),
                              weights_only=True).numpy().T
            np.testing.assert_array_equal(bert, want)
            assert np.abs(bert).max() > 0
        else:
            assert not bert.any()
    assert seen == set(NAMES)


def _run_cmd(root, env, params):
    path = os.path.join(root, "params.json")
    with open(path, "w") as f:
        json.dump(params, f)
    proc_env = dict(os.environ, PYTHONPATH=REPO, **env)
    proc = subprocess.run(
        [sys.executable, "-m", "easevoice_trainer_tpu_torch.cmd.normalize",
         "-c", path], cwd=REPO, env=proc_env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(RESP_PREFIX + " ")]
    assert len(lines) == 1, proc.stdout[-3000:]
    return json.loads(lines[0][len(RESP_PREFIX) + 1:])


def test_normalize_cmd_subprocess_on_the_cpu(runs):
    """``python -m easevoice_trainer_tpu_torch.cmd.normalize -c params.json``
    with ``"device": "cpu"``: SUCCESS, the output path in the response, and
    the same list files as the in-process run."""
    _, pn, env, root = runs
    ws = _write_workspace(os.path.join(root, "cmd"))
    resp = _run_cmd(root, env, {"processing_path": ws,
                                "predefined_output_path": "out",
                                "device": "cpu"})
    assert resp["status"] == "success", resp
    out = resp["data"]["output_path"]
    assert out == os.path.join(ws, "out")
    for name in ("2-name2text.txt", "6-name2semantic.tsv"):
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(pn.output_path, name), "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("missing", ["bert", "cnhubert", "sovits"])
def test_failure_responses_match_jax(runs, missing, tmp_path, monkeypatch):
    """A missing model fails its stage with the JAX package's message, and
    the service stops at that stage."""
    _, _, env, _ = runs
    env = dict(env, **{f"{missing}_path": str(tmp_path / "absent")})
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(pnative, "_lib", None)
    got = []
    for side in ("jax", "port"):
        ws = _write_workspace(str(tmp_path / side))
        norm = (jnorm.Normalize(ws, "out") if side == "jax"
                else pnorm.Normalize(ws, "out", device="cpu"))
        if side == "jax":
            _point_jax_at(norm, env)
        resps = [stage() for stage in (norm.text, norm.ssl, norm.token)]
        got.append([(r.status, r.message.replace(ws, "")) for r in resps])
    assert got[0] == got[1]
    failed = {"bert": 0, "cnhubert": 1, "sovits": 2}[missing]
    assert [s for s, _ in got[1]].index("failed") == failed
    ws = _write_workspace(str(tmp_path / "service"))
    resp = NormalizeService(ws, "out", device="cpu").run()
    assert not resp.ok and resp.message == got[1][failed][1]


def test_entry_points_default_to_the_card(tmp_path):
    """Without ``device="cpu"`` the Normalize, the service and the cmd ask
    for the card, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    ws = _write_workspace(str(tmp_path / "ws"))
    for make in (lambda: pnorm.Normalize(ws, "out"),
                 lambda: NormalizeService(ws, "out")):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
    from easevoice_trainer_tpu_torch.cmd import normalize as cmd

    with pytest.raises(RuntimeError, match="no CUDA card"):
        cmd.main({"processing_path": ws})
    shutil.rmtree(ws)
