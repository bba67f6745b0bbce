"""Data-parallel training of the PyTorch port (``parallel/``) on the CPU,
held to the JAX package.

Worlds of two ranks run over gloo as subprocesses started by the port's own
``parallel.distributed.launch`` (``tests/_torch_dist_worker.py``, a free
port on 127.0.0.1, a timeout of their own).  The global batches have other
lengths in their two halves, so a rank's share of a batch-wide ratio is not
half of it.  The s1 world is held to the JAX package's ``make_train_step``
on the global batch at ``tests/test_torch_s1.py``'s tolerances; the s2
world to the port's world of one on the global batch, which
``tests/test_torch_s2.py`` holds to JAX (a JAX s2 step compiles for
minutes).  With dropout both worlds draw their masks by the global batch
row.  The trainer runs end to end through ``cmd/train_gpt.py`` with
``EASEVOICE_DP=2`` on the CPU, under an import hook that refuses JAX in the
task and in its ranks.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from easevoice_trainer_tpu import parallel as jparallel
from easevoice_trainer_tpu.models.gpt import t2s as jt2s
from easevoice_trainer_tpu.train import gpt_step as jstep
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch import parallel
from easevoice_trainer_tpu_torch.cmd import train_gpt as cmd_gpt
from easevoice_trainer_tpu_torch.models.gpt.t2s import ATTENTION_KEY
from easevoice_trainer_tpu_torch.models.sovits import losses
from easevoice_trainer_tpu_torch.models.sovits import \
    MultiPeriodDiscriminator, SovitsConfig, SynthesizerTrn
from easevoice_trainer_tpu_torch.nn import layers
from easevoice_trainer_tpu_torch.ops import attention as att
from easevoice_trainer_tpu_torch.ops.stft import spectrogram
from easevoice_trainer_tpu_torch.parallel import distributed
from easevoice_trainer_tpu_torch.train import gpt as ptrain

import _torch_dist_worker as worker
from _torch_port_tiny import SOVITS_KW, T2S_KW, assert_close, tiny_gpt
from test_torch_s1 import JCFG, S1_KW, _jax_state
from test_trainers import workspace  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 120   # seconds a subprocess world may take

X_LEN, Y_LEN = 13, 21
X_LENS = [13, 9, 11, 4]
Y_LENS = [21, 17, 9, 3]     # rank 0's rows are long, rank 1's short
S1_SEED, S2_SEED = 7_000_003, 4_242
S2_LR, S2_STEPS = 2e-4, 2
SPEC_LENS = [16, 14, 9, 5]  # frames; rank 0 holds 30 of them, rank 1 14
TEXT_LENS = [6, 4, 5, 2]


def _s1_batch(seed):
    rng = np.random.default_rng(seed)
    b = len(X_LENS)
    x = rng.integers(1, 732, (b, X_LEN)).astype(np.int32)
    y = rng.integers(0, 1024, (b, Y_LEN)).astype(np.int32)
    for i, (xl, yl) in enumerate(zip(X_LENS, Y_LENS)):
        x[i, xl:] = 0
        y[i, yl:] = 0
    return {"phoneme_ids": x,
            "phoneme_ids_len": np.asarray(X_LENS, np.int32),
            "semantic_ids": y,
            "semantic_ids_len": np.asarray(Y_LENS, np.int32),
            "bert_feature": rng.normal(size=(b, X_LEN, 1024)).astype(
                np.float32)}


def _s2_batch(seed, frames=16):
    rng = np.random.default_rng(seed)
    b = len(SPEC_LENS)
    wav = rng.uniform(-0.5, 0.5, (b, frames * 640)).astype(np.float32)
    return {
        "ssl": rng.normal(size=(b, frames, SOVITS_KW["ssl_dim"])).astype(
            np.float32),
        "spec": spectrogram(torch.from_numpy(wav)).numpy(),
        "spec_lengths": np.asarray(SPEC_LENS, np.int32), "wav": wav,
        "text": rng.integers(1, 700, (b, 6)).astype(np.int32),
        "text_lengths": np.asarray(TEXT_LENS, np.int32)}


def _s2_nets(seed=5):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net_g = SynthesizerTrn(SovitsConfig(**{**SOVITS_KW,
                                               "p_dropout": 0.1}),
                               with_enc_q=True)
        net_d = MultiPeriodDiscriminator((2, 3))
    return net_g, net_d


def _specs():
    """The runs of the world: s1 without and with dropout (one accumulation
    window of 4 micro-batches), s2 with dropout (2 steps)."""
    model, params, _ = tiny_gpt(seed=22, **S1_KW)
    cfg = {**T2S_KW, **S1_KW}
    batches = [_s1_batch(300 + i) for i in range(4)]
    net_g, net_d = _s2_nets()
    s2 = {"mode": "s2", "cfg": {**SOVITS_KW, "p_dropout": 0.1},
          "state": net_g.state_dict(), "state_d": net_d.state_dict(),
          "periods": (2, 3), "segment_size": SOVITS_KW["segment_size"],
          "lr": S2_LR, "seed": S2_SEED,
          "batches": [_s2_batch(40 + i) for i in range(S2_STEPS)]}
    return params, [
        {"mode": "s1", "cfg": cfg, "state": model.state_dict(),
         "batches": batches, "seed": S1_SEED},
        {"mode": "s1", "cfg": {**cfg, "dropout": 0.1},
         "state": model.state_dict(), "batches": batches, "seed": S1_SEED},
        s2]


@pytest.fixture
def one_thread():
    """Torch on one thread for a test's in-process steps (the test workers
    share the cores, and oversubscribed threads slow the steps manyfold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX params of the s1 runs, the specs, every rank's results, the
    world of one's, the error of the world whose rank 1 failed) of one
    two-rank subprocess."""
    tmp = tmp_path_factory.mktemp("world")
    params, specs = _specs()
    torch.save(specs, str(tmp / "spec.pt"))
    env = dict(os.environ, PYTHONPATH=REPO, EASEVOICE_OPT_STATE="fp32",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "_torch_dist_worker.py"),
         str(tmp / "spec.pt"), str(tmp / "out.pt"), "2"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=WORLD_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = torch.load(str(tmp / "out.pt"), weights_only=False)
    return params, specs, out["ranks"], out["one"], out["failure"]


def _same_across_ranks(ranks, run):
    """Every rank reports the same metrics and holds the same weights."""
    a, b = (r[run] for r in ranks)
    assert a["metrics"] == b["metrics"]
    assert a["digest"] == b["digest"]


# ---- the row split ----------------------------------------------------------


@pytest.mark.parametrize("n_rows,world", [(8, 1), (8, 2), (12, 2), (8, 4),
                                          (12, 4), (16, 8), (24, 8)])
def test_process_local_rows_match_jax(n_rows, world):
    """A rank's rows are the block ``NamedSharding(mesh, P("data"))`` gives
    the device in its position of a ``world``-device data axis (conftest's
    virtual CPU devices); a world of one loads every row, as the JAX
    package's single-process identity."""
    mesh = jparallel.make_mesh(n_data=world, devices=jax.devices()[:world])
    sharding = NamedSharding(mesh, PartitionSpec(jparallel.DATA_AXIS))
    imap = sharding.devices_indices_map((n_rows,))
    for r, dev in enumerate(mesh.devices[:, 0]):
        want = list(range(n_rows)[imap[dev][0]])
        assert distributed.process_local_rows(n_rows, world, r) == want
    if world == 1:
        from easevoice_trainer_tpu.parallel import distributed as jdist

        assert distributed.process_local_rows(n_rows) == \
            jdist.process_local_rows(n_rows, mesh)
    with pytest.raises(ValueError, match="wrap-pad"):
        distributed.process_local_rows(n_rows + 1, 2, 0)


@pytest.mark.parametrize("n,multiple", [(5, 2), (8, 2), (3, 4), (7, 3),
                                        (1, 8), (6, 1)])
def test_wrap_pad_indices_match_jax(n, multiple):
    idxs = list(range(100, 100 + n))
    assert parallel.wrap_pad_indices(idxs, multiple) == \
        jparallel.wrap_pad_indices(idxs, multiple)
    assert parallel.local_batch_multiple(multiple) == multiple


@pytest.mark.parametrize("dp,device,want", [
    (None, "cpu", None), ("auto", "cpu", None), ("off", "cpu", None),
    ("1", "cpu", None), ("2", "cpu", 2), ("4", "cpu", 4),
    (None, "cuda", None), ("4", "cuda", None)])
def test_data_parallel_world_from_env(monkeypatch, dp, device, want):
    """``EASEVOICE_DP`` as the JAX ``data_parallel_mesh`` reads it: auto
    is no world on the CPU or with fewer than two cards (none here), N
    asks for N ranks (capped at the visible cards on CUDA), off / 1 turn
    it off."""
    monkeypatch.delenv("EASEVOICE_TP", raising=False)
    monkeypatch.delenv("EASEVOICE_NUM_PROCESSES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    if dp is None:
        monkeypatch.delenv("EASEVOICE_DP", raising=False)
    else:
        monkeypatch.setenv("EASEVOICE_DP", dp)
    assert parallel.data_parallel_world(device) == want


@pytest.mark.parametrize("dp", ["off", "2"])
def test_s2_world_ignores_tensor_parallel(monkeypatch, dp):
    """The s2 fine-tune is data-parallel only, as JAX's s2 trainer calls
    ``data_parallel_mesh``: ``EASEVOICE_TP=2`` gives its cmd the world it
    has without the flag."""
    monkeypatch.delenv("EASEVOICE_NUM_PROCESSES", raising=False)
    monkeypatch.setenv("EASEVOICE_DP", dp)
    monkeypatch.delenv("EASEVOICE_TP", raising=False)
    want = parallel.data_parallel_world("cpu")
    calls = []
    monkeypatch.setattr(distributed, "launch", lambda fn, args, n, **kw:
                        calls.append(n) or [None])
    monkeypatch.setattr("easevoice_trainer_tpu_torch.train.sovits."
                        "train_sovits", lambda p: calls.append("one"))
    from easevoice_trainer_tpu_torch.cmd import train_sovits as cmd_s2

    cmd_s2.main({"device": "cpu"})
    monkeypatch.setenv("EASEVOICE_TP", "2")
    assert parallel.data_parallel_world("cpu") == want
    cmd_s2.main({"device": "cpu"})
    assert calls == [want or "one"] * 2


@pytest.mark.parametrize("dp", ["auto", "off", "2"])
def test_s1_falls_back_on_one_card(monkeypatch, dp):
    """``EASEVOICE_TP=2`` on a pool of one card gives the s1 cmd JAX's
    fallback, ``train_mesh``'s ``data_parallel_mesh`` below two devices:
    no world, the single-process path, and no raise."""
    monkeypatch.delenv("EASEVOICE_NUM_PROCESSES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("EASEVOICE_TP", "2")
    monkeypatch.setenv("EASEVOICE_DP", dp)
    assert parallel.train_world("cuda") is None
    calls = []
    monkeypatch.setattr(distributed, "launch", lambda *a, **k: calls.append(
        "launch"))
    monkeypatch.setattr("easevoice_trainer_tpu_torch.train.gpt.train_gpt",
                        lambda p: calls.append(p.device))
    cmd_gpt.main({})
    assert calls == ["cuda"]


def test_single_process_has_no_world():
    """Outside a world nothing is initialized and every helper is the
    identity: the single-process path runs as before."""
    assert distributed.maybe_initialize("cpu") is False
    assert not distributed.initialized()
    assert distributed.world_size() == 1 and distributed.is_primary()
    assert distributed.batch_rows(8) is None
    assert distributed.process_local_rows(5) == list(range(5))
    assert distributed.rank_device("cpu") == torch.device("cpu")
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    assert distributed.reduce_gradients([p]) == 0
    assert torch.equal(p.grad, torch.full((3,), 2.0))
    v = {"loss": torch.tensor(1.5)}
    assert distributed.sum_across_ranks(v) is v


# ---- s1 ---------------------------------------------------------------------


def test_s1_two_ranks_match_jax(world, monkeypatch):
    """One accumulation window (4 micro-batches, ScaledAdam steps after the
    4th) on two ranks of 2 rows each against ``make_train_step`` on the
    global batch of 4: both ranks report the same loss, acc and grad_norm
    and hold bitwise the same weights; each micro-batch's loss within 1e-5
    relative, acc within 1e-6, grad_norm within 1e-4; every parameter
    after the window within 1e-4 relative (``test_torch_s1.py``)."""
    monkeypatch.setenv("EASEVOICE_OPT_STATE", "fp32")
    params, specs, ranks, _, _ = world
    _same_across_ranks(ranks, 0)
    hp = jstep.GPTTrainHP()
    state = _jax_state(params, hp)
    jax_step = jax.jit(jstep.make_train_step(
        jt2s.Text2SemanticDecoder(JCFG), hp))
    got = ranks[0][0]["metrics"]
    for i, batch in enumerate(specs[0]["batches"]):
        state, metrics = jax_step(state, batch, jax.random.PRNGKey(i))
        assert_close(got[i]["loss"], float(metrics["loss"]), 1e-5,
                     f"loss {i}")
        assert got[i]["acc"] == pytest.approx(float(metrics["acc"]),
                                              abs=1e-6)
        assert_close(got[i]["grad_norm"], float(metrics["grad_norm"]), 1e-4,
                     f"grad_norm {i}")
    want = convert.gpt_state_dict(jstep.params_tree(state))
    sd = ranks[1][0]["state"][0]
    assert set(sd) == set(want)
    for k, v in want.items():
        assert_close(sd[k].numpy(), v.numpy(), 1e-4, k)


def test_s1_dropout_masks_keyed_by_the_global_row(world):
    """With dropout 0.1 a rank draws the masks of its rows of the global
    batch: the attention's keep mask with ``row0`` equals the global mask's
    rows bit for bit (K1 / K5's twin), the other three sites' masks from a
    ``RankGenerator`` equal the global draw's rows, in step over several
    draws; and the two ranks' window equals the port's world of one on the
    global batch: losses within 1e-5 relative, grad norms within 1e-4,
    weights within 1e-4 relative (``test_torch_s1.py``'s rule: the key
    biases' gradients are zero up to rounding, and ScaledAdam scales what
    is left)."""
    _, _, ranks, of_one, _ = world
    _same_across_ranks(ranks, 1)
    h, t = S1_KW["n_heads"], X_LEN + Y_LEN
    for i in range(2):
        seed = ((S1_SEED + i) % 2 ** 64) ^ ATTENTION_KEY
        for layer in range(S1_KW["n_layers"]):
            glob = att.AttentionDropout(0.1, seed, layer).keep_mask(
                4, h, t, X_LEN, "cpu")
            for row0 in (0, 2):
                mine = att.AttentionDropout(0.1, seed, layer, row0).keep_mask(
                    2, h, t, X_LEN, "cpu")
                assert torch.equal(mine, glob[row0:row0 + 2])
            assert not torch.equal(glob[:2], glob[2:])
        gens = [torch.Generator().manual_seed(S1_SEED + i) for _ in range(3)]
        rank_gens = [layers.RankGenerator(gens[r], layers.BatchRows(2 * r, 4))
                     for r in (0, 1)]
        for shape in ((t, 64), (t, 128), (t, 64)):
            ones = torch.ones((4, *shape))
            glob = layers.dropout(ones, 0.1, True, gens[2])
            for r, g in enumerate(rank_gens):
                assert torch.equal(layers.dropout(ones[:2], 0.1, True, g),
                                   glob[2 * r:2 * r + 2])
    one = of_one[1]
    for i, (a, b) in enumerate(zip(ranks[0][1]["metrics"], one["metrics"])):
        assert_close(a["loss"], b["loss"], 1e-5, f"loss {i}")
        assert_close(a["grad_norm"], b["grad_norm"], 1e-4, f"grad_norm {i}")
    for k, v in ranks[0][1]["state"][0].items():
        assert_close(v.numpy(), one["state"][0][k].numpy(), 1e-4, k)


# ---- s2 ---------------------------------------------------------------------


def test_s2_two_ranks_match_world_of_one(world):
    """Two D-then-G steps with dropout 0.1 on two ranks of 2 rows (30 and
    14 valid frames) against the port's world of one on the global batch
    of 4: both ranks report the same metrics and hold bitwise the same
    weights; every loss and grad norm within 1e-5 relative; every
    parameter within 2.5 lr a step, absolute (Adam with eps 1e-9 moves a
    parameter whose gradient is zero up to rounding by +-lr either way:
    ``test_torch_s2.py``)."""
    _, _, ranks, of_one, _ = world
    _same_across_ranks(ranks, 2)
    one = of_one[2]
    for i, (a, b) in enumerate(zip(ranks[0][2]["metrics"], one["metrics"])):
        assert set(a) == set(b)
        for k in b:
            assert_close(a[k], b[k], 1e-5, f"step {i} {k}")
    for mine, ref in zip(ranks[1][2]["state"], one["state"]):
        for k, v in ref.items():
            np.testing.assert_allclose(
                mine[k].numpy(), v.numpy(), rtol=0,
                atol=2.5 * S2_LR * S2_STEPS, err_msg=k)


def test_s2_shares_and_not_a_mean_of_rank_ratios(one_thread):
    """The KL is a masked mean over the batch: each rank divides its masked
    sum by the world's mask count, and the shares add up to the global
    KL (1e-5); the mean of the ranks' own ratios, which is what averaged
    per-rank losses would give, is off by more than 1 % here, where the
    ranks hold 30 and 14 valid frames.  The draws of a ``RankGenerator``
    (slice starts, posterior noise, dropout masks) are the global forward's
    rows: equal slice starts, latents within 1e-5."""
    net_g, _ = _s2_nets()
    net_g.train()
    batch = worker._tensors(_s2_batch(40), list(range(4)))

    def forward(rows, gen):
        b = batch if rows is None else {
            k: v[rows.row0:rows.row0 + 2] for k, v in batch.items()}
        _, _, ids, y_mask, (z, z_p, m_p, logs_p, _, logs_q) = net_g(
            b["ssl"], b["spec"], b["spec_lengths"], b["text"],
            b["text_lengths"], generator=gen)
        return ids, y_mask, z, (z_p, logs_q, m_p, logs_p, y_mask)

    gen = torch.Generator()
    with torch.no_grad():
        ids, y_mask, z, terms = forward(None, gen.manual_seed(S2_SEED))
        kl = float(losses.kl_loss(*terms))
        count = y_mask.sum()
        shares, ratios = [], []
        for r in (0, 1):
            rows = layers.BatchRows(2 * r, 4)
            ids_r, _, z_r, terms_r = forward(rows, layers.RankGenerator(
                gen.manual_seed(S2_SEED), rows))
            assert torch.equal(ids_r, ids[2 * r:2 * r + 2])
            assert_close(z_r.numpy(), z[2 * r:2 * r + 2].numpy(), 1e-5,
                         f"latents of rank {r}")
            shares.append(float(losses.kl_loss(*terms_r, count)))
            ratios.append(float(losses.kl_loss(*terms_r)))
    assert_close(sum(shares), kl, 1e-5, "shares")
    assert abs(np.mean(ratios) - kl) > 1e-2 * abs(kl), (ratios, kl)


def test_a_failed_rank_fails_the_launch(world):
    """A rank that raises stops the world, and ``launch`` raises with its
    traceback."""
    failure = world[4]
    assert failure is not None
    assert "rank 1 of 2 failed" in failure
    assert "rank 1 planted a failure" in failure


# ---- the trainer ------------------------------------------------------------

REFUSE_JAX = '''import importlib.abc, sys


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("easevoice_trainer_tpu", "jax", "jaxlib",
                                  "flax"):
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, _Refuse())
'''


def _lines(out: str, prefix: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def test_gpt_trainer_two_ranks_end_to_end(workspace, tmp_path, one_thread):
    """``cmd/train_gpt.py`` with ``EASEVOICE_DP=2`` and ``"device": "cpu"``
    trains one epoch on two ranks (under a hook refusing JAX and the JAX
    package in the task and in both ranks): one response, one loss line
    every 10 micro-batches and one session-data line an epoch (rank 0's
    alone), one resume file and one export; the export equals a world of
    one's within one fp16 step (2^-10 relative: fp16 weights after 13
    ScaledAdam updates from gradients that differ in rounding; they came
    out equal when this was written)."""
    norm, project = workspace
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(REFUSE_JAX)
    base = dict(batch_size=8, total_epochs=1, save_every_epoch=1,
                train_input_dir=norm, project_dir=project, device="cpu")
    params = tmp_path / "params.json"
    params.write_text(json.dumps({**base, "output_model_name": "dp2"}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(hook), REPO]),
               EASEVOICE_DP="2", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "easevoice_trainer_tpu_torch.cmd.train_gpt",
         "-c", str(params)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=WORLD_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    resp = _lines(proc.stdout, "response-of-easevoice")
    assert len(resp) == 1, proc.stdout[-2000:]
    data = json.loads(resp[0].split(" ", 1)[1])
    assert data["status"] == "success", (data, proc.stderr[-3000:])
    steps = data["data"]["global_step"]
    assert steps == 13
    assert len(_lines(proc.stdout, "loss-of-easevoice")) == steps // 10
    assert len(_lines(proc.stdout, "session-data-of-easevoice")) == 1
    out_dir = ptrain.get_gpt_train_dir(project, "dp2")
    assert sorted(os.listdir(out_dir)) == ["dp2-e1.ckpt", "logs"]
    assert os.listdir(os.path.join(out_dir, "logs", "ckpt")) == [
        f"epoch=1-step={steps}.ckpt"]

    one = ptrain.GPTTrain(ptrain.GPTTrainParams(**base,
                                                output_model_name="dp1"))
    resp1 = one.train()
    assert resp1.ok and resp1.data["global_step"] == steps
    got = convert.load_torch_state_dict(data["data"]["model_path"])
    want = convert.load_torch_state_dict(resp1.data["model_path"])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].float().numpy(),
                                   v.float().numpy(), rtol=2 ** -10,
                                   atol=2 ** -24, err_msg=k)


def test_dpo_rejects_are_made_over_the_global_batch(workspace):
    """A rank makes DPO's rejected sequences from the global batch's
    semantic ids (``semantic_rows``, which loads no BERT feature) and keeps
    its rows: the ids and lengths are ``collate_gpt``'s for the same items,
    so the draws of ``make_reject_y`` are the world of one's."""
    norm, _ = workspace
    dataset = ptrain.data_mod.GPTDataset(norm)
    idxs = [5, 0, 17, 3, 3, 42]
    sem, lens = ptrain.semantic_rows(dataset, idxs, 40)
    batch = ptrain.data_mod.collate_gpt(
        [dataset.load_item(i) for i in idxs], 32, 40)
    np.testing.assert_array_equal(sem, batch["semantic_ids"])
    np.testing.assert_array_equal(lens, batch["semantic_ids_len"])


def test_gpt_trainer_rank_other_than_0_writes_nothing(workspace, monkeypatch,
                                                      capsys):
    """A rank other than 0 trains and writes no resume file, no export, no
    connector line and no session data, and answers with no model path."""
    norm, project = workspace
    monkeypatch.setattr(distributed, "is_primary", lambda: False)
    trainer = ptrain.GPTTrain(ptrain.GPTTrainParams(
        batch_size=32, total_epochs=1, save_every_epoch=1,
        train_input_dir=norm, output_model_name="r1", project_dir=project,
        device="cpu"))
    resp = trainer.train()
    assert resp.ok and resp.data["model_path"] == ""
    assert resp.data["global_step"] == 4
    assert os.listdir(trainer.output_dir) == ["logs"]
    assert os.listdir(trainer.ckpt_dir) == []
    assert "-of-easevoice" not in capsys.readouterr().out
