"""Tensor parallelism of the PyTorch port's s1 GPT fine-tune
(``parallel/gpt_sharding.py`` and the grid of ``parallel/``) on the CPU,
held to the JAX package.

A tiny GPT (2 layers, width 64, 4 heads of dk 16, FFN 128) runs on a grid
of data 2 x model 2 gloo ranks, started as a subprocess by the port's own
``parallel.distributed.launch`` (``tests/_torch_tp_worker.py``, a timeout
of its own): each model group holds 2 heads and 64 FFN columns a rank, and
the global batches of 4 rows have other lengths in their two halves.  The
fp32 window and the DPO window are held to JAX's ``make_train_step`` with
the state placed per ``gpt_packed_specs`` on a 2 x 2 ``make_mesh`` of the
forced host devices (as ``train/gpt.py:213-221`` places it) at
``tests/test_torch_distributed.py``'s tolerances; the dropout window to the
port's world of one on the global batch.  The grid's shape is held to
``train_mesh`` and its rows to ``NamedSharding(mesh, P("data"))``; the
trainer runs end to end through ``cmd/train_gpt.py`` with
``EASEVOICE_DP=2 EASEVOICE_TP=2`` under an import hook that refuses JAX.
JAX is imported here for the references alone, never inside the port.
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
from easevoice_trainer_tpu.models.gpt import dpo as jdpo
from easevoice_trainer_tpu.models.gpt import t2s as jt2s
from easevoice_trainer_tpu.parallel import gpt_sharding as jsharding
from easevoice_trainer_tpu.parallel import mesh as jmesh
from easevoice_trainer_tpu.train import ckpt as jckpt
from easevoice_trainer_tpu.train import gpt_step as jstep
from easevoice_trainer_tpu_torch import convert, parallel
from easevoice_trainer_tpu_torch.models.gpt import T2SConfig, \
    Text2SemanticDecoder
from easevoice_trainer_tpu_torch.models.gpt.t2s import ATTENTION_KEY
from easevoice_trainer_tpu_torch.nn import layers
from easevoice_trainer_tpu_torch.ops import attention as att
from easevoice_trainer_tpu_torch.parallel import distributed, gpt_sharding
from easevoice_trainer_tpu_torch.train import gpt as ptrain

from _torch_port_tiny import T2S_KW, assert_close, tiny_gpt
from test_torch_distributed import REFUSE_JAX, _lines, _s1_batch, \
    one_thread  # noqa: F401  (a fixture)
from test_torch_s1 import _jax_state
from test_trainers import workspace  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 150   # seconds a subprocess world may take

TP_KW = dict(embedding_dim=64, hidden_dim=64, n_heads=4, n_layers=2,
             ffn_dim=128)
CFG = {**T2S_KW, **TP_KW}
JCFG = jt2s.T2SConfig(**CFG)
N_DATA, N_MODEL = 2, 2
B = 4                        # global rows: 2 a data index
SEED = 9_000_011
DROPOUT = 0.1


def _dpo_batches(batches):
    """The windows' batches with DPO's rejected sequences, made over the
    global batch as the trainer makes them."""
    out = []
    for i, b in enumerate(batches):
        rej, rej_lens = jdpo.make_reject_y(
            b["semantic_ids"], b["semantic_ids_len"],
            np.random.default_rng(SEED + i),
            max_len=b["semantic_ids"].shape[1])
        out.append({**b, "reject_semantic_ids": rej,
                    "reject_semantic_ids_len": rej_lens})
    return out


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """(JAX params, the specs, every rank's results, the world of one's)
    of one data 2 x model 2 subprocess world running: f and g; the s1
    window in fp32 (4 micro-batches, ScaledAdam, a 5th micro-batch); the
    same with dropout 0.1; the same with DPO."""
    tmp = tmp_path_factory.mktemp("grid")
    model, params, _ = tiny_gpt(seed=31, **TP_KW)
    batches = [_s1_batch(500 + i) for i in range(5)]
    s1 = {"mode": "s1", "cfg": CFG, "state": model.state_dict(),
          "batches": batches, "seed": SEED}
    specs = [{"mode": "fg", "seed": 5}, s1,
             {**s1, "cfg": {**CFG, "dropout": DROPOUT}},
             {**s1, "batches": _dpo_batches(batches),
              "hp": {"if_dpo": True}}]
    torch.save(specs, str(tmp / "spec.pt"))
    env = dict(os.environ, PYTHONPATH=REPO, EASEVOICE_OPT_STATE="fp32",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "_torch_tp_worker.py"),
         str(tmp / "spec.pt"), str(tmp / "out.pt"), str(N_DATA),
         str(N_MODEL)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=WORLD_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = torch.load(str(tmp / "out.pt"), weights_only=False)
    return params, specs, out["ranks"], out["one"]


def _groups_agree(ranks, run):
    """Every rank reports the same metrics and whole weights; the ranks of
    each model group hold bitwise the same replicated weights, and the
    step's whole state loads into a fresh shard and comes back bit for
    bit."""
    first = ranks[0][run]
    for r in ranks:
        got = r[run]
        assert got["metrics"] == first["metrics"]
        assert got["round_trip"]
        for k, v in first["whole"].items():
            assert torch.equal(got["whole"][k], v), k
    for d in range(N_DATA):
        group = [ranks[d * N_MODEL + m][run] for m in range(N_MODEL)]
        assert len({g["rep_digest"] for g in group}) == 1


def _not_keys(name, t):
    """``t`` without the attention's key biases (the middle third of a
    fused qkv bias)."""
    if not name.endswith("in_proj_bias"):
        return t
    d = t.shape[0] // 3
    return torch.cat([t[:d], t[2 * d:]])


def _jax_window(params, batches, hp):
    """JAX's ``make_train_step`` over the window, the state placed per
    ``gpt_packed_specs`` on a data 2 x model 2 mesh and the batches sharded
    over its data axis: (metrics a micro-batch, the port's state dict of
    the parameters after)."""
    mesh = jparallel.make_mesh(n_data=N_DATA, n_model=N_MODEL,
                               devices=jax.devices()[:N_DATA * N_MODEL])
    state = _jax_state(params, hp)
    pspecs = jsharding.gpt_packed_specs(state.arena)
    rep = NamedSharding(mesh, PartitionSpec())
    state = state.replace(
        params={k: jax.device_put(v, NamedSharding(mesh, pspecs[k]))
                for k, v in state.params.items()},
        opt_state=jax.device_put(state.opt_state, rep),
        step=jax.device_put(state.step, rep))
    step = jax.jit(jstep.make_train_step(jt2s.Text2SemanticDecoder(JCFG),
                                         hp))
    metrics = []
    for i, batch in enumerate(batches):
        state, m = step(state, jparallel.shard_batch(batch, mesh),
                        jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, convert.gpt_state_dict(jstep.params_tree(state))


def _hold_updates(got, want, before):
    """A parameter moves by some 1e-5 in a window, below the tolerance of
    its value, so each parameter's update (after - ``before``) is held to
    the reference's, within 1e-2 of its norm: all of it but the
    attention's key biases, whose gradient is zero up to rounding (softmax
    ignores a shift of a row's scores) and whose update is ScaledAdam's
    step on that rounding."""
    for k, v in want.items():
        moved, ref = (_not_keys(k, t - before[k]) for t in (got[k], v))
        err = float((moved - ref).norm() / ref.norm())
        assert err <= 1e-2, (k, err)


def _hold_to_jax(got, want_metrics, want_state, before):
    """test_torch_distributed's tolerances: loss 1e-5 relative, acc 1e-6,
    grad_norm 1e-4; every gathered parameter within 1e-4 relative, and its
    update within 1e-2 (:func:`_hold_updates`)."""
    for i, (a, b) in enumerate(zip(got["metrics"], want_metrics)):
        assert_close(a["loss"], b["loss"], 1e-5, f"loss {i}")
        assert a["acc"] == pytest.approx(b["acc"], abs=1e-6)
        assert_close(a["grad_norm"], b["grad_norm"], 1e-4, f"grad_norm {i}")
    assert set(got["whole"]) == set(want_state)
    for k, v in want_state.items():
        assert_close(got["whole"][k].numpy(), v.numpy(), 1e-4, k)
    _hold_updates(got["whole"], want_state, before)


# ---- the grid ---------------------------------------------------------------

GRID_ENVS = [("2", 2), ("2", 1), ("off", 4), ("auto", 2), ("off", 1),
             ("auto", 16), ("2", 16), ("3", 2), ("8", 2), ("off", 2)]


@pytest.mark.parametrize("pool", [1, 2, 4, 8])
@pytest.mark.parametrize("dp,tp", GRID_ENVS)
def test_train_grid_matches_train_mesh(monkeypatch, pool, dp, tp):
    """``train_grid`` over a pool of ``pool`` devices is the shape of JAX's
    ``train_mesh()`` over the first ``pool`` forced host devices (None for
    no mesh), for test_trainers.py's combinations, TP above the pool and
    TP 1.  (``EASEVOICE_DP=auto`` with TP 1 is left out: JAX's
    ``data_parallel_mesh`` gives no mesh on its CPU platform, which
    ``test_train_world_on_the_cpu`` holds.)"""
    devices = jax.devices()[:pool]
    monkeypatch.setattr(jmesh.jax, "devices", lambda *a, **k: devices)
    monkeypatch.setenv("EASEVOICE_DP", dp)
    monkeypatch.setenv("EASEVOICE_TP", str(tp))
    mesh = jmesh.train_mesh()
    want = None if mesh is None else (mesh.shape["data"],
                                      mesh.shape["model"])
    assert parallel.train_grid(pool, dp, tp) == want


@pytest.mark.parametrize("dp,tp,want", [
    (None, None, None), ("auto", "2", (1, 2)), ("off", "2", (1, 2)),
    ("2", "2", (2, 2)), ("2", "1", (2, 1)), ("auto", "1", None),
    ("off", "4", (1, 4)), ("3", "2", (3, 2)), ("2", "x", (2, 1))])
def test_train_world_on_the_cpu(monkeypatch, dp, tp, want):
    """On the CPU a rank is a process, so the grid is what is asked for:
    n_model = TP, n_data = N for ``EASEVOICE_DP=N`` and 1 for auto / off;
    TP 1 (or not an integer, as JAX reads it) is the data-parallel world."""
    monkeypatch.delenv("EASEVOICE_NUM_PROCESSES", raising=False)
    for flag, val in (("EASEVOICE_DP", dp), ("EASEVOICE_TP", tp)):
        if val is None:
            monkeypatch.delenv(flag, raising=False)
        else:
            monkeypatch.setenv(flag, val)
    assert parallel.train_world("cpu") == want


def test_grid_rows_match_named_sharding(grid):
    """Rank r sits at (r // 2, r % 2) as ``make_mesh`` places device
    d * n_model + m, and loads the rows ``NamedSharding(mesh, P("data"))``
    gives ``mesh.devices[d, m]``: in the live 2 x 2 world and by
    ``process_local_rows`` over 4, 8 and 12 rows."""
    mesh = jparallel.make_mesh(n_data=N_DATA, n_model=N_MODEL,
                               devices=jax.devices()[:N_DATA * N_MODEL])
    sharding = NamedSharding(mesh, PartitionSpec(jparallel.DATA_AXIS))
    for n_rows in (B, 8, 12):
        imap = sharding.devices_indices_map((n_rows,))
        for r in range(N_DATA * N_MODEL):
            d, m = distributed.grid_position(r, N_MODEL)
            assert mesh.devices[d, m] == jax.devices()[r]
            want = list(range(n_rows)[imap[mesh.devices[d, m]][0]])
            assert distributed.process_local_rows(n_rows, N_DATA, d) == want
            if n_rows == B:
                assert grid[2][r][1]["grid"] == (r, d, m, want)


# ---- the shards -------------------------------------------------------------


def _flax_path(name, shape):
    tree, unmatched = jckpt.torch_to_flax({name: np.zeros(shape, np.float32)},
                                          jckpt.gpt_rules())
    assert not unmatched, name
    (path,) = jckpt.flatten_tree(tree)
    return path


def test_shard_class_matches_jax():
    """Every GPT parameter's shard class is JAX's ``shard_class`` of its
    flax path (through the ckpt name rules); the shard's parameter shapes
    are those of ``shard_state_dict``."""
    whole = Text2SemanticDecoder(T2SConfig(**CFG)).state_dict()
    classes = {}
    for k, v in whole.items():
        path = _flax_path(k, tuple(v.shape))
        classes[k] = gpt_sharding.shard_class(k)
        assert classes[k] == jsharding.shard_class(path.split("/")), k
    assert set(classes.values()) == set(gpt_sharding.SHARD_CLASSES)
    for m in range(N_MODEL):
        shard = Text2SemanticDecoder(T2SConfig(**CFG), tp=(m, N_MODEL))
        shard.load_state_dict(gpt_sharding.shard_state_dict(whole, m,
                                                            N_MODEL))


@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_shards_round_trip(n_model):
    """``gather_state_dicts`` of the ``shard_state_dict`` of every model
    index gives the whole state dict back exactly, and
    ``convert.gpt_shard_state_dict`` carries JAX params to a shard."""
    model, params, _ = tiny_gpt(seed=32, **TP_KW)
    whole = model.state_dict()
    shards = [gpt_sharding.shard_state_dict(whole, m, n_model)
              for m in range(n_model)]
    back = gpt_sharding.gather_state_dicts(shards)
    assert set(back) == set(whole)
    for k, v in whole.items():
        assert torch.equal(back[k], v), k
    for m in range(n_model):
        got = convert.gpt_shard_state_dict(params, m, n_model)
        for k, v in shards[m].items():
            assert torch.equal(got[k], v), k


def test_sharded_qkv_holds_its_own_heads():
    """A shard's fused projection is [q_m | k_m | v_m]: its q, k and v
    columns of an input are the whole projection's columns of heads
    m * H / n_model .., not a contiguous third of 3D."""
    model, _, _ = tiny_gpt(seed=33, **TP_KW)
    whole = model.h.layers[0].self_attn
    x = torch.randn(3, 7, CFG["hidden_dim"],
                    generator=torch.Generator().manual_seed(1))
    full = torch.nn.functional.linear(x, whole.in_proj_weight,
                                      whole.in_proj_bias)
    d, h = CFG["hidden_dim"], CFG["n_heads"]
    dk = d // h
    for m in range(N_MODEL):
        sd = gpt_sharding.shard_state_dict(model.state_dict(), m, N_MODEL)
        pre = "h.layers.0.self_attn."
        mine = torch.nn.functional.linear(x, sd[pre + "in_proj_weight"],
                                          sd[pre + "in_proj_bias"])
        heads = h // N_MODEL
        cols = torch.arange(m * heads * dk, (m + 1) * heads * dk)
        want = torch.cat([full[..., part * d + cols] for part in range(3)],
                         -1)
        assert torch.equal(mine, want)


def test_f_and_g_gradients(grid):
    """Megatron's f and g around a column- and a row-parallel product, in
    each model group of two ranks: the output and the input's gradient
    equal the world of one's autograd, and each rank's weight gradients
    are its rows / columns of the whole ones, within 1e-6 relative.  A g
    whose backward sums again would double them."""
    _, _, ranks, one = grid
    ref = one[0]
    for r, res in enumerate(ranks):
        got = res[0]
        m = r % N_MODEL
        f = ref["dw1"].shape[0] // N_MODEL
        assert_close(got["y"].numpy(), ref["y"].numpy(), 1e-6, "y")
        assert_close(got["dx"].numpy(), ref["dx"].numpy(), 1e-6, "dx")
        assert_close(got["dw1"].numpy(),
                     ref["dw1"][m * f:(m + 1) * f].numpy(), 1e-6, "dw1")
        assert_close(got["dw2"].numpy(),
                     ref["dw2"][:, m * f:(m + 1) * f].numpy(), 1e-6, "dw2")


# ---- the s1 step ------------------------------------------------------------


def test_s1_grid_matches_jax(grid, monkeypatch):
    """One accumulation window (4 micro-batches, ScaledAdam after the 4th,
    then a 5th micro-batch on the updated weights) on the data 2 x model 2
    grid against JAX's step with ``gpt_packed_specs`` placement on a 2 x 2
    mesh: loss within 1e-5 relative, acc 1e-6, grad_norm 1e-4, every
    gathered parameter 1e-4 and its update 1e-2; every rank reports the
    same metrics and whole weights, and the replicated weights are bitwise
    equal across each model group."""
    monkeypatch.setenv("EASEVOICE_OPT_STATE", "fp32")
    params, specs, ranks, _ = grid
    _groups_agree(ranks, 1)
    _hold_to_jax(ranks[0][1], *_jax_window(params, specs[1]["batches"],
                                           jstep.GPTTrainHP()),
                 specs[1]["state"])


def test_s1_dpo_grid_matches_jax(grid, monkeypatch):
    """One DPO window (rejected sequences made over the global batch, the
    rows of each data index taken from it) on the grid against JAX's DPO
    step with the same placement, at the same tolerances."""
    monkeypatch.setenv("EASEVOICE_OPT_STATE", "fp32")
    params, specs, ranks, _ = grid
    _groups_agree(ranks, 3)
    _hold_to_jax(ranks[0][3], *_jax_window(
        params, specs[3]["batches"], jstep.GPTTrainHP(if_dpo=True)),
        specs[3]["state"])


def test_s1_dropout_grid_draws_the_world_of_ones_masks(grid):
    """With dropout 0.1 a rank draws the whole model's masks for its rows:
    the attention keep mask of its heads (``h0``) and rows (``row0``)
    equals the global mask's block bit for bit (K1 / K5's twin), and the
    FFN hidden layer's mask from a ``RankGenerator`` with its column block
    equals the global draw's rows and columns, in step over several draws.
    The grid's window equals the port's world of one on the global batch:
    losses within 1e-5 relative, grad norms 1e-4, every weight within 1e-5
    relative but the attention's key biases, 1e-4 (their gradient is zero
    up to rounding, as softmax ignores a shift of a row's scores, and
    ScaledAdam scales what is left to a step of the lr's size:
    ``test_torch_s1.py``'s rule); every update within 1e-2 of its norm."""
    _, specs, ranks, one = grid
    _groups_agree(ranks, 2)
    h, t, heads = CFG["n_heads"], 13 + 21, CFG["n_heads"] // N_MODEL
    rows = B // N_DATA
    for i in range(2):
        seed = ((SEED + i) % 2 ** 64) ^ ATTENTION_KEY
        for layer in range(CFG["n_layers"]):
            glob = att.AttentionDropout(DROPOUT, seed, layer).keep_mask(
                B, h, t, 13, "cpu")
            for d in range(N_DATA):
                for m in range(N_MODEL):
                    mine = att.AttentionDropout(
                        DROPOUT, seed, layer, d * rows, m * heads).keep_mask(
                            rows, heads, t, 13, "cpu")
                    assert torch.equal(mine, glob[d * rows:(d + 1) * rows,
                                                  m * heads:(m + 1) * heads])
        f = CFG["ffn_dim"] // N_MODEL
        gens = [torch.Generator().manual_seed(SEED + i)
                for _ in range(N_DATA * N_MODEL + 1)]
        ones = torch.ones((B, t, CFG["ffn_dim"]))
        for _ in range(3):
            glob = layers.dropout(ones, DROPOUT, True, gens[-1])
            for r in range(N_DATA * N_MODEL):
                d, m = distributed.grid_position(r, N_MODEL)
                g = layers.RankGenerator(gens[r], layers.BatchRows(
                    d * rows, B, m, N_MODEL)).column_block()
                got = layers.dropout(ones[:rows, :, :f], DROPOUT, True, g)
                assert torch.equal(got, glob[d * rows:(d + 1) * rows, :,
                                             m * f:(m + 1) * f])
    ref = one[2]
    for i, (a, b) in enumerate(zip(ranks[0][2]["metrics"], ref["metrics"])):
        assert_close(a["loss"], b["loss"], 1e-5, f"loss {i}")
        assert_close(a["grad_norm"], b["grad_norm"], 1e-4, f"grad_norm {i}")
    for k, v in ref["whole"].items():
        got = ranks[0][2]["whole"][k]
        if k.endswith("in_proj_bias"):
            assert_close(got.numpy(), v.numpy(), 1e-4, k)
        assert_close(_not_keys(k, got).numpy(), _not_keys(k, v).numpy(),
                     1e-5, k)
    _hold_updates(ranks[0][2]["whole"], ref["whole"], specs[2]["state"])


# ---- the trainer ------------------------------------------------------------


def test_gpt_trainer_dp_x_tp_end_to_end(workspace, tmp_path, one_thread):
    """``cmd/train_gpt.py`` with ``EASEVOICE_DP=2 EASEVOICE_TP=2`` and
    ``"device": "cpu"`` trains one epoch on a data 2 x model 2 grid (under
    a hook refusing JAX and the JAX package in the task and its ranks):
    one response, rank 0's loss lines, one resume file and one export
    with the reference's keys (``test_gpt_trainer_dp_x_tp``).  The resume
    file holds whole fp32 tensors, equal to a world of one's within 1e-4
    relative, and the export, fp16, within the same 1e-4 plus one fp16
    step of each value (weights that differ in rounding fall on either
    side of an fp16 value); a world of one resumes from the file and trains
    the next epoch."""
    norm, project = workspace
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(REFUSE_JAX)
    base = dict(batch_size=8, total_epochs=1, save_every_epoch=1,
                train_input_dir=norm, project_dir=project, device="cpu")
    params = tmp_path / "params.json"
    params.write_text(json.dumps({**base, "output_model_name": "tp"}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(hook), REPO]),
               EASEVOICE_DP="2", EASEVOICE_TP="2", OMP_NUM_THREADS="1")
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
    obj = torch.load(data["data"]["model_path"], map_location="cpu",
                     weights_only=False)
    assert set(obj) >= {"weight", "config", "info"}

    one = ptrain.GPTTrain(ptrain.GPTTrainParams(**base,
                                                output_model_name="one"))
    resp1 = one.train()
    assert resp1.ok and resp1.data["global_step"] == steps
    got = convert.load_torch_state_dict(data["data"]["model_path"])
    want = convert.load_torch_state_dict(resp1.data["model_path"])
    assert set(got) == set(want)
    for k, v in want.items():
        v = v.float().numpy()
        bound = 1e-4 * max(1.0, np.abs(v).max()) + np.spacing(
            np.abs(v).astype(np.float16)).astype(np.float32)
        assert (np.abs(got[k].float().numpy() - v) <= bound).all(), k

    name = f"epoch=1-step={steps}.ckpt"
    saved, ref = (torch.load(os.path.join(
        ptrain.get_gpt_train_dir(project, run), "logs", "ckpt", name),
        map_location="cpu", weights_only=False) for run in ("tp", "one"))
    assert set(saved["model"]) == set(ref["model"])
    for k, v in ref["model"].items():
        assert_close(saved["model"][k].numpy(), v.numpy(), 1e-4, k)
    resumed = ptrain.GPTTrain(ptrain.GPTTrainParams(
        **{**base, "total_epochs": 2}, output_model_name="tp"))
    resp2 = resumed.train()
    assert resp2.ok and resp2.data["global_step"] == 2 * steps
