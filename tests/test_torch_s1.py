"""Parity of the PyTorch port's s1 training slice with the JAX package, fp32
on the CPU at a tiny size (2 layers, width 64, 2 heads of dk 32, ffn 128;
B = 3 with ragged phoneme and token lengths, so that every row has padded
query positions and one row is mostly padding): the training attention and
its gradient (K1 / K5's twins), the training forward, ScaledAdam (fp32 and
bf16 state), eight accumulated micro-batches of ``GPTTrainStep`` against
``make_train_step``, the DPO loss, the ``GPTTrain`` driver on the CPU, and
the reader of ``configs/gpt.yaml``.  Weights go across through
``convert.gpt_state_dict``; inputs come from numpy seeds.  Each test states
its tolerance; unless said otherwise it is relative to the reference's
largest magnitude (``assert_close``), for fp32 sums taken in other orders by
the two frameworks."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from easevoice_trainer_tpu.models.gpt import dpo as jdpo
from easevoice_trainer_tpu.models.gpt import t2s as jt2s
from easevoice_trainer_tpu.parallel.gpt_sharding import gpt_arena_label
from easevoice_trainer_tpu.train import arena as jarena
from easevoice_trainer_tpu.train import ckpt as jckpt
from easevoice_trainer_tpu.train import gpt_step as jstep
from easevoice_trainer_tpu.train.scaled_adam import scaled_adam
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch.models.gpt import T2SConfig, \
    Text2SemanticDecoder
from easevoice_trainer_tpu_torch.models.gpt import dpo as pdpo
from easevoice_trainer_tpu_torch.ops import attention as att
from easevoice_trainer_tpu_torch.train import gpt as ptrain
from easevoice_trainer_tpu_torch.train import gpt_step as pstep
from easevoice_trainer_tpu_torch.train.scaled_adam import ScaledAdam
from easevoice_trainer_tpu_torch.utils import simple_yaml

from _torch_port_tiny import T2S_KW, assert_close, tiny_gpt
from test_trainers import TINY_GPT, workspace  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S1_KW = dict(embedding_dim=64, hidden_dim=64, n_heads=2, n_layers=2,
             ffn_dim=128)
JCFG = jt2s.T2SConfig(**{**T2S_KW, **S1_KW})
X_LEN, Y_LEN = 13, 21
X_LENS = [13, 9, 4]
Y_LENS = [21, 17, 3]    # the last row is mostly padding


def _batch(seed):
    """One s1 batch as numpy (the keys of ``collate_gpt``)."""
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


def _torch_batch(batch):
    return {k: torch.from_numpy(v).to(torch.int64)
            if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _args(batch):
    return (batch["phoneme_ids"], batch["phoneme_ids_len"],
            batch["semantic_ids"], batch["semantic_ids_len"],
            batch["bert_feature"])


@pytest.fixture(scope="module")
def gpt():
    model, params, _ = tiny_gpt(seed=21, **S1_KW)
    return model, params


# ---- attention and its gradient ---------------------------------------------


def test_self_attention_grad_matches_jax(gpt):
    """One layer's attention (qkv projection, hybrid-masked softmax, output
    projection) and its gradient in the input and in the qkv kernel, from
    ``self_attention`` under autograd against ``jax.grad`` of the JAX
    ``TransformerLayer.attention`` with ``build_hybrid_mask_bias``: output
    and both gradients within 1e-5 relative."""
    model, params = gpt
    lp = params["layer_0"]
    rng = np.random.default_rng(5)
    b, t, d = len(X_LENS), X_LEN + Y_LEN, 64
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    w = rng.normal(size=(b, t, d)).astype(np.float32)
    layer = jt2s.TransformerLayer(d, 2, 128, dropout=0.0)
    bias = jt2s.build_hybrid_mask_bias(X_LEN, Y_LEN, jnp.asarray(X_LENS),
                                       jnp.asarray(Y_LENS))

    def jloss(x, qkv_kernel):
        p = dict(lp, qkv=dict(lp["qkv"], kernel=qkv_kernel))
        y, _ = layer.apply({"params": p}, x, bias,
                           method=jt2s.TransformerLayer.attention)
        return jnp.sum(y * w), y

    (_, jy), (jgx, jgk) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(x), jnp.asarray(lp["qkv"]["kernel"]))

    tl = model.h.layers[0]
    xt = torch.from_numpy(x).requires_grad_()
    qkv = torch.nn.functional.linear(xt, tl.self_attn.in_proj_weight,
                                     tl.self_attn.in_proj_bias)
    o = att.self_attention(qkv, 2, X_LEN, torch.tensor(X_LENS),
                           torch.tensor(Y_LENS))
    y = tl.self_attn.out_proj(o.reshape(b, t, d))
    tl.zero_grad()
    (y * torch.from_numpy(w)).sum().backward()
    assert_close(y.detach().numpy(), np.asarray(jy), 1e-5, "attention")
    assert_close(xt.grad.numpy(), np.asarray(jgx), 1e-5, "d input")
    assert_close(tl.self_attn.in_proj_weight.grad.numpy().T,
                 np.asarray(jgk), 1e-5, "d qkv kernel")


def test_attention_bwd_twin_equals_autograd_of_dense_twin():
    """K5's plain twin, written from the math (P from the logsumexp twin,
    D = rowsum(dO * O)), against autograd through the dense twin, in fp64:
    1e-12 absolute.  Pad query rows get a non-zero dO."""
    rng = np.random.default_rng(6)
    b, h, dk = len(X_LENS), 2, 32
    t = X_LEN + Y_LEN
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * h * dk))) \
        .requires_grad_()
    do = torch.from_numpy(rng.normal(size=(b, t, h, dk)))
    xl, yl = torch.tensor(X_LENS), torch.tensor(Y_LENS)
    o = att.self_attention(qkv, h, X_LEN, xl, yl)
    o.backward(do)
    q, k, v = att._split_heads(qkv.detach(), h)
    lse = att.prefill_attention_lse_reference(q, k, X_LEN, xl, yl)
    got = att.prefill_attention_bwd(q, k, v, o.detach(), lse, do, X_LEN, xl,
                                    yl)
    want = qkv.grad.view(b, t, 3, h, dk)
    for i, g in enumerate(got):
        torch.testing.assert_close(g, want[:, :, i], rtol=0, atol=1e-12)


# ---- the training forward ---------------------------------------------------


def test_training_forward_matches_jax(gpt):
    """``Text2SemanticDecoder.forward`` against the JAX ``__call__``: loss
    (a sum over all B x Ty positions) within 1e-5 relative, logits within
    1e-5, targets, the number of non-EOS targets and the top-3 accuracy
    equal."""
    model, params = gpt
    batch = _batch(7)
    want = jt2s.Text2SemanticDecoder(JCFG).apply({"params": params},
                                                 *_args(batch))
    with torch.no_grad():
        got = model(*_args(_torch_batch(batch)))
    assert_close(float(got["loss"]), float(want["loss"]), 1e-5, "loss")
    assert_close(got["logits"].numpy(), np.asarray(want["logits"]), 1e-5,
                 "logits")
    np.testing.assert_array_equal(got["targets"].numpy(),
                                  np.asarray(want["targets"]))
    assert float(got["num_targets"]) == float(want["num_targets"])
    assert float(got["acc"]) == pytest.approx(float(want["acc"]), abs=1e-7)


# ---- ScaledAdam -------------------------------------------------------------

SHAPES = [(8, 16), (4, 7), (1,)]      # two tensors and a one-element one


def _grad_stream(rng, n_steps):
    """Heavy-tailed gradients so median != mean and clipping matters."""
    grads = []
    for t in range(n_steps):
        scale = 10.0 if t % 11 == 5 else 1.0        # occasional spikes
        grads.append([np.asarray(rng.normal(size=s), np.float32) * scale * 0.1
                      for s in SHAPES])
    return grads


@pytest.mark.parametrize("state", ["fp32", "bf16"])
def test_scaled_adam_matches_jax(state):
    """60 steps of heavy-tailed gradients with a clipping period of 16 and
    a size period of 4 (so the run refreshes the clip threshold three times
    and takes 14 size updates), one one-element tensor on the scalar path:
    every parameter at every step within 1e-5 relative of JAX
    ``scaled_adam`` with fp32 state; with bf16 state within 1e-3 (both round
    the state to bf16 on store, and an fp32 difference of one ulp can land
    the two on neighbouring bf16 values)."""
    rng = np.random.default_rng(9)
    init = [np.asarray(rng.normal(size=s), np.float32) * 0.5 for s in SHAPES]
    grads = _grad_stream(rng, 60)
    lr, kw = 0.03, dict(clipping_update_period=16, size_update_period=4)
    jdt, pdt = ((None, torch.float32) if state == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    tx = scaled_adam(learning_rate=lr, b1=0.9, b2=0.95, clipping_scale=2.0,
                     state_dtype=jdt, **kw)
    jp = {f"p{i}": jnp.asarray(v) for i, v in enumerate(init)}
    st = tx.init(jp)
    update = jax.jit(tx.update)
    params = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in init]
    opt = ScaledAdam(params, lr=lr, betas=(0.9, 0.95), clipping_scale=2.0,
                     state_dtype=pdt, **kw)
    tol = 1e-5 if state == "fp32" else 1e-3
    for n, g in enumerate(grads):
        jg = {f"p{i}": jnp.asarray(v) for i, v in enumerate(g)}
        upd, st = update(jg, st, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for p, v in zip(params, g):
            p.grad = torch.from_numpy(v)
        opt.step()
        for i, p in enumerate(params):
            assert_close(p.detach().numpy(), np.asarray(jp[f"p{i}"]), tol,
                         f"step {n} p{i}")
    assert opt.param_groups[0]["step"] == 60 == int(st.count)
    assert_close(opt.param_groups[0]["norm_threshold"].numpy(),
                 np.asarray(st.norm_threshold), 1e-5, "threshold")


# ---- the train step ---------------------------------------------------------


def _jax_state(params, hp):
    arena = jarena.build_arena(params, gpt_arena_label)
    packed = jarena.pack(arena, params)
    return jstep.GPTTrainState(
        step=jnp.zeros((), jnp.int32), params=packed,
        opt_state=jstep.make_optimizer(hp).init(packed), arena=arena)


def test_eight_micro_batches_match_jax(monkeypatch):
    """Eight micro-batches of ``GPTTrainStep`` against ``make_train_step``
    with fp32 optimizer state on both sides, across two accumulation
    boundaries (ScaledAdam steps after micro-batches 4 and 8 on the mean of
    the four gradients): per micro-batch loss within 1e-5 relative, acc
    equal, grad_norm within 1e-4 and the micro-batch count equal; every
    parameter within 1e-4 relative after each micro-batch (the step moves a
    parameter by ~lr x its RMS, so this is ~1 % of one step)."""
    monkeypatch.setenv("EASEVOICE_OPT_STATE", "fp32")
    model, params, _ = tiny_gpt(seed=22, **S1_KW)
    hp = jstep.GPTTrainHP()
    state = _jax_state(params, hp)
    jax_step = jax.jit(jstep.make_train_step(
        jt2s.Text2SemanticDecoder(JCFG), hp))
    port = pstep.GPTTrainStep(model, pstep.GPTTrainHP())
    for i in range(8):
        batch = _batch(100 + i)
        state, metrics = jax_step(state, batch, jax.random.PRNGKey(i))
        got = port(_torch_batch(batch))
        assert_close(float(got["loss"]), float(metrics["loss"]), 1e-5,
                     f"loss {i}")
        assert float(got["acc"]) == pytest.approx(float(metrics["acc"]),
                                                  abs=1e-6)
        assert_close(float(got["grad_norm"]), float(metrics["grad_norm"]),
                     1e-4, f"grad_norm {i}")
        assert port.step == int(state.step) == i + 1
        want = convert.gpt_state_dict(jstep.params_tree(state))
        sd = model.state_dict()
        assert set(sd) == set(want)
        for k, v in want.items():
            assert_close(sd[k].numpy(), v.numpy(), 1e-4, f"{i} {k}")
    assert port.optimizer.param_groups[0]["step"] == 2


# ---- DPO --------------------------------------------------------------------


def test_dpo_matches_jax(gpt):
    """The rejected sequences of ``make_reject_y`` from the same numpy
    generator are equal; ``sequence_logps`` and ``dpo_loss`` within 1e-5,
    and the whole ``dpo_forward`` loss within 1e-5 relative."""
    model, params = gpt
    batch = _batch(11)
    rej, rej_lens = pdpo.make_reject_y(
        batch["semantic_ids"], batch["semantic_ids_len"],
        np.random.default_rng(3), max_len=Y_LEN)
    jrej, jrej_lens = jdpo.make_reject_y(
        batch["semantic_ids"], batch["semantic_ids_len"],
        np.random.default_rng(3), max_len=Y_LEN)
    np.testing.assert_array_equal(rej, jrej)
    np.testing.assert_array_equal(rej_lens, jrej_lens)
    jmodel = jt2s.Text2SemanticDecoder(JCFG)
    want = jdpo.dpo_forward(jmodel, params, batch, jnp.asarray(rej),
                            jnp.asarray(rej_lens))
    tb = _torch_batch(batch)
    with torch.no_grad():
        got = pdpo.dpo_forward(model, tb, torch.from_numpy(rej).long(),
                               torch.from_numpy(rej_lens).long())
        out = model(*_args(tb))
    jout = jmodel.apply({"params": params}, *_args(batch))
    assert_close(pdpo.sequence_logps(out["logits"], out["targets"]).numpy(),
                 np.asarray(jdpo.sequence_logps(jout["logits"],
                                                jout["targets"])), 1e-5,
                 "sequence_logps")
    margins = np.asarray([3.0, -1.5, 0.25], np.float32)
    assert_close(float(pdpo.dpo_loss(torch.from_numpy(margins),
                                     torch.zeros(3))),
                 float(jdpo.dpo_loss(jnp.asarray(margins), jnp.zeros(3))),
                 1e-6, "dpo_loss")
    for k in ("loss", "ce_loss", "dpo_margin"):
        assert_close(float(got[k]), float(want[k]), 1e-5, k)


# ---- the driver -------------------------------------------------------------


def test_gpt_train_end_to_end_on_cpu(workspace, capsys):
    """GPTTrain.train() for one epoch at the JAX driver's tiny fixture (3
    clips replicated to 99 items, batch 8): finite metrics, one loss line
    every 10 micro-batches, an ``{name}-e1.ckpt`` that loads ``strict=True``
    into the port's inference decoder and with no unmatched key through the
    JAX package's ``load_gpt_pretrained``, and a resume file that a second
    run with one more epoch picks up (it starts at the saved micro-batch
    count and model)."""
    norm, project = workspace
    params = ptrain.GPTTrainParams(
        batch_size=8, total_epochs=1, save_every_epoch=1,
        train_input_dir=norm, output_model_name="tiny", project_dir=project,
        device="cpu")
    trainer = ptrain.GPTTrain(params)
    assert trainer.model_cfg == T2SConfig.from_yaml_dict(TINY_GPT)
    history = []
    resp = trainer.train(on_step=lambda step, m: history.append(
        (step, {k: float(v) for k, v in m.items()})))
    assert resp.ok, resp.message
    steps = resp.data["global_step"]
    assert [s for s, _ in history] == list(range(1, steps + 1))
    assert all(np.isfinite(v) for _, m in history for v in m.values())
    assert capsys.readouterr().out.count("loss-of-easevoice") == steps // 10
    path = resp.data["model_path"]
    assert path.endswith("tiny-e1.ckpt")
    obj = torch.load(path, map_location="cpu", weights_only=False)
    assert set(obj) >= {"weight", "config", "info"}
    assert all(k.startswith("model.") and v.dtype == torch.float16
               for k, v in obj["weight"].items())
    model = Text2SemanticDecoder(trainer.model_cfg)
    model.load_state_dict(convert.load_torch_state_dict(path), strict=True)
    tree, unmatched = jckpt.load_gpt_pretrained(path)
    assert not unmatched and "layer_1" in tree
    resume = os.path.join(trainer.ckpt_dir, f"epoch=1-step={steps}.ckpt")
    assert os.listdir(trainer.ckpt_dir) == [os.path.basename(resume)]

    trained = {k: v.clone() for k, v in
               trainer.step_fn.model.state_dict().items()}
    again = ptrain.GPTTrain(ptrain.GPTTrainParams(**{
        **params.__dict__, "total_epochs": 2}))
    seen = []

    def first_step(step, m):
        if not seen:
            seen.append(step)
            # the resumed model before its first step: the trained one
    resp2 = again.train(on_step=first_step)
    assert resp2.ok and seen == [steps + 1]
    assert resp2.data["global_step"] == 2 * steps
    obj2 = torch.load(os.path.join(again.ckpt_dir,
                                   f"epoch=2-step={2 * steps}.ckpt"),
                      map_location="cpu", weights_only=False)
    assert obj2["train_step"]["optimizer"]["param_groups"][0]["step"] \
        == 2 * steps // 4
    assert any(not torch.equal(v, trained[k])
               for k, v in obj2["model"].items())


def test_gpt_train_resumes_the_saved_model(workspace):
    """The model a resumed run starts from is the saved one, bit for bit."""
    norm, project = workspace
    params = ptrain.GPTTrainParams(
        batch_size=8, total_epochs=1, save_every_epoch=1,
        train_input_dir=norm, output_model_name="r", project_dir=project,
        device="cpu")
    first = ptrain.GPTTrain(params)
    first.train()
    saved = first.step_fn.model.state_dict()
    again = ptrain.GPTTrain(ptrain.GPTTrainParams(**{
        **params.__dict__, "total_epochs": 2}))
    model = Text2SemanticDecoder(again.model_cfg)
    step_fn = pstep.GPTTrainStep(model, again.hp)
    assert again._try_resume(step_fn) == 2
    assert step_fn.step == first.step_fn.step
    for k, v in saved.items():
        assert torch.equal(model.state_dict()[k], v), k


def test_gpt_train_runs_on_the_card_by_default(workspace, monkeypatch):
    """The trainer's device defaults to CUDA and, with no card, it raises
    instead of moving to the host."""
    norm, project = workspace
    params = ptrain.GPTTrainParams(train_input_dir=norm,
                                   output_model_name="dev",
                                   project_dir=project)
    assert params.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ptrain.GPTTrain(params)


# ---- the config reader ------------------------------------------------------


@pytest.mark.parametrize("source", ["configs/gpt.yaml", "TINY_GPT dump"])
def test_simple_yaml_matches_pyyaml(source):
    """The port's reader gives what ``yaml.safe_load`` gives on the repo's
    ``configs/gpt.yaml`` and on PyYAML's own dump of the tests' tiny
    config (quoted strings, floats in exponent form)."""
    if source == "TINY_GPT dump":
        text = yaml.safe_dump(TINY_GPT)
    else:
        with open(os.path.join(REPO, source), encoding="utf8") as f:
            text = f.read()
    assert simple_yaml.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n  b: 2\n", "a: [1, [2]]\n", "a: {b: 1}\n", "a: &x 1\n",
    "a: |\n  text\n", "a:\n\tb: 1\n", "a: 1\na: 2\n", "a: 0x10\n",
    "a:\n  b: 1\n   c: 2\n"])
def test_simple_yaml_refuses_what_it_does_not_read(text):
    """A mapping key after a sequence at one indentation, nested flow
    sequences, flow mappings with entries, anchors, block scalars, tabs,
    duplicate keys, numbers in other bases and ragged indentation raise
    instead of being read another way than PyYAML reads them (block and
    flow sequences and deeper mappings are read now: FunASR's config.yaml
    files hold them; tests/test_torch_host.py holds them to PyYAML)."""
    with pytest.raises(ValueError):
        simple_yaml.loads(text)
