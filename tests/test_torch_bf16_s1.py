"""The s1 GPT fine-tune in bf16 (``is_half``) against the JAX package's
``Text2SemanticDecoder(dtype=jnp.bfloat16)`` on the CPU, at the size of
``tests/test_torch_s1.py`` (2 layers, width 64, 2 heads of dk 32, ffn 128,
B = 3 with ragged lengths): the bf16 attention twin and its gradient, one
layer whose rounding points match (nearer the JAX bf16 layer than the JAX
fp32 one), the training forward, micro-batches of ``GPTTrainStep`` against
``make_train_step``, the ``is_half`` switch of ``GlobalCFG`` and the
trainers, and a spy on what the kernel wrappers receive.  Each test states
its tolerance; unless said otherwise it is relative to the reference's
largest magnitude (``assert_close``).  A bf16 value carries 8 significant
bits (a step of 2^-8 to 2^-7 of it), and the two frameworks sum in other
orders, so a result rounded to bf16 may land one step apart."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easevoice_trainer_tpu.models.gpt import t2s as jt2s
from easevoice_trainer_tpu.train import gpt_step as jstep
from easevoice_trainer_tpu.utils import config as jconfig
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch.inference import tts as ptts
from easevoice_trainer_tpu_torch.models.gpt import dpo as pdpo
from easevoice_trainer_tpu_torch.models.gpt import t2s as pt2s
from easevoice_trainer_tpu_torch.nn.layers import set_compute_dtype
from easevoice_trainer_tpu_torch.ops import attention as att
from easevoice_trainer_tpu_torch.train import gpt as ptrain
from easevoice_trainer_tpu_torch.train import gpt_step as pstep
from easevoice_trainer_tpu_torch.train import sovits as psovits
from easevoice_trainer_tpu_torch.utils import config as pconfig

from _torch_port_tiny import T2S_KW, assert_close, tiny_gpt
from test_torch_s1 import JCFG, S1_KW, X_LEN, X_LENS, Y_LEN, Y_LENS, \
    _args, _batch, _jax_state, _torch_batch

BF = torch.bfloat16


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def gpt_bf16():
    model, params, _ = tiny_gpt(seed=21, **S1_KW)
    set_compute_dtype(model, BF)
    return model, params


def _layer_inputs(seed):
    rng = np.random.default_rng(seed)
    b, t, d = len(X_LENS), X_LEN + Y_LEN, 64
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    w = rng.normal(size=(b, t, d)).astype(np.float32)
    bias = jt2s.build_hybrid_mask_bias(X_LEN, Y_LEN, jnp.asarray(X_LENS),
                                       jnp.asarray(Y_LENS))
    return x, w, bias


def test_bf16_attention_and_grad_match_jax(gpt_bf16):
    """One layer's attention in bf16 (the bf16 qkv projection, the twin of
    K1's bf16 instance, the bf16 out projection) and its gradient in the
    fp32 input and in the fp32 qkv kernel, under autograd, against
    ``jax.vjp`` of the JAX ``TransformerLayer.attention`` with dtype
    bfloat16 on the same fp32 input: the bf16 output within 2^-7 (one
    step), both gradients within 1e-4 (fp32 sums of the same bf16-rounded
    terms, taken in other orders; 3e-8 here)."""
    model, params = gpt_bf16
    lp = params["layer_0"]
    x, w, bias = _layer_inputs(5)
    layer = jt2s.TransformerLayer(64, 2, 128, dropout=0.0,
                                  dtype=jnp.bfloat16)

    def jattn(x, qkv_kernel):
        p = dict(lp, qkv=dict(lp["qkv"], kernel=qkv_kernel))
        return layer.apply({"params": p}, x, bias,
                           method=jt2s.TransformerLayer.attention)[0]

    jy, vjp = jax.vjp(jattn, jnp.asarray(x), jnp.asarray(lp["qkv"]["kernel"]))
    assert jy.dtype == jnp.bfloat16
    jgx, jgk = vjp(jnp.asarray(w, jnp.bfloat16))

    tl = model.h.layers[0]
    xt = torch.from_numpy(x).requires_grad_()
    qkv = torch.nn.functional.linear(
        xt.to(BF), tl.self_attn.in_proj_weight.to(BF)) \
        + tl.self_attn.in_proj_bias.to(BF)
    o = att.self_attention(qkv, 2, X_LEN, torch.tensor(X_LENS),
                           torch.tensor(Y_LENS))
    assert o.dtype == BF
    y = torch.nn.functional.linear(
        o.reshape(xt.shape), tl.self_attn.out_proj.weight.to(BF)) \
        + tl.self_attn.out_proj.bias.to(BF)
    tl.zero_grad()
    y.backward(torch.from_numpy(w).to(BF))
    assert_close(y.float().detach().numpy(), _f32(jy), 2 ** -7, "attention")
    assert_close(xt.grad.numpy(), _f32(jgx), 1e-4, "d input")
    assert_close(tl.self_attn.in_proj_weight.grad.numpy().T, _f32(jgk), 1e-4,
                 "d qkv kernel")


def test_bf16_layer_is_nearer_jax_bf16_than_jax_fp32(gpt_bf16):
    """One ``TransformerLayer`` forward with dtype bf16 against the JAX
    layer with dtype bfloat16 and with dtype None (fp32), same params and
    fp32 input: the port within 1e-4 of JAX-bf16 (the same rounding points;
    what is left is the order of fp32 sums before a rounding), and at
    least ten times nearer JAX-bf16 than JAX-fp32 (which differs by the
    bf16 roundings themselves)."""
    model, params = gpt_bf16
    x, _, bias = _layer_inputs(6)
    want = {}
    for name, dt in (("bf16", jnp.bfloat16), ("fp32", None)):
        layer = jt2s.TransformerLayer(64, 2, 128, dropout=0.0, dtype=dt)
        want[name] = _f32(layer.apply({"params": params["layer_0"]},
                                      jnp.asarray(x), bias)[0])
    with torch.no_grad():
        got = model.h.layers[0].train_forward(
            torch.from_numpy(x), X_LEN, torch.tensor(X_LENS),
            torch.tensor(Y_LENS)).numpy()
    assert got.dtype == np.float32       # the layer boundary stays fp32
    to_bf16 = np.abs(got - want["bf16"]).max()
    to_fp32 = np.abs(got - want["fp32"]).max()
    assert to_bf16 <= 1e-4 * np.abs(want["bf16"]).max(), to_bf16
    assert to_bf16 * 10 <= to_fp32, (to_bf16, to_fp32)


def test_bf16_training_forward_matches_jax(gpt_bf16):
    """``Text2SemanticDecoder.forward`` with dtype bf16 against the JAX
    ``__call__`` with dtype bfloat16: the logits are bf16 in both and
    within one step (2^-7); the loss (a sum of log-softmax terms over B x Ty
    positions, taken from the fp32 logits) within 1e-4 relative; targets
    and the number of non-EOS targets equal, the top-3 accuracy within one
    target."""
    model, params = gpt_bf16
    batch = _batch(7)
    want = jt2s.Text2SemanticDecoder(JCFG, dtype=jnp.bfloat16).apply(
        {"params": params}, *_args(batch))
    with torch.no_grad():
        got = model(*_args(_torch_batch(batch)))
    assert got["logits"].dtype == BF and want["logits"].dtype == jnp.bfloat16
    assert_close(float(got["loss"]), float(want["loss"]), 1e-4, "loss")
    assert_close(got["logits"].float().numpy(), _f32(want["logits"]),
                 2 ** -7, "logits")
    np.testing.assert_array_equal(got["targets"].numpy(),
                                  np.asarray(want["targets"]))
    n = float(want["num_targets"])
    assert float(got["num_targets"]) == n
    assert abs(float(got["acc"]) - float(want["acc"])) <= 1.0 / n


def test_bf16_micro_batches_match_jax(monkeypatch):
    """Six micro-batches of ``GPTTrainStep`` on a bf16 model against
    ``make_train_step`` on the JAX bf16 model, fp32 optimizer state on both
    sides, across the first accumulation boundary: per micro-batch the loss
    within 1e-4 relative and the gradient norm within 1e-3 (3e-5 and 3.5e-4
    here: gradients summed from bf16 products in other orders); every fp32
    parameter within 1e-4 relative after each micro-batch (ScaledAdam moves
    a parameter by ~lr x its RMS, so this is ~1 % of one step)."""
    monkeypatch.setenv("EASEVOICE_OPT_STATE", "fp32")
    model, params, _ = tiny_gpt(seed=22, **S1_KW)
    set_compute_dtype(model, BF)
    hp = jstep.GPTTrainHP()
    state = _jax_state(params, hp)
    jax_step = jax.jit(jstep.make_train_step(
        jt2s.Text2SemanticDecoder(JCFG, dtype=jnp.bfloat16), hp))
    port = pstep.GPTTrainStep(model, pstep.GPTTrainHP())
    for i in range(6):
        batch = _batch(100 + i)
        state, metrics = jax_step(state, batch, jax.random.PRNGKey(i))
        got = port(_torch_batch(batch))
        assert_close(float(got["loss"]), float(metrics["loss"]), 1e-4,
                     f"loss {i}")
        assert_close(float(got["grad_norm"]), float(metrics["grad_norm"]),
                     1e-3, f"grad_norm {i}")
        assert port.step == int(state.step) == i + 1
        want = convert.gpt_state_dict(jstep.params_tree(state))
        sd = model.state_dict()
        for k, v in want.items():
            assert sd[k].dtype == torch.float32, k
            assert_close(sd[k].numpy(), v.numpy(), 1e-4, f"{i} {k}")
    assert port.optimizer.param_groups[0]["step"] == 1


def test_bf16_dpo_micro_batches_match_jax(monkeypatch):
    """Three micro-batches of ``GPTTrainStep`` with ``if_dpo`` on a bf16
    model against ``make_train_step`` with ``if_dpo`` on the JAX bf16 model
    (chosen and rejected forwards, the rejected sequences from one
    ``make_reject_y`` draw handed to both, fp32 optimizer state): per
    micro-batch the loss within 1e-4 relative and the gradient norm within
    1e-3, as for the plain objective; the micro-batch count equal."""
    monkeypatch.setenv("EASEVOICE_OPT_STATE", "fp32")
    model, params, _ = tiny_gpt(seed=23, **S1_KW)
    set_compute_dtype(model, BF)
    hp = jstep.GPTTrainHP(if_dpo=True)
    state = _jax_state(params, hp)
    jax_step = jax.jit(jstep.make_train_step(
        jt2s.Text2SemanticDecoder(JCFG, dtype=jnp.bfloat16), hp))
    port = pstep.GPTTrainStep(model, pstep.GPTTrainHP(if_dpo=True))
    for i in range(3):
        batch = _batch(200 + i)
        rej, rej_lens = pdpo.make_reject_y(
            batch["semantic_ids"], batch["semantic_ids_len"],
            np.random.default_rng(i), max_len=Y_LEN)
        batch = dict(batch, reject_semantic_ids=rej,
                     reject_semantic_ids_len=rej_lens)
        state, metrics = jax_step(state, batch, jax.random.PRNGKey(i))
        got = port(_torch_batch(batch))
        assert_close(float(got["loss"]), float(metrics["loss"]), 1e-4,
                     f"loss {i}")
        assert_close(float(got["grad_norm"]), float(metrics["grad_norm"]),
                     1e-3, f"grad_norm {i}")
        assert port.step == int(state.step) == i + 1


# ---- the is_half switch -------------------------------------------------------


@pytest.mark.parametrize("card", [True, False])
@pytest.mark.parametrize("env", [None, "False", "True"])
def test_global_config_is_half(card, env, monkeypatch):
    """``GlobalCFG().is_half`` reads the env var ``is_half`` with the JAX
    default True (utils/config.py:72) and is off where torch sees no CUDA
    card, as the JAX class turns it off on its CPU platform (:77-79); the
    trainers' compute dtype follows it on a CUDA device and is fp32 (None)
    on "cpu" whatever it says."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    if env is None:
        monkeypatch.delenv("is_half", raising=False)
    else:
        monkeypatch.setenv("is_half", env)
    want = card and env != "False"
    assert pconfig.GlobalCFG().is_half is want
    assert psovits.training_dtype(torch.device("cuda")) == (
        BF if want else None)
    assert psovits.training_dtype(torch.device("cpu")) is None


def test_cpu_trainers_stay_fp32(monkeypatch, tmp_path):
    """``GPTTrain`` and ``SovitsTrain`` on a "cpu" device compute in fp32
    with is_half on (a card reported, the env default)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("is_half", raising=False)
    assert pconfig.GlobalCFG().is_half
    gpt = ptrain.GPTTrain(ptrain.GPTTrainParams(
        project_dir=str(tmp_path), output_model_name="g", device="cpu"))
    s2 = psovits.SovitsTrain(psovits.SovitsTrainParams(
        project_dir=str(tmp_path), output_model_name="s", device="cpu"))
    assert gpt.compute_dtype is None and s2.compute_dtype is None


@pytest.mark.parametrize("platform", ["cpu", "accelerator"])
def test_tts_config_is_half_saved_as_jax_saves_it(platform, monkeypatch,
                                                  tmp_path):
    """``TTSConfig.is_half`` defaults to ``GlobalCFG().is_half`` as in JAX
    (inference/tts.py:88): the saved ``tts_infer.yaml`` records the value
    the JAX package's does, on a CPU host and on an accelerator (the JAX
    platform detection and torch's card check patched to say so).  It is a
    recorded field only: serving computes in fp32 in both packages."""
    import json

    import yaml
    from easevoice_trainer_tpu.inference import tts as jtts

    monkeypatch.delenv("is_half", raising=False)
    accel = platform == "accelerator"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: accel)
    monkeypatch.setattr(jconfig.GlobalCFG, "_detect_platform",
                        staticmethod(lambda: "tpu" if accel else "cpu"))
    monkeypatch.setattr(jconfig.GlobalCFG, "_enable_compile_cache",
                        lambda self: None)
    jconfig.GlobalCFG.reset()
    try:
        jpath, ppath = tmp_path / "jax.yaml", tmp_path / "port.yaml"
        jtts.TTSConfig(str(jpath)).save_configs()
        ptts.TTSConfig(str(ppath)).save_configs()
        with open(jpath) as f:
            jsaved = yaml.safe_load(f)
        with open(ppath) as f:
            psaved = json.load(f)
    finally:
        jconfig.GlobalCFG.reset()
    for tier in ("default", "custom"):
        assert psaved[tier]["is_half"] is jsaved[tier]["is_half"] is accel


def test_kernel_wrappers_receive_bf16(monkeypatch):
    """With the trainers' compute dtype the GPT hands ``self_attention`` (K1
    / K5 on the card) a bf16 qkv in every layer, and gets bf16 back; the
    parameters stay fp32."""
    seen = []
    real = pt2s.self_attention

    def spy(qkv, *args):
        seen.append(qkv.dtype)
        out = real(qkv, *args)
        seen.append(out.dtype)
        return out

    monkeypatch.setattr(pt2s, "self_attention", spy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("is_half", raising=False)
    dtype = psovits.training_dtype(torch.device("cuda"))
    model = pt2s.Text2SemanticDecoder(pt2s.T2SConfig(**{**T2S_KW, **S1_KW}),
                                      dtype=dtype)
    out = model(*_args(_torch_batch(_batch(3))))
    out["loss"].backward()
    assert seen == [BF] * (2 * S1_KW["n_layers"])
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters() if p.grad is not None)
