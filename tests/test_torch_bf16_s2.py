"""The s2 SoVITS fine-tune in bf16 (``is_half``) against the JAX package's
``SynthesizerTrn`` / ``MultiPeriodDiscriminator`` with dtype bfloat16 on the
CPU, at the tiny size of ``_torch_port_tiny.py``: the bf16 weight-norm
multiply, the bf16 MRF twins (K3 / K4's) against ``jax.vjp`` of the JAX
ResBlock math in bf16, one ResBlock whose rounding points match (nearer the
JAX bf16 block than the JAX fp32 one), one whole D-then-G ``S2TrainStep``
against ``make_train_step``, and a spy on what the kernel wrappers receive.
Each test states its tolerance.  A bf16 value carries 8 significant bits (a
step of 2^-8 to 2^-7 of it), and the two frameworks sum in other orders, so
a result rounded to bf16 may land one step apart; in a whole GAN step those
steps travel, so the step is held by its losses, its gradients taken
together (L2) and its parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easevoice_trainer_tpu.models.sovits import discriminator as jdisc
from easevoice_trainer_tpu.models.sovits import generator as jgen
from easevoice_trainer_tpu.nn import layers as jlayers
from easevoice_trainer_tpu.ops import stft as jstft
from easevoice_trainer_tpu.train import ckpt
from easevoice_trainer_tpu.train import sovits_step as jstep
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch.models.sovits import generator as pgen
from easevoice_trainer_tpu_torch.nn import layers as players
from easevoice_trainer_tpu_torch.nn.layers import set_compute_dtype
from easevoice_trainer_tpu_torch.ops import mrf
from easevoice_trainer_tpu_torch.ops import stft as pstft
from easevoice_trainer_tpu_torch.train import sovits_step as pstep

from _torch_port_tiny import assert_close, tiny_mpd, tiny_sovits_train
from test_torch_s2 import CFG, JS, _batch, _jax_mrf_conv, _jax_state, \
    _jax_step_grads, _t, _torch_batch

BF = torch.bfloat16


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bf16_np(rng, shape, scale=1.0):
    """A float32 array of bf16-exact values (so both sides start equal)."""
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return np.array(_f32(jnp.asarray(a, jnp.bfloat16)))


@pytest.mark.parametrize("kind", ["conv1d", "conv_transpose1d"])
def test_bf16_weight_norm_multiply_is_jax_bit_for_bit(kind):
    """``_WeightNorm.weight_as(bf16)`` against the JAX
    ``_WeightNormKernel(compute_dtype=bfloat16)`` (nn/layers.py:102-105) on
    the same g and v: ``bf16(v) * bf16(g / ||v||)`` with the norm in fp32,
    bit for bit (the norms, fp32 sums of 7 x 16 squares in other orders,
    round to the same bf16 scale here)."""
    rng = np.random.default_rng(41)
    cout, cin, k = 16, 24, 7
    if kind == "conv1d":
        layer = players.WNConv1d(cin, cout, k)
        v = rng.normal(size=(cout, cin, k)).astype(np.float32)
        to_flax = ckpt.t2f_conv
    else:
        layer = players.WNConvTranspose1d(cin, cout, k, 3)
        v = rng.normal(size=(cin, cout, k)).astype(np.float32)
        to_flax = ckpt.t2f_convT
    g = np.abs(rng.normal(size=v.shape[:1] + (1, 1))).astype(np.float32)
    with torch.no_grad():
        layer.weight_v.copy_(torch.from_numpy(v))
        layer.weight_g.copy_(torch.from_numpy(g))
    got = layer.weight_as(BF)
    assert got.dtype == BF
    vf = to_flax(v)   # the JAX layout: (k, in, out), out last
    kern = jlayers._WeightNormKernel(vf.shape, compute_dtype=jnp.bfloat16)
    want = kern.apply({"params": {"v": jnp.asarray(vf),
                                  "g": jnp.asarray(g.reshape(-1))}})
    assert want.dtype == jnp.bfloat16
    back = ckpt.f2t_conv(_f32(want)) if kind == "conv1d" \
        else ckpt.f2t_convT(_f32(want))
    np.testing.assert_array_equal(got.float().detach().numpy(), back)


@pytest.mark.parametrize("d,with_res", [(1, True), (3, False), (5, True)])
def test_bf16_mrf_twins_match_jax_vjp(d, with_res):
    """``mrf_conv`` on bf16 CPU tensors (the twins of K3 / K4's bf16
    instances under autograd) against ``jax.vjp`` of the JAX ResBlock conv
    math in bf16 (generator.py:31-44 at fold=1; nn/layers.py leaky_relu):
    y, dx (with exact zeros in x), dw and the residual's gradient, each
    bf16, within one step (2^-7) of the reference's largest magnitude (the
    same roundings, fp32 sums in other orders before each).  db is the sum
    of 80 bf16 terms: the port (twin and kernel) sums them in fp32 and
    rounds once, and is held within one step to that sum; XLA's bf16
    reduction on the CPU rounds its running sum in bf16, so JAX's db is
    held to it within 4 steps (2^-5)."""
    rng = np.random.default_rng(30 + d)
    c, t, k = 6, 40, 7
    x = _bf16_np(rng, (2, c, t))
    x[0, :, :5] = 0.0
    w = _bf16_np(rng, (c, c, k), 0.3)
    b = _bf16_np(rng, (c,))
    res = _bf16_np(rng, (2, c, t)) if with_res else None
    dy = _bf16_np(rng, (2, c, t))
    ins = [_t(a).to(BF).requires_grad_() for a in (x, w, b)]
    rt = _t(res).to(BF).requires_grad_() if with_res else None
    y = mrf.mrf_conv(*ins, d, residual=rt)
    assert y.dtype == BF and y.grad_fn is not None
    y.backward(_t(dy).to(BF))

    def bf(a):
        return jnp.asarray(a, jnp.bfloat16)

    tr = lambda a: bf(a).transpose(0, 2, 1)
    args = (bf(ckpt.t2f_conv(w)), bf(b), tr(x)) + ((tr(res),) if with_res
                                                   else ())
    out, vjp = jax.vjp(lambda wf, bb, xx, *rr: _jax_mrf_conv(
        wf, bb, d, xx, rr[0] if rr else None), *args)
    assert out.dtype == jnp.bfloat16
    step = 2 ** -7
    assert_close(y.float().detach().numpy(), _f32(out).transpose(0, 2, 1),
                 step, "y")
    gw, gb, gx, *gr = vjp(tr(dy))
    assert ins[0].grad.dtype == BF
    assert_close(ins[0].grad.float().numpy(), _f32(gx).transpose(0, 2, 1),
                 step, "dx")
    assert_close(ins[1].grad.float().numpy(), ckpt.f2t_conv(_f32(gw)), step,
                 "dw")
    assert ins[2].grad.dtype == BF
    exact = _t(dy).sum(dim=(0, 2)).to(BF).float().numpy()
    assert_close(ins[2].grad.float().numpy(), exact, step, "db")
    assert_close(ins[2].grad.float().numpy(), _f32(gb), 2 ** -5, "db, JAX")
    if with_res:
        assert_close(rt.grad.float().numpy(),
                     _f32(gr[0]).transpose(0, 2, 1), 0, "dres")


def test_bf16_resblock_is_nearer_jax_bf16_than_jax_fp32():
    """One ResBlock1 (six K3 convs, weight-normed) forward in bf16 against
    the JAX ResBlock1 with dtype bfloat16 on the same bf16 input and with
    dtype None on its fp32 value: the port within 2^-6 of the JAX bf16
    block's largest magnitude (a step of a chain of bf16 roundings), and at
    least three times nearer it than the JAX fp32 block."""
    port, params = tiny_sovits_train(seed=5)
    block = port.dec.resblocks[1]             # stage 0, k = 7, C = 16
    set_compute_dtype(block, BF)
    jp = params["dec"]["resblock_0_1"]
    rng = np.random.default_rng(12)
    x = _bf16_np(rng, (2, 50, 16))
    want = {}
    for name, dt, xin in (("bf16", jnp.bfloat16, jnp.asarray(x, jnp.bfloat16)),
                          ("fp32", None, jnp.asarray(x))):
        jblock = jgen.ResBlock1(16, 7, (1, 3, 5), dtype=dt)
        want[name] = _f32(jblock.apply({"params": jp}, xin))
    with torch.no_grad():
        got = block(_t(x).transpose(1, 2).contiguous().to(BF))
    assert got.dtype == BF
    got = got.float().transpose(1, 2).numpy()
    to_bf16 = np.abs(got - want["bf16"]).max()
    to_fp32 = np.abs(got - want["fp32"]).max()
    assert to_bf16 <= 2 ** -6 * np.abs(want["bf16"]).max(), to_bf16
    assert to_bf16 * 3 <= to_fp32, (to_bf16, to_fp32)


def _global_rel(got, want):
    """|got - want| / |want| over a set of tensors together (L2)."""
    keys = [k for k in want if float(np.abs(want[k]).max()) > 0]
    d = np.concatenate([(np.asarray(got[k], np.float64)
                         - np.asarray(want[k], np.float64)).ravel()
                        for k in keys])
    w = np.concatenate([np.asarray(want[k], np.float64).ravel()
                        for k in keys])
    return float(np.linalg.norm(d) / np.linalg.norm(w))


def test_bf16_train_step_matches_jax(monkeypatch):
    """One D-then-G ``S2TrainStep`` on bf16 models against the JAX
    package's ``make_train_step`` on ``SynthesizerTrn`` /
    ``MultiPeriodDiscriminator`` with dtype bfloat16, fp32 moments, the
    JAX step's slice starts and its posterior noise given to the port (the
    noise is drawn in bf16 in JAX; both sides take the same values), at
    periods (2, 3):

    * every loss within 5e-3 relative of max(1, |JAX|) (8e-4 at most
      here, the KL), the grad norms within 2e-3 (1.8e-4);
    * the gradients of G and of D, each model's taken together, within
      5e-2 of the JAX step's in L2 norm (1.0 and 1.2 % here; bf16 against
      fp32 on one side differs by 2 %; a single tensor is no measure: a
      bias's or weight_g's gradient is a sum that cancels, and a bf16 step
      moves it by its own size);
    * every parameter after the step within 2.5 lr, as in fp32."""
    monkeypatch.setenv("EASEVOICE_OPT_STATE", "fp32")
    periods = (2, 3)
    net_g, gp = tiny_sovits_train(seed=12)
    net_d, dp = tiny_mpd(periods, seed=13)
    set_compute_dtype(net_g, BF)
    set_compute_dtype(net_d, BF)
    jsynth = JS(CFG, dtype=jnp.bfloat16)
    jd = jdisc.MultiPeriodDiscriminator(periods=periods, dtype=jnp.bfloat16)
    lr = 2e-4
    hp_j = jstep.S2TrainHP(segment_size=2560, learning_rate=lr)
    mel_cfg = jstft.MelConfig()
    batch = _batch(14)
    noise = np.random.default_rng(15).normal(
        size=(2, batch["spec"].shape[1], CFG.inter_channels)).astype(
            np.float32)

    def normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == noise.shape, shape
        return jnp.asarray(noise, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)
    state = _jax_state(gp, dp, hp_j)
    jax_step = jax.jit(jstep.make_train_step(jsynth, jd, hp_j, mel_cfg,
                                             steps_per_epoch=1))
    replica = _jax_step_grads(jsynth, jd, hp_j, mel_cfg)
    port_step = pstep.S2TrainStep(
        net_g, net_d, pstep.S2TrainHP(segment_size=2560, learning_rate=lr),
        pstft.MelConfig(), steps_per_epoch=1)
    rng = jax.random.PRNGKey(100)
    pg = jstep.params_tree(state, "g")
    pd = jstep.params_tree(state, "d")
    state, metrics = jax_step(state, batch, rng)
    d_grads, g_grads, losses, ids, _ = replica(
        pg, pd, jstep.params_tree(state, "d"), batch, rng)
    got = port_step(_torch_batch(batch),
                    ids_slice=_t(np.asarray(ids), torch.int64),
                    eps=_t(noise))
    for k, v in losses.items():
        assert_close(float(got[k]), float(metrics[k]), 5e-3, k)
    for k in ("grad_norm/g", "grad_norm/d"):
        assert_close(float(got[k]), float(metrics[k]), 2e-3, k)
    for net, tree in ((net_g, convert.sovits_state_dict(g_grads, True)),
                      (net_d, convert.discriminator_state_dict(d_grads,
                                                               periods))):
        grads = {k: p.grad.numpy() for k, p in net.named_parameters()
                 if p.grad is not None}
        want = {k: tree[k].numpy() for k in grads}
        assert all(p.grad is None or p.grad.dtype == torch.float32
                   for p in net.parameters())
        err = _global_rel(grads, want)
        assert err <= 5e-2, (type(net).__name__, err)
    for net, ref in (
            (net_g, convert.sovits_state_dict(jstep.params_tree(state, "g"),
                                              True)),
            (net_d, convert.discriminator_state_dict(
                jstep.params_tree(state, "d"), periods))):
        sd = net.state_dict()
        for k, v in ref.items():
            assert sd[k].dtype == torch.float32, k
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                       atol=2.5 * lr, err_msg=k)


def test_generator_hands_the_kernels_bf16(monkeypatch):
    """With the trainers' compute dtype the Generator hands ``mrf_conv`` (K3
    forward, K4 backward on the card) bf16 activations, weights and
    biases, and gets bf16 back; the upsamples and convs around it run bf16;
    the parameters and their gradients stay fp32."""
    seen = []
    real = pgen.mrf_conv

    def spy(x, w, b, d, residual=None):
        seen.append({x.dtype, w.dtype, b.dtype}
                    | ({residual.dtype} if residual is not None else set()))
        out = real(x, w, b, d, residual=residual)
        seen.append({out.dtype})
        return out

    monkeypatch.setattr(pgen, "mrf_conv", spy)
    port, _ = tiny_sovits_train(seed=6)
    set_compute_dtype(port, BF)
    z = torch.randn(2, CFG.inter_channels, 8)
    g = torch.randn(2, CFG.gin_channels, 1)
    y = port.dec(z.to(BF), g=g.to(BF))
    assert y.dtype == BF
    y.float().square().sum().backward()
    n = len(CFG.upsample_rates) * len(CFG.resblock_kernel_sizes) * 6
    assert seen == [{BF}] * (2 * n)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in port.dec.parameters() if p.grad is not None)
