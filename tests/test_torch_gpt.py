"""Parity of the PyTorch port's s1 GPT with the JAX package: prefill
attention (K1's twin), decode attention (K2's twin), the sampler pieces and
greedy ``decode_ar``.  fp32 on the CPU; tolerances are relative to the
reference's largest magnitude (1e-4 for one layer, 2e-4 through the stack:
the two frameworks sum matmuls in different orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easevoice_trainer_tpu.models.gpt import decode as jdecode
from easevoice_trainer_tpu.models.gpt import t2s as jt2s
from easevoice_trainer_tpu_torch.models.gpt import decode as pdecode
from easevoice_trainer_tpu_torch.models.gpt import t2s as pt2s
from easevoice_trainer_tpu_torch.ops import attention as patt

from _torch_port_tiny import T2S_KW, assert_close, tiny_gpt

B, X_LEN, PROMPT = 3, 16, 12
X_LENS = np.array([16, 9, 5], np.int32)


@pytest.fixture(scope="module")
def gpt():
    port, params, state = tiny_gpt()
    jmodel = jt2s.Text2SemanticDecoder(jt2s.T2SConfig(**T2S_KW))
    return port, jmodel, params, state


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    x = rng.integers(1, 700, (B, X_LEN)).astype(np.int32)
    x[np.arange(X_LEN)[None, :] >= X_LENS[:, None]] = 0
    prompts = rng.integers(0, 1024, (B, PROMPT)).astype(np.int32)
    bert = rng.normal(0, 0.5, (B, X_LEN, 1024)).astype(np.float32)
    return x, prompts, bert


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def test_convert_roundtrip_is_exact(gpt):
    port, _, _, state = gpt
    got = port.state_dict()
    assert set(got) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_config_dataclasses_match_jax():
    for jcls, pcls in ((jt2s.T2SConfig, pt2s.T2SConfig),
                       (jdecode.DecodeParams, pdecode.DecodeParams)):
        jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
        pf = [(f.name, f.default) for f in dataclasses.fields(pcls)]
        assert jf == pf


@pytest.mark.parametrize("y_lens", [[12, 12, 12], [12, 7, 3]])
def test_hybrid_mask_bias_matches_jax(y_lens):
    want = np.asarray(jt2s.build_hybrid_mask_bias(
        X_LEN, 12, jnp.asarray(X_LENS), jnp.asarray(y_lens)))
    got = patt.build_hybrid_mask_bias(X_LEN, 12, _t(X_LENS),
                                      _t(np.asarray(y_lens))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("y_lens", [[12, 12, 12], [12, 7, 3]])
def test_prefill_attention_twin_vs_jax_layer(gpt, y_lens):
    """K1's twin inside the port's TransformerLayer.attention against the
    JAX TransformerLayer.attention under build_hybrid_mask_bias."""
    port, jmodel, params, _ = gpt
    rng = np.random.default_rng(3)
    h = rng.normal(0, 1, (B, X_LEN + 12, T2S_KW["hidden_dim"])).astype(
        np.float32)
    y_lens = np.asarray(y_lens, np.int32)
    bias = jt2s.build_hybrid_mask_bias(X_LEN, 12, jnp.asarray(X_LENS),
                                       jnp.asarray(y_lens))
    want, (wk, wv) = jmodel.apply(
        {"params": params}, h, bias,
        method=lambda m, h, b: m.layers[0].attention(h, b))
    with torch.no_grad():
        got, (gk, gv) = port.h.layers[0].attention(
            _t(h), X_LEN, _t(X_LENS), _t(y_lens))
    assert_close(got.numpy(), want, 1e-4, "attention")
    assert_close(gk.numpy(), wk, 1e-5, "k")
    assert_close(gv.numpy(), wv, 1e-5, "v")


def test_prefill_matches_jax(gpt, inputs):
    port, jmodel, params, _ = gpt
    x, prompts, bert = inputs
    cache_len = X_LEN + PROMPT + 8
    wl, wk, wv = jmodel.apply({"params": params}, x, X_LENS, prompts, bert,
                              cache_len, method=jt2s.Text2SemanticDecoder.prefill)
    gl, gk, gv = port.prefill(_t(x, torch.int64), _t(X_LENS),
                              _t(prompts, torch.int64), _t(bert), cache_len)
    assert_close(gl.numpy(), wl, 2e-4, "logits")
    assert_close(gk.numpy(), wk, 2e-4, "k cache")
    assert_close(gv.numpy(), wv, 2e-4, "v cache")


def test_decode_step_twin_matches_jax(gpt, inputs):
    """Three chained decode steps: K2's twin with the inline validity test
    (text pads in the middle of the cache) against decode_step + kv_bias."""
    port, jmodel, params, _ = gpt
    x, prompts, bert = inputs
    max_new = 8
    cache_len = X_LEN + PROMPT + max_new
    _, jk, jv = jmodel.apply({"params": params}, x, X_LENS, prompts, bert,
                             cache_len, method=jt2s.Text2SemanticDecoder.prefill)
    _, pk, pv = port.prefill(_t(x, torch.int64), _t(X_LENS),
                             _t(prompts, torch.int64), _t(bert), cache_len)
    slot = np.arange(cache_len)
    rng = np.random.default_rng(5)
    for step in range(3):
        token = rng.integers(0, 1024, (B,)).astype(np.int32)
        ok = ((slot[None] < X_LENS[:, None])
              | ((slot[None] >= X_LEN)
                 & (slot[None] < X_LEN + PROMPT + step + 1)))
        kv_bias = np.where(ok, 0.0, -np.inf).astype(np.float32)[:, None,
                                                                None]
        wl, jk, jv = jmodel.apply(
            {"params": params}, token, PROMPT + step, X_LEN + PROMPT + step,
            jk, jv, kv_bias, method=jt2s.Text2SemanticDecoder.decode_step)
        gl = port.decode_step(_t(token, torch.int64), step, pk, pv, X_LEN,
                              _t(X_LENS), PROMPT)
        assert_close(gl.numpy(), wl, 2e-4, f"logits step {step}")
        assert_close(pk.numpy(), jk, 2e-4, f"k cache step {step}")
        assert_close(pv.numpy(), jv, 2e-4, f"v cache step {step}")


@pytest.mark.parametrize("step", [0, 5])
def test_decode_attention_twin_vs_jax_attention_step(gpt, step):
    """K2's wrapper on the CPU inside one layer: q/k/v as strided views of
    the fused projection (``TransformerLayer.qkv``), the new K/V written
    into the cache and attended to, against the JAX
    ``TransformerLayer.attention_step`` (dynamic_update_slice + kv_len_mask):
    the projected output and both caches within 1e-5."""
    port, jmodel, params, _ = gpt
    rng = np.random.default_rng(17 + step)
    d, heads = T2S_KW["hidden_dim"], T2S_KW["n_heads"]
    cache_len = X_LEN + PROMPT + 8
    h = rng.normal(0, 1, (B, 1, d)).astype(np.float32)
    kc = rng.normal(0, 1, (B, cache_len, heads, d // heads)).astype(
        np.float32)
    vc = rng.normal(0, 1, kc.shape).astype(np.float32)
    pos = X_LEN + PROMPT + step
    slot = np.arange(cache_len)
    ok = (slot[None] < X_LENS[:, None]) | ((slot[None] >= X_LEN)
                                           & (slot[None] <= pos))
    mask = np.where(ok, 0.0, -np.inf).astype(np.float32)[:, None, None]
    want, wk, wv = jmodel.apply(
        {"params": params}, h, kc, vc, pos, mask,
        method=lambda m, *a: m.layers[0].attention_step(*a))
    layer = port.h.layers[0]
    pk, pv = _t(kc), _t(vc)
    with torch.no_grad():
        q, k, v = layer.qkv(_t(h))
        assert not q.is_contiguous()
        o = patt.decode_attention(q, k, v, pk, pv, X_LEN, _t(X_LENS),
                                  PROMPT, step)
        got = layer.self_attn.out_proj(o.reshape(h.shape))
    assert_close(got.numpy(), want, 1e-5, "attention step")
    assert_close(pk.numpy(), wk, 1e-5, "k cache")
    assert_close(pv.numpy(), wv, 1e-5, "v cache")


def test_sampler_pieces_match_jax():
    rng = np.random.default_rng(13)
    logits = rng.normal(0, 3, (4, 1025)).astype(np.float32)
    history = rng.integers(0, 1025, (4, 40)).astype(np.int32)
    valid = rng.random((4, 40)) < 0.7
    want = np.asarray(jdecode.apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(history), jnp.asarray(valid), 1.35))
    got = pdecode.apply_repetition_penalty(_t(logits), _t(history),
                                           _t(valid), 1.35).numpy()
    np.testing.assert_array_equal(got, want)
    for top_k in (1, 15):
        want = np.asarray(jdecode.apply_top_k(jnp.asarray(logits), top_k))
        got = pdecode.apply_top_k(_t(logits), top_k).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jdecode.apply_top_p(jnp.asarray(logits), 0.8))
    got = pdecode.apply_top_p(_t(logits), 0.8).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))


def test_sample_token_follows_probabilities():
    """The exponential race draws each id with its softmax probability."""
    logits = torch.tensor([[0.0, np.log(3.0), -np.inf, np.log(6.0)]])
    params = pdecode.DecodeParams(top_k=0, repetition_penalty=1.0)
    gen = torch.Generator().manual_seed(0)
    hist = torch.zeros((1, 1), dtype=torch.int64)
    draws = torch.stack([
        pdecode.sample_token(logits, hist, torch.zeros_like(hist, dtype=bool),
                             params, gen) for _ in range(4000)])
    freq = torch.bincount(draws.flatten(), minlength=4).double() / 4000
    torch.testing.assert_close(freq, torch.tensor([0.1, 0.3, 0.0, 0.6],
                                                  dtype=torch.float64),
                               atol=0.03, rtol=0)


def test_greedy_decode_ar_matches_jax(gpt, inputs):
    """top_k=1 draws no randomness: tokens and lengths must be identical."""
    port, jmodel, params, _ = gpt
    x, prompts, bert = inputs
    dp = dict(top_k=1, max_new_tokens=64, min_tokens=4)
    wt, wl = jdecode.decode_ar(jmodel, {"params": params},
                               jax.random.PRNGKey(0), x, X_LENS, prompts,
                               bert, jdecode.DecodeParams(**dp))
    gt, gl = pdecode.decode_ar(port, _t(x, torch.int64), _t(X_LENS),
                               _t(prompts, torch.int64), _t(bert),
                               pdecode.DecodeParams(**dp),
                               torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
