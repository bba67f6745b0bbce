"""Dropout in the s1 GPT fine-tune (``T2SConfig.dropout > 0``) of the
PyTorch port against the JAX package on the CPU, at the size of
``tests/test_torch_s1.py`` (2 layers, width 64, 2 heads of dk 32, ffn 128;
B = 3 with ragged lengths).

The port draws the attention's keep mask from its own Philox4x32-10
(``ops/philox.py``, the twin of ``csrc/philox.cuh``, which K1 and K5 draw
from on the card) and the other three sites' masks from a
``torch.Generator``; the JAX package draws all four from threefry, which
no port reproduces.  So the comparisons with JAX hand flax the port's own
masks: the test records each mask the port draws, in the order the JAX
layer drops (the probabilities, the attention output, the FFN's hidden
layer, the FFN output), and patches ``flax.linen.Dropout.__call__`` for
the duration of one test to apply them in that order.  Under ``jax.jit``
the masks go in as arguments (a batch entry), never as constants a trace
would freeze.  Tolerances are those of ``tests/test_torch_s1.py`` (fp32)
and ``tests/test_torch_bf16_s1.py`` (bf16), relative to the reference's
largest magnitude (``assert_close``).  A bf16 gradient of a weight is a
bf16 product rounded before its cast to the fp32 parameter: the two
frameworks sum it in other orders, so it may land one bf16 step apart
(2^-7, as the bf16 logits); without dropout the two happen to agree bit for
bit at this size, and a scaling by 1 / (1 - p) alone, with no element
dropped, already moves some of these sums a step apart."""
import contextlib
import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from easevoice_trainer_tpu.models.gpt import dpo as jdpo
from easevoice_trainer_tpu.models.gpt import t2s as jt2s
from easevoice_trainer_tpu.train import gpt_step as jstep
from easevoice_trainer_tpu_torch import convert
from easevoice_trainer_tpu_torch.models.gpt import dpo as pdpo
from easevoice_trainer_tpu_torch.models.gpt import t2s as pt2s
from easevoice_trainer_tpu_torch.nn import layers
from easevoice_trainer_tpu_torch.nn.layers import set_compute_dtype
from easevoice_trainer_tpu_torch.ops import attention as att
from easevoice_trainer_tpu_torch.ops import philox
from easevoice_trainer_tpu_torch.train import gpt as ptrain
from easevoice_trainer_tpu_torch.train import gpt_step as pstep

from _torch_port_tiny import T2S_KW, assert_close, tiny_gpt
from test_torch_s1 import S1_KW, X_LEN, X_LENS, Y_LEN, Y_LENS, _args, \
    _batch, _jax_state, _torch_batch
from test_trainers import TINY_GPT, workspace  # noqa: F401  (a fixture)

P = 0.1
BF = torch.bfloat16
JCFG = jt2s.T2SConfig(**{**T2S_KW, **S1_KW, "dropout": P})


def _f32(a):
    return np.asarray(a, np.float32)


# ---- the port's masks, and flax made to apply them --------------------------


@contextlib.contextmanager
def recorded_masks(masks: list):
    """Appends every keep mask the port's GPT draws to ``masks`` (numpy
    bool), in call order: a layer's attention mask (B, H, T, T) from the
    ``AttentionDropout`` it hands ``self_attention``, then the masks of
    ``nn.layers.dropout`` at its three other sites (the generator's state
    is replayed, so the port's own draw is unchanged)."""
    real_attn, real_drop = pt2s.self_attention, pt2s.dropout

    def attn(qkv, n_heads, x_len, x_lens, y_lens, dropout=None):
        if dropout is not None and 0 < dropout.p < 1:
            b, t, _ = qkv.shape
            masks.append(dropout.keep_mask(b, n_heads, t, x_len,
                                           qkv.device).numpy())
        return real_attn(qkv, n_heads, x_len, x_lens, y_lens, dropout)

    def drop(x, p, training, generator):
        if training and 0 < p < 1:
            state = generator.get_state()
            masks.append((real_drop(torch.ones_like(x), p, training,
                                    generator) != 0).numpy())
            generator.set_state(state)
        return real_drop(x, p, training, generator)

    pt2s.self_attention, pt2s.dropout = attn, drop
    try:
        yield masks
    finally:
        pt2s.self_attention, pt2s.dropout = real_attn, real_drop


@pytest.fixture
def flax_masks(monkeypatch):
    """A list flax's Dropout takes its masks from, first in first out:
    ``select(mask, x / keep_prob, 0)`` as flax computes it, the rate-0 and
    deterministic cases untouched.  The list may hold tracers (the masks
    of a jitted step, given as arguments)."""
    queue = []

    def call(self, inputs, deterministic=None, rng=None):
        deterministic = flax_nn.merge_param(
            "deterministic", self.deterministic, deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        mask = jnp.asarray(queue.pop(0))
        assert mask.shape == inputs.shape, (mask.shape, inputs.shape)
        return jax.lax.select(mask, inputs / (1.0 - self.rate),
                              jnp.zeros_like(inputs))

    monkeypatch.setattr(flax_nn.Dropout, "__call__", call)
    return queue


def _port_gpt(dtype=None, seed=21, dropout=P):
    model, params, _ = tiny_gpt(seed=seed, **S1_KW, dropout=dropout)
    if dtype is not None:
        set_compute_dtype(model, dtype)
    return model.train(), params


# ---- (a) Philox4x32-10 ------------------------------------------------------

# Random123's known-answer vectors: counter, key, the four output words
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    """``philox4x32_10`` reproduces Random123's known-answer vectors."""
    got = philox.philox4x32_10(*(torch.tensor(c) for c in counter), *key)
    assert tuple(int(w) for w in got) == want


# ---- (b) the keep mask ------------------------------------------------------


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_mask_rate(p):
    """Over the visible pairs of a (B=3, H=4, T=300) hybrid mask the kept
    share is 1 - p within 6 sigma; the threshold's own error is below
    2^-16 (it is floor((1 - p) 2^32))."""
    b, h, x_len, y_len = 3, 4, 70, 230
    xl, yl = torch.tensor([70, 31, 5]), torch.tensor([230, 201, 17])
    mask = philox.attention_keep_mask(5, 2, b, h, x_len + y_len, x_len, p)
    vis = (att.build_hybrid_mask_bias(x_len, y_len, xl, yl) == 0).expand(
        b, h, x_len + y_len, x_len + y_len)
    n = int(vis.sum())
    rate = float((mask & vis).sum()) / n
    assert abs(rate - (1 - p)) <= 6 * (p * (1 - p) / n) ** 0.5, rate
    assert abs(philox.keep_threshold(p) / 2 ** 32 - (1 - p)) <= 2 ** -16


def test_keep_mask_depends_on_seed_and_layer_alone():
    """Other seeds and other layers give other masks; a sub-block (fewer
    batch rows, heads, rows and keys, the same x_len) equals the same slice
    of the whole; each bit is word key % 4 of one Philox call on
    (key // 4 in its segment, row, b, layer << 16 | h << 1 | audio), the
    documented packing."""
    t, x_len = 45, 13
    whole = philox.attention_keep_mask(7, 1, 3, 2, t, x_len, P)
    for other in (philox.attention_keep_mask(8, 1, 3, 2, t, x_len, P),
                  philox.attention_keep_mask(7, 2, 3, 2, t, x_len, P)):
        assert not torch.equal(whole, other)
    part = philox.attention_keep_mask(7, 1, 2, 1, 30, x_len, P)
    assert torch.equal(part, whole[:2, :1, :30, :30])
    k0, k1 = philox.split_seed(7)
    rng = np.random.default_rng(0)
    for b, h, row, key in rng.integers(0, [3, 2, t, t], (40, 4)):
        audio = int(key >= x_len)
        i = key - x_len if audio else key
        words = philox.philox4x32_10(i // 4, row, b, 1 << 16 | h << 1 | audio,
                                     k0, k1)
        want = int(words[i % 4]) < philox.keep_threshold(P)
        assert bool(whole[b, h, row, key]) == want


def test_keep_mask_row0_is_the_global_batch_row():
    """A mask drawn for the batch rows ``row0 ..`` of a data-parallel
    rank is those rows of the global batch's mask, bit for bit, through
    ``attention_keep_mask`` and through ``AttentionDropout.row0``."""
    t, x_len = 45, 13
    whole = philox.attention_keep_mask(7, 1, 5, 2, t, x_len, P)
    for row0 in (0, 1, 3):
        part = philox.attention_keep_mask(7, 1, 2, 2, t, x_len, P, row0=row0)
        assert torch.equal(part, whole[row0:row0 + 2])
    drop = att.AttentionDropout(P, 7, 1, row0=3)
    assert torch.equal(drop.keep_mask(2, 2, t, x_len, "cpu"), whole[3:])


def test_keep_mask_h0_is_the_layer_head():
    """A mask drawn for the heads ``h0 ..`` of a tensor-parallel rank is
    those heads of the whole layer's mask, bit for bit (the bits of (h0,
    h) are those of (0, h0 + h)), through ``attention_keep_mask`` and
    through ``AttentionDropout.h0``, with and without ``row0``."""
    t, x_len = 45, 13
    whole = philox.attention_keep_mask(7, 1, 3, 16, t, x_len, P)
    for h0 in (0, 4, 8, 12):
        part = philox.attention_keep_mask(7, 1, 3, 4, t, x_len, P, h0=h0)
        assert torch.equal(part, whole[:, h0:h0 + 4])
    drop = att.AttentionDropout(P, 7, 1, row0=1, h0=8)
    assert torch.equal(drop.keep_mask(2, 8, t, x_len, "cpu"),
                       whole[1:, 8:])
    assert not torch.equal(whole[:, :8], whole[:, 8:])


# the lengths of the mask-as-bits cases: (x_len, x_lens, y_len, y_lens,
# row0, h0): text only, audio only, ragged lengths off the 32-key words,
# words on the edges, a data-parallel rank's rows and a tensor-parallel
# rank's heads
BITS_CASES = [
    (45, [45, 13, 1], 0, [0, 0, 0], 0, 0),           # text only
    (0, [0, 0], 70, [70, 33], 0, 0),                 # audio only
    (37, [37, 20, 5], 90, [90, 71, 2], 0, 0),        # ragged
    (64, [64, 32], 64, [64, 31], 3, 0),              # words on the edges
    (33, [1, 33], 31, [31, 0], 5, 8),                # row0 and h0
]


def _bits_case(x_len, x_lens, y_len, y_lens, row0, h0):
    drop = att.AttentionDropout(P, 2 ** 35 + 11, 4, row0, h0)
    b, t = len(x_lens), x_len + y_len
    xl, yl = torch.tensor(x_lens), torch.tensor(y_lens)
    vis = att.build_hybrid_mask_bias(x_len, y_len, xl, yl) == 0
    return drop, b, t, xl, yl, drop.keep_mask(b, 2, t, x_len, "cpu") & vis


@pytest.mark.parametrize("x_len,x_lens,y_len,y_lens,row0,h0", BITS_CASES)
def test_keep_mask_packs_into_bits_and_back(x_len, x_lens, y_len, y_lens,
                                            row0, h0):
    """``pack_keep_mask`` of the visible keep mask is (B, H, T, W) int32
    with W = ceil(x_len / 32) + ceil(y_len / 32), bit j of word w of a
    segment being key 32 w + j of it (checked on every pair), and
    ``unpack_keep_mask`` gives the mask back."""
    _, b, t, _, _, mask = _bits_case(x_len, x_lens, y_len, y_lens, row0, h0)
    bits = philox.pack_keep_mask(mask, x_len)
    n_text = -(-x_len // 32)
    assert bits.dtype == torch.int32 and bits.shape == (
        b, 2, t, n_text + -(-y_len // 32)) and \
        bits.shape[-1] == philox.mask_words(t, x_len)
    assert torch.equal(philox.unpack_keep_mask(bits, t, x_len), mask)
    keys = torch.arange(t)
    word = torch.where(keys < x_len, keys // 32,
                       n_text + (keys - x_len) // 32)
    bit = torch.where(keys < x_len, keys % 32, (keys - x_len) % 32)
    got = (bits.long()[..., word] >> bit) & 1
    assert torch.equal(got.bool(), mask)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("x_len,x_lens,y_len,y_lens,row0,h0", BITS_CASES)
def test_k1_twin_writes_the_mask_it_applies(dtype, x_len, x_lens, y_len,
                                            y_lens, row0, h0):
    """K1's dropout twin (``prefill_attention_lse`` on the CPU with
    ``mask_bits``), fp32 and bf16, fills exactly ``pack_keep_mask`` of the
    mask it applies, AND-ed with the visible pairs
    (``keep_bits_reference``), and its o is the twin's with the mask read
    back from those bits."""
    drop, b, t, xl, yl, mask = _bits_case(x_len, x_lens, y_len, y_lens, row0,
                                          h0)
    rng = np.random.default_rng(row0 + h0 + t)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, t, 2, 32))).to(dtype)
               for _ in range(3))
    bits = torch.full_like(att.new_mask_bits(q, x_len), -1)
    o, _ = att.prefill_attention_lse(q, k, v, x_len, xl, yl, drop,
                                     mask_bits=bits)
    assert torch.equal(bits, philox.pack_keep_mask(mask, x_len))
    assert torch.equal(bits, att.keep_bits_reference(
        drop.keep_mask(b, 2, t, x_len, "cpu"), x_len, xl, yl))
    again = att.prefill_attention_reference(
        q, k, v, x_len, xl, yl, philox.unpack_keep_mask(bits, t, x_len), P)
    assert torch.equal(torch.nan_to_num(o), torch.nan_to_num(again))


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("x_len,x_lens,y_len,y_lens,row0,h0",
                         BITS_CASES[2:])
def test_k5_twin_given_the_bits_is_the_twin_given_the_mask(
        dtype, x_len, x_lens, y_len, y_lens, row0, h0):
    """K5's dropout twin (``prefill_attention_bwd`` on the CPU) given the
    bits K1's twin wrote gives, bit for bit, what it gives drawing the
    boolean mask: the hidden pairs the bits leave out have P = 0."""
    drop, b, t, xl, yl, _ = _bits_case(x_len, x_lens, y_len, y_lens, row0,
                                       h0)
    rng = np.random.default_rng(7 * t)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, t, 2, 32))).to(dtype)
                   for _ in range(4))
    bits = att.new_mask_bits(q, x_len)
    o, lse = att.prefill_attention_lse(q, k, v, x_len, xl, yl, drop,
                                       mask_bits=bits)
    o = torch.nan_to_num(o)
    got = att.prefill_attention_bwd(q, k, v, o, lse, do, x_len, xl, yl,
                                    dropout=drop, mask_bits=bits)
    want = att.prefill_attention_bwd(q, k, v, o, lse, do, x_len, xl, yl,
                                     dropout=drop)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k5_fp32_twin_from_the_bits_matches_jax(flax_masks):
    """K5's fp32 dropout twin (``prefill_attention_bwd`` on the CPU), given
    the bits K1's fp32 twin wrote, against JAX's gradient of
    ``TransformerLayer.attention`` in its q, k and v (the fused projection's
    output, which a flax method interceptor hands the layer in place of
    ``qkv(x)``; ``out`` passed through), flax dropping the probabilities
    with the port's keep mask: dq, dk, dv within 1e-5 relative to the
    largest magnitude (fp32 against fp32), and K1's o within the same."""
    rng = np.random.default_rng(23)
    b, h, dk, t = len(X_LENS), 2, 32, X_LEN + Y_LEN
    d = h * dk
    qkv = rng.normal(size=(b, t, 3 * d)).astype(np.float32)
    do = rng.normal(size=(b, t, h, dk)).astype(np.float32)
    xl, yl = torch.tensor(X_LENS), torch.tensor(Y_LENS)
    drop = att.AttentionDropout(P, 2 ** 34 + 5, 1)
    q, k, v = att._split_heads(torch.from_numpy(qkv), h)
    bits = att.new_mask_bits(q, X_LEN)
    o, lse = att.prefill_attention_lse(q, k, v, X_LEN, xl, yl, drop,
                                       mask_bits=bits)
    got = att.prefill_attention_bwd(q, k, v, o, lse, torch.from_numpy(do),
                                    X_LEN, xl, yl, dropout=drop,
                                    mask_bits=bits)
    flax_masks.append(drop.keep_mask(b, h, t, X_LEN, "cpu").numpy())
    layer = jt2s.TransformerLayer(d, h, 128, dropout=P)
    bias = jt2s.build_hybrid_mask_bias(X_LEN, Y_LEN, jnp.asarray(X_LENS),
                                       jnp.asarray(Y_LENS))

    def jloss(z):
        def inject(call, args, kwargs, context):
            name = context.module.name
            if context.method_name != "__call__" or name not in ("qkv",
                                                                 "out"):
                return call(*args, **kwargs)
            return z if name == "qkv" else args[0]

        with flax_nn.intercept_methods(inject):
            y, _ = layer.apply({"params": {}}, jnp.zeros((b, t, d)), bias,
                               False, method=jt2s.TransformerLayer.attention)
        return jnp.sum(y * do.reshape(b, t, d)), y

    (_, jo), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(qkv))
    assert not flax_masks
    assert_close(o.reshape(b, t, d).numpy(), _f32(jo), 1e-5, "o")
    for name, g, w in zip(("dq", "dk", "dv"), got,
                          np.split(_f32(jg), 3, axis=-1)):
        assert_close(g.numpy(), w.reshape(b, t, h, dk), 1e-5, name)


def test_mask_bits_are_checked():
    """The wrappers refuse bits without dropout and bits of another shape
    or dtype than ``new_mask_bits`` makes."""
    drop, b, t, xl, yl, _ = _bits_case(*BITS_CASES[2])
    q = torch.zeros((b, t, 2, 32))
    bits = att.new_mask_bits(q, 37)
    assert bits.shape == (b, 2, t, philox.mask_words(t, 37))
    for bad, d in ((bits, None), (bits[..., 1:].contiguous(), drop),
                   (bits.long(), drop)):
        with pytest.raises(ValueError, match="mask_bits"):
            att.prefill_attention_lse(q, q, q, 37, xl, yl, d, mask_bits=bad)
        with pytest.raises(ValueError, match="mask_bits"):
            att.prefill_attention_bwd(q, q, q, q, q[..., 0].transpose(1, 2),
                                      q, 37, xl, yl, dropout=d,
                                      mask_bits=bad)


# ---- (c) the twins with a mask ----------------------------------------------


def _qkv(seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    b, h, dk, t = len(X_LENS), 2, 32, X_LEN + Y_LEN
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * h * dk))).to(dtype)
    do = torch.from_numpy(rng.normal(size=(b, t, h, dk))).to(dtype)
    return qkv, do, torch.tensor(X_LENS), torch.tensor(Y_LENS), h


def test_k1_twin_with_mask_is_dense_math():
    """K1's twin with a keep mask (and the wrapper on the CPU, which draws
    the mask itself) equals the dense math written out per (b, h):
    softmax over the visible keys, the kept probabilities divided by
    1 - p, times v (fp64, 1e-12 absolute; rows that see no key aside)."""
    qkv, _, xl, yl, h = _qkv(1)
    drop = att.AttentionDropout(P, 31, 1)
    q, k, v = att._split_heads(qkv, h)
    b, t = qkv.shape[:2]
    mask = drop.keep_mask(b, h, t, X_LEN, "cpu")
    o, _ = att.prefill_attention_lse(q, k, v, X_LEN, xl, yl, drop)
    bias = att.build_hybrid_mask_bias(X_LEN, Y_LEN, xl, yl)
    for bi in range(b):
        for hi in range(h):
            s = q[bi, :, hi] @ k[bi, :, hi].T / 32 ** 0.5 + bias[bi, 0]
            pr = torch.softmax(s, -1) * mask[bi, hi] / (1 - P)
            want = pr @ v[bi, :, hi]
            seen = torch.isfinite(bias[bi, 0]).any(-1)
            torch.testing.assert_close(o[bi, seen, hi], want[seen], rtol=0,
                                       atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, BF])
def test_k5_twin_with_mask_is_autograd_of_k1_twin(dtype):
    """K5's twin with the mask (the wrapper on the CPU) equals autograd of
    K1's twin with the same mask: fp64 within 1e-12 absolute; bf16, where
    both compute in fp32 from the bf16 inputs and round the gradients,
    within the bf16 rule (2^-6 of the largest magnitude, at most 2 % of
    the elements a step apart).  In bf16 K5's twin is given K1's o before
    its rounding to bf16, the o whose D = rowsum(dO o) autograd uses."""
    qkv, do, xl, yl, h = _qkv(2, dtype)
    qkv.requires_grad_()
    drop = att.AttentionDropout(P, 2 ** 33 + 3, 1)
    o = att.self_attention(qkv, h, X_LEN, xl, yl, drop)
    o.backward(do)
    q, k, v = att._split_heads(qkv.detach(), h)
    lse = att.prefill_attention_lse_reference(q, k, X_LEN, xl, yl)
    b, t = qkv.shape[:2]
    o = att.prefill_attention_reference(
        q.double(), k.double(), v.double(), X_LEN, xl, yl,
        drop.keep_mask(b, h, t, X_LEN, "cpu"), P).float() \
        if dtype == BF else o.detach()
    got = att.prefill_attention_bwd(q, k, v, o, lse, do, X_LEN, xl, yl,
                                    dropout=drop)
    want = qkv.grad.view(b, t, 3, h, 32)
    for i, g in enumerate(got):
        w = want[:, :, i]
        if dtype == torch.float64:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-12)
        else:
            err = (g.float() - w.float()).abs()
            assert float(err.max()) <= 2 ** -6 * max(1.0, float(
                w.float().abs().max()))
            assert float((err > 2 ** -7 * w.float().abs() + 1e-6).float()
                         .mean()) <= 0.02


# ---- (d) the layer and the training forward against JAX ---------------------


@pytest.mark.parametrize("dtype", [None, BF])
def test_layer_with_dropout_matches_jax(dtype, flax_masks):
    """One ``TransformerLayer.train_forward`` at dropout 0.1 against the JAX
    layer with ``deterministic=False`` given the port's four masks: output
    within 1e-5 (fp32) / 1e-4 (bf16), and the gradients in the input, the
    qkv kernel and both FFN kernels within 1e-4 (fp32) / one bf16 step
    (2^-7)."""
    model, params = _port_gpt(dtype)
    lp = params["layer_0"]
    rng = np.random.default_rng(5)
    b, t, d = len(X_LENS), X_LEN + Y_LEN, 64
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    w = rng.normal(size=(b, t, d)).astype(np.float32)
    tl = model.h.layers[0]
    xt = torch.from_numpy(x).requires_grad_()
    masks = []
    with recorded_masks(masks):
        gen = torch.Generator().manual_seed(3)
        y = tl.train_forward(xt, X_LEN, torch.tensor(X_LENS),
                             torch.tensor(Y_LENS),
                             pt2s.LayerRng(11, 0, gen))
    tl.zero_grad()
    (y * torch.from_numpy(w)).sum().backward()
    assert [m.shape for m in masks] == [(b, 2, t, t), (b, t, d), (b, t, 128),
                                        (b, t, d)]
    flax_masks.extend(masks)
    layer = jt2s.TransformerLayer(d, 2, 128, dropout=P,
                                  dtype=None if dtype is None
                                  else jnp.bfloat16)
    bias = jt2s.build_hybrid_mask_bias(X_LEN, Y_LEN, jnp.asarray(X_LENS),
                                       jnp.asarray(Y_LENS))

    def jloss(x, p):
        out, _ = layer.apply({"params": p}, x, bias, False)
        return jnp.sum(out * w), out

    (_, jy), (jgx, jgp) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(jnp.asarray(x), lp)
    assert not flax_masks
    tol = 1e-4 if dtype is None else 2 ** -7
    assert_close(y.detach().numpy(), _f32(jy), 1e-5 if dtype is None else
                 1e-4, "layer output")
    assert_close(xt.grad.numpy(), _f32(jgx), tol, "d input")
    for name, grad in (("qkv", tl.self_attn.in_proj_weight.grad),
                       ("linear1", tl.linear1.weight.grad),
                       ("linear2", tl.linear2.weight.grad)):
        assert_close(grad.numpy().T, _f32(jgp[name]["kernel"]), tol,
                     f"d {name} kernel")


@pytest.mark.parametrize("dtype", [None, BF])
def test_training_forward_with_dropout_matches_jax(dtype, flax_masks):
    """``Text2SemanticDecoder.forward`` in training mode at dropout 0.1
    against the JAX ``__call__`` with ``deterministic=False`` given the
    port's 4 masks a layer: the loss within 1e-5 (fp32) / 1e-4 (bf16)
    relative, the logits within 1e-5 / one bf16 step (2^-7), and every
    layer's qkv, linear1 and linear2 kernel gradients within 1e-4 / one
    bf16 step (2^-7)."""
    model, params = _port_gpt(dtype)
    batch = _batch(7)
    masks = []
    with recorded_masks(masks):
        got = model(*_args(_torch_batch(batch)), seed=123)
    got["loss"].backward()
    assert len(masks) == 4 * S1_KW["n_layers"]
    flax_masks.extend(masks)
    jmodel = jt2s.Text2SemanticDecoder(
        JCFG, dtype=None if dtype is None else jnp.bfloat16)

    def jloss(p):
        out = jmodel.apply({"params": p}, *_args(batch), deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return out["loss"], out

    (_, want), grads = jax.value_and_grad(jloss, has_aux=True)(params)
    assert not flax_masks
    tol = 1e-5 if dtype is None else 1e-4
    assert_close(float(got["loss"].detach()), float(want["loss"]), tol,
                 "loss")
    assert_close(got["logits"].float().detach().numpy(),
                 _f32(want["logits"]), 1e-5 if dtype is None else 2 ** -7,
                 "logits")
    for i, layer in enumerate(model.h.layers):
        jl = grads[f"layer_{i}"]
        for name, grad in (("qkv", layer.self_attn.in_proj_weight.grad),
                           ("linear1", layer.linear1.weight.grad),
                           ("linear2", layer.linear2.weight.grad)):
            assert_close(grad.numpy().T, _f32(jl[name]["kernel"]),
                         1e-4 if dtype is None else 2 ** -7,
                         f"layer {i} d {name}")


# ---- (e) an accumulation window of GPTTrainStep against make_train_step -----


def _jitted_step_with_masks(hp, flax_masks, dtype=None):
    """``make_train_step`` under jit with the dropout masks as a batch entry
    (``drop_masks``), handed to flax through ``flax_masks`` while it
    traces."""
    train_step = jstep.make_train_step(
        jt2s.Text2SemanticDecoder(JCFG, dtype=dtype), hp)

    def step(state, batch, rng):
        batch = dict(batch)
        flax_masks[:] = list(batch.pop("drop_masks"))
        return train_step(state, batch, rng)

    return jax.jit(step)


@pytest.mark.parametrize("dtype", [None, BF])
def test_accumulation_window_with_dropout_matches_jax(dtype, flax_masks,
                                                      monkeypatch):
    """Four ``GPTTrainStep`` micro-batches (one accumulation window, the
    fourth with the ScaledAdam step) at dropout 0.1, each with its own seed,
    against ``make_train_step`` given the port's masks of each micro-batch:
    per micro-batch the loss within 1e-5 (fp32) / 1e-4 (bf16) relative and
    the gradient norm within 1e-4 / 1e-3; every parameter within 1e-4
    relative after each."""
    monkeypatch.setenv("EASEVOICE_OPT_STATE", "fp32")
    model, params = _port_gpt(dtype, seed=22)
    hp = jstep.GPTTrainHP()
    state = _jax_state(params, hp)
    jax_step = _jitted_step_with_masks(
        hp, flax_masks, None if dtype is None else jnp.bfloat16)
    port = pstep.GPTTrainStep(model, pstep.GPTTrainHP())
    tol_loss, tol_norm = (1e-5, 1e-4) if dtype is None else (1e-4, 1e-3)
    for i in range(4):
        batch = _batch(100 + i)
        masks = []
        with recorded_masks(masks):
            got = port(_torch_batch(batch), seed=1000 + i)
        state, metrics = jax_step(state, dict(batch, drop_masks=masks),
                                  jax.random.PRNGKey(i))
        assert_close(float(got["loss"]), float(metrics["loss"]), tol_loss,
                     f"loss {i}")
        assert_close(float(got["grad_norm"]), float(metrics["grad_norm"]),
                     tol_norm, f"grad_norm {i}")
        want = convert.gpt_state_dict(jstep.params_tree(state))
        sd = model.state_dict()
        for k, v in want.items():
            assert_close(sd[k].numpy(), v.numpy(), 1e-4, f"{i} {k}")
    assert port.optimizer.param_groups[0]["step"] == 1


def test_train_step_needs_a_seed_when_it_drops():
    """``GPTTrainStep`` on a model with dropout > 0 raises without a seed,
    as ``nn.layers.dropout`` does without a generator; so does the
    training forward."""
    model, _ = _port_gpt()
    step = pstep.GPTTrainStep(model, pstep.GPTTrainHP())
    batch = _torch_batch(_batch(8))
    with pytest.raises(ValueError, match="seed"):
        step(batch)
    with pytest.raises(ValueError, match="seed"):
        model(*_args(batch))


# ---- (f) DPO ----------------------------------------------------------------


def test_dpo_with_dropout_matches_jax(flax_masks):
    """``dpo_forward`` at dropout 0.1: the chosen and the rejected pass (one
    length, ``make_reject_y`` pads to it) drop the same elements at every
    site, as JAX's shared ``rngs``; the loss and CE loss within 1e-5 of the
    JAX ``dpo_forward`` given those masks, and the margin, a difference of
    two sequence log-probs of ~150 each, within 1e-5 of their magnitude
    (an fp32 step of each is 1.5e-5)."""
    model, params = _port_gpt()
    batch = _batch(11)
    rej, rej_lens = pdpo.make_reject_y(
        batch["semantic_ids"], batch["semantic_ids_len"],
        np.random.default_rng(3), max_len=Y_LEN)
    masks = []
    with recorded_masks(masks):
        got = pdpo.dpo_forward(model, _torch_batch(batch),
                               torch.from_numpy(rej).long(),
                               torch.from_numpy(rej_lens).long(), seed=55)
    half = 4 * S1_KW["n_layers"]
    assert len(masks) == 2 * half
    assert all(np.array_equal(a, c) for a, c in zip(masks[:half],
                                                    masks[half:]))
    flax_masks.extend(masks)
    want = jdpo.dpo_forward(jt2s.Text2SemanticDecoder(JCFG), params, batch,
                            jnp.asarray(rej), jnp.asarray(rej_lens),
                            dropout_rng=jax.random.PRNGKey(1))
    assert not flax_masks
    for k in ("loss", "ce_loss"):
        assert_close(float(got[k].detach()), float(want[k]), 1e-5, k)
    with torch.no_grad():
        out = model(*_args(_torch_batch(batch)), seed=55)
    scale = float(pdpo.sequence_logps(out["logits"], out["targets"]).abs()
                  .max())
    assert abs(float(got["dpo_margin"].detach())
               - float(want["dpo_margin"])) <= \
        1e-5 * scale


# ---- (g) rate 0, rate 1, eval mode and serving ------------------------------


def test_dropout_zero_draws_nothing(monkeypatch):
    """At dropout 0 a training forward and a train step create no generator
    and no Philox mask, and give bit for bit what they give with no seed:
    today's results."""
    batch = _torch_batch(_batch(12))
    results = []
    for seed in (None, 77):
        model, _ = _port_gpt(seed=24, dropout=0.0)
        step = pstep.GPTTrainStep(model, pstep.GPTTrainHP())
        with monkeypatch.context() as m:
            def refuse(*a, **k):
                raise AssertionError("a mask was drawn at dropout 0")
            m.setattr(torch, "Generator", refuse)
            m.setattr(att, "attention_keep_mask", refuse)
            out = model(*_args(batch), seed=seed)
            metrics = step(batch, seed=seed)
        results.append((out["loss"].detach(), metrics["loss"],
                        metrics["grad_norm"]))
    assert all(torch.equal(a, c) for a, c in zip(*results))


def test_dropout_one_gives_zeros_as_flax():
    """At dropout 1 every site gives zeros, as flax's rate-1 case: the loss
    equals the JAX one with ``deterministic=False`` (no mask drawn on
    either side), within 1e-5."""
    model, params = _port_gpt(dropout=1.0)
    batch = _batch(13)
    with torch.no_grad():
        got = model(*_args(_torch_batch(batch)), seed=5)
    cfg = jt2s.T2SConfig(**{**T2S_KW, **S1_KW, "dropout": 1.0})
    want = jt2s.Text2SemanticDecoder(cfg).apply(
        {"params": params}, *_args(batch), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)})
    assert_close(float(got["loss"]), float(want["loss"]), 1e-5, "loss")


def test_eval_and_serving_never_drop():
    """A model with dropout 0.1 in eval mode gives the forward of the same
    weights at dropout 0 bit for bit; its prefill and decode step, even in
    training mode, give the same logits and caches as at dropout 0."""
    drop, _ = _port_gpt(seed=25)
    plain, _ = _port_gpt(seed=25, dropout=0.0)
    batch = _torch_batch(_batch(14))
    with torch.no_grad():
        a = drop.eval()(*_args(batch), seed=9)
        c = plain.eval()(*_args(batch))
        assert torch.equal(a["loss"], c["loss"])
        x, xl = batch["phoneme_ids"], batch["phoneme_ids_len"]
        prompts = batch["semantic_ids"][:, :5]
        for model in (drop, plain):
            model.train()
        first = [m.prefill(x, xl, prompts, batch["bert_feature"], 40)
                 for m in (drop, plain)]
        for got, want in zip(first[0], first[1]):
            assert torch.equal(got, want)
        steps = [m.decode_step(torch.tensor([3, 4, 5]), 0, f[1], f[2],
                               X_LEN, xl, 5)
                 for m, f in zip((drop, plain), first)]
        assert torch.equal(steps[0], steps[1])


# ---- (h) GPTTrain -----------------------------------------------------------


def _train_losses(norm, project, name):
    trainer = ptrain.GPTTrain(ptrain.GPTTrainParams(
        batch_size=16, total_epochs=1, save_every_epoch=1,
        train_input_dir=norm, output_model_name=name, project_dir=project,
        device="cpu"))
    assert trainer.model_cfg.dropout == P
    losses = []
    resp = trainer.train(on_step=lambda s, m: losses.append(float(m["loss"])))
    assert resp.ok, resp.message
    return losses


def test_gpt_train_with_dropout_on_cpu(workspace):
    """``GPTTrain`` on the CPU with a gpt.yaml carrying ``dropout: 0.1``
    (the tests' tiny config in a temporary configs dir): finite losses; a
    second run with the same ``train.seed`` gives the same losses, bit for
    bit, and another seed other ones (each micro-batch's masks come from
    seed * 1_000_003 + its count)."""
    norm, project = workspace
    path = os.path.join(os.environ["EASEVOICE_BASE_PATH"], "configs",
                        "gpt.yaml")
    cfg = {**TINY_GPT, "model": {**TINY_GPT["model"], "dropout": P}}
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    first = _train_losses(norm, project, "a")
    assert first and np.isfinite(first).all()
    assert _train_losses(norm, project, "b") == first
    cfg["train"] = {**cfg["train"], "seed": 4321}
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    assert _train_losses(norm, project, "c") != first


# ---- (i) the uniforms of nn.layers.dropout ----------------------------------


def test_dropout_draws_bf16_at_the_rate():
    """``nn.layers.dropout`` on a bf16 tensor of 4.2e6 elements at p = 0.1
    drops within 6 sigma of p (sigma 1.5e-4): its uniforms are fp32, as
    flax's ``bernoulli(rng, 1 - p)`` draws from a Python float.  Uniforms
    drawn in bf16 take ~2^8 values below 1: they dropped 0.10168 of these
    elements (11.5 sigma off).  The kept ones are scaled by 1 / bf16(0.9)."""
    n, gen = 4_200_000, torch.Generator().manual_seed(2024)
    y = layers.dropout(torch.ones(n, dtype=BF), P, True, gen)
    assert y.dtype == BF
    rate = float((y == 0).float().mean())
    assert abs(rate - P) <= 6 * (P * (1 - P) / n) ** 0.5, rate
    kept = y[y != 0]
    assert torch.equal(kept, torch.full_like(
        kept, 1.0 / layers.weak_scalar(1.0 - P, BF)))


def test_dropout_masks_are_the_fp32_draw_in_every_dtype():
    """An fp32 input's mask is the one the fine-tunes drew before the bf16
    repair, ``torch.rand(shape) >= p`` from the generator, bit for bit;
    a bf16 input of the same shape and seed gets the same mask."""
    shape = (3, 64, 50)
    want = torch.rand(shape, generator=torch.Generator().manual_seed(9)) >= P
    for dtype in (torch.float32, BF):
        y = layers.dropout(torch.ones(shape, dtype=dtype), P, True,
                           torch.Generator().manual_seed(9))
        assert torch.equal(y != 0, want), dtype
