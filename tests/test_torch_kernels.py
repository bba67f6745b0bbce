"""The port's kernels (K1-K3, K4's two entry points and K5, the gradient of
K1; K1's head-width-64 instance as the encoders' attention) against their
plain twins; the denoiser and the SSL stage of dataset preparation on the card
against the CPU.

This file imports no JAX, so the ``cuda`` tests run on a machine with the
card and without JAX:

    python3 -m pytest tests/test_torch_kernels.py --noconftest -q

(``tests/conftest.py`` imports jax).  Without a card the ``cuda`` tests skip
and the CPU tests check the twins, the dispatch rule and the planner of K4's
weight gradient.  Kernel tolerances: 1e-4 absolute on outputs of magnitude
~1, for fp32 sums taken in another order than the twin's; K4's weight
gradient, a sum over B*T products split per shape into ranges whose partial
sums are added in a fixed order, 1e-3 relative to its largest magnitude.
K5 sums up to T products of magnitude ~1 per output in fp32, in another
order than the twin's: 1e-4 relative to the largest magnitude of each
gradient.
"""
import numpy as np
import pytest
import torch

from easevoice_trainer_tpu_torch.ops import attention as att
from easevoice_trainer_tpu_torch.ops import decode_attention, \
    encoder_attention, mrf_conv, mrf_conv_bwd_data, mrf_conv_bwd_weight, \
    prefill_attention, prefill_attention_bwd, self_attention
from easevoice_trainer_tpu_torch.ops import mrf
from easevoice_trainer_tpu_torch.ops.mrf import mrf_conv_reference


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def test_decode_attention_twin_skips_text_pads():
    """A value planted in a text-pad slot (x_lens[b] <= s < x_len) and one
    beyond the write position must not reach the output."""
    rng = np.random.default_rng(11)
    b, h, dk, cache_len, x_len, prompt_len = 2, 2, 8, 24, 8, 4
    x_lens = torch.tensor([8, 3])

    def randn(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))

    q, k, v = randn(b, 1, h, dk), randn(b, 1, h, dk), randn(b, 1, h, dk)
    kc, vc = randn(b, cache_len, h, dk), randn(b, cache_len, h, dk)
    base = decode_attention(q, k, v, kc, vc, x_len, x_lens, prompt_len, 2)
    vc2 = vc.clone()
    vc2[1, 5] = 1e6    # text pad of row 1
    vc2[:, x_len + prompt_len + 3] = 1e6  # not yet generated
    got = decode_attention(q, k, v, kc.clone(), vc2, x_len, x_lens,
                           prompt_len, 2)
    torch.testing.assert_close(got, base, rtol=0, atol=0)


def test_encoder_attention_twin_is_bert_key_padding():
    """On the CPU encoder_attention is K1's twin with x_len = T and no
    audio: each row, pads included, sees the keys below valid_lens[b]; the
    JAX BERT's math (q scaled first, a -inf bias on the pad keys,
    models/bert.py:49-56, :88-91)."""
    rng = np.random.default_rng(12)
    b, t, h, dk = 3, 37, 2, 64
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (b, t, h, dk))
                                .astype(np.float32)) for _ in range(3))
    valid = torch.tensor([37, 20, 1], dtype=torch.int32)
    n0 = encoder_attention.launches
    got = encoder_attention(q, k, v, valid)
    bias = torch.where(torch.arange(t)[None] < valid[:, None], 0.0,
                       -torch.inf)[:, None, None, :]
    scores = torch.einsum("bqhd,bkhd->bhqk", q / dk ** 0.5, k) + bias
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert encoder_attention.launches == n0   # the twin launches nothing


def test_encoder_attention_twin_at_dk_32_is_ct_punc_word_mask():
    """At dk 32 (CT-punc's 256/8) the CPU route is the same twin: the JAX
    CT-Transformer's masking of the pad words with ``finfo.min``
    (audiokit/punc_ct.py:109-113) gives what -inf gives, since every row
    sees at least one word; no launch is counted."""
    rng = np.random.default_rng(13)
    b, t, h, dk = 2, 32, 8, 32
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (b, t, h, dk))
                                .astype(np.float32)) for _ in range(3))
    valid = torch.tensor([20, 1], dtype=torch.int32)
    n0 = encoder_attention.launches, encoder_attention.launches_dk32
    got = encoder_attention(q, k, v, valid)
    scores = torch.einsum("bqhd,bkhd->bhqk", q / dk ** 0.5, k)
    keep = (torch.arange(t)[None] < valid[:, None])[:, None, None, :]
    scores = torch.where(keep, scores, torch.finfo(torch.float32).min)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert (encoder_attention.launches,
            encoder_attention.launches_dk32) == n0


def test_mrf_conv_twin_matches_lrelu_conv_residual():
    rng = np.random.default_rng(1)

    def arr(*shape, std=1.0):
        return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32))

    x, w, b, r = arr(2, 8, 50), arr(8, 8, 7, std=0.2), arr(8, std=0.1), \
        arr(2, 8, 50)
    xa = np.where(x.numpy() >= 0, x.numpy(), 0.1 * x.numpy())
    xp = np.pad(xa, ((0, 0), (0, 0), (9, 9)))
    want = np.zeros((2, 8, 50), np.float64)
    for j in range(7):
        want += np.einsum("oi,bit->bot", w.numpy()[:, :, j],
                          xp[:, :, j * 3:j * 3 + 50])
    want += b.numpy()[None, :, None] + r.numpy()
    before = mrf_conv.launches
    got = mrf_conv(x, w, b, 3, residual=r)
    assert mrf_conv.launches == before  # the CPU runs the twin, no kernel
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_kernel_wrappers_refuse_other_devices():
    """Neither a kernel nor a twin runs on a device that is not the CPU or
    CUDA: the wrappers raise instead of falling back."""
    def z(*shape):
        return torch.zeros(shape, device="meta")

    with pytest.raises(ValueError):
        mrf_conv(z(1, 4, 8), z(4, 4, 3), z(4), 1)
    with pytest.raises(ValueError):
        mrf_conv_bwd_data(z(1, 4, 8), z(1, 4, 8), z(4, 4, 3), 1)
    with pytest.raises(ValueError):
        mrf_conv_bwd_weight(z(1, 4, 8), z(1, 4, 8), (4, 4, 3), 1)
    lens = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        prefill_attention(z(1, 8, 2, 32), z(1, 8, 2, 32), z(1, 8, 2, 32), 4,
                          lens, lens)
    with pytest.raises(ValueError):
        decode_attention(z(1, 1, 2, 32), z(1, 1, 2, 32), z(1, 1, 2, 32),
                         z(1, 16, 2, 32), z(1, 16, 2, 32), 4, lens, 4, 0)
    with pytest.raises(ValueError):
        prefill_attention_bwd(z(1, 8, 2, 32), z(1, 8, 2, 32), z(1, 8, 2, 32),
                              z(1, 8, 2, 32), z(1, 2, 8), z(1, 8, 2, 32), 4,
                              lens, lens)
    with pytest.raises(ValueError):
        self_attention(z(1, 8, 192), 2, 4, lens, lens)
    with pytest.raises(ValueError):
        encoder_attention(z(1, 8, 2, 64), z(1, 8, 2, 64), z(1, 8, 2, 64),
                          lens)


@pytest.mark.cuda
@pytest.mark.parametrize("x_len,x_lens,prompt,y_lens", [
    (64, [64, 41, 17, 58], 250, None),   # the serving shape
    (16, [16, 1, 9, 12], 37, None),      # ragged tiles, a one-phoneme row
    (13, [13, 1, 7, 12], 1, None),       # prompt 1; x_len off every tile
    (40, [1, 40, 33, 5], 95, [95, 60, 1, 33]),  # audio pads, T % 32 != 0
    # text tiles cut short, and a row with no text: its text rows see no
    # key at all
    (70, [0, 70, 65, 3], 200, [200, 17, 190, 96]),
])
def test_prefill_attention_kernel_matches_twin(x_len, x_lens, prompt, y_lens):
    """K1 at the serving shape and at its tile edges: T, x_len and the valid
    lengths off the 32-row query and 32-key tiles, one-phoneme rows, a
    one-token prompt and padded audio rows; q/k/v are views of one fused
    projection.  Two identical calls give bit-identical outputs."""
    gen = _card()
    b, h, dk, t = len(x_lens), 16, 32, x_len + prompt
    lens = torch.tensor(x_lens, dtype=torch.int32, device="cuda")
    qkv = torch.randn((b, t, 3 * h * dk), generator=gen, device="cuda")
    q, k, v = (z.view(b, t, h, dk) for z in qkv.split(h * dk, dim=-1))
    y_lens = torch.tensor(y_lens or [prompt] * b, dtype=torch.int32,
                          device="cuda")
    before = prefill_attention.launches
    got = prefill_attention(q, k, v, x_len, lens, y_lens)
    assert prefill_attention.launches == before + 1
    want = att.prefill_attention_reference(q, k, v, x_len, lens, y_lens)
    # rows with no visible key are 0 in the kernel and NaN in the twin
    want = torch.nan_to_num(want, nan=0.0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert torch.equal(got, prefill_attention(q, k, v, x_len, lens, y_lens))


def _s1_lens(b, x_len, y_len, seed):
    """Ragged (x_lens, y_lens) of one s1 batch: one row at each full
    length, the others drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    x_lens = rng.integers(1, x_len + 1, b)
    y_lens = rng.integers(1, y_len + 1, b)
    x_lens[0], y_lens[-1] = x_len, y_len
    return x_lens.tolist(), y_lens.tolist()


# (x_len, x_lens, y_len, y_lens): K1's tile-edge cases with K5's, and the s1
# buckets of chip_smoke (B = 8, 416 phonemes, 300 and 1360 tokens)
K5_CASES = [
    (416, _s1_lens(8, 416, y_len, seed)[0], y_len,
     _s1_lens(8, 416, y_len, seed)[1]) for y_len, seed in ((300, 1),
                                                          (1360, 2))
] + [
    (13, [13, 1, 7, 12], 1, [1, 1, 1, 1]),   # one-token prompt, one phoneme
    (40, [1, 40, 33, 5], 95, [95, 60, 1, 33]),  # audio pads, T % 64 != 0
    (70, [0, 70, 65, 3], 200, [200, 17, 190, 96]),  # a row with no text
    (64, [64, 64], 64, [64, 63]),            # every length on a tile edge
    (0, [0, 0], 45, [45, 20]),               # no text at all
    # off K5's 16-row / 16-key warp fragments and its 8-query k-steps
    (15, [15, 1, 14], 17, [17, 8, 9]),
    (16, [16, 7, 16], 15, [15, 1, 7]),
    (17, [17, 16, 9], 40, [40, 17, 15]),
    (5, [5, 2], 9, [9, 1]),                  # T = 14 < 16
    # every audio row a pad past y_lens (y_lens 0), and one batch row
    # whose every row is a pad and sees no key
    (8, [0, 8, 3], 24, [0, 0, 24]),
]


def test_prefill_attention_bwd_runs_the_twin_on_the_cpu():
    """On CPU tensors K5's wrapper runs its plain twin (no launch counted)
    and writes into the (dq, dk, dv) views it is given, the three slices of
    one fused-projection gradient; K1's lse twin is -inf exactly for a row
    that sees no key."""
    rng = np.random.default_rng(12)
    b, h, dk, x_len, y_len = 2, 2, 32, 5, 7
    t = x_len + y_len
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * h * dk)).astype(
        np.float32))
    q, k, v = att._split_heads(qkv, h)
    xl, yl = torch.tensor([5, 0]), torch.tensor([7, 3])
    o, lse = att.prefill_attention_lse(q, k, v, x_len, xl, yl)
    assert torch.isinf(lse[1, :, :x_len]).all()
    assert torch.isfinite(lse[0]).all()
    assert torch.isfinite(lse[1, :, x_len:]).all()
    do = torch.from_numpy(rng.normal(size=(b, t, h, dk)).astype(np.float32))
    dqkv = torch.full_like(qkv, float("nan"))
    before = prefill_attention_bwd.launches
    got = prefill_attention_bwd(q, k, v, o, lse, do, x_len, xl, yl,
                                out=att._split_heads(dqkv, h))
    assert prefill_attention_bwd.launches == before
    want = att.prefill_attention_bwd_reference(q, k, v, o, lse, do, x_len, xl,
                                               yl)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert torch.isfinite(dqkv).all()
    assert not dqkv.view(b, t, 3, h, dk)[1, :x_len, 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("x_len,x_lens,y_len,y_lens", K5_CASES)
def test_prefill_attention_lse_matches_twin(x_len, x_lens, y_len, y_lens):
    """K1's row logsumexp against torch.logsumexp of the twin's masked
    scores (-inf exactly where a row sees no key), and K1's output
    bit-identical with and without the lse pointer."""
    gen = _card()
    b, h, dk, t = len(x_lens), 16, 32, x_len + y_len
    xl = torch.tensor(x_lens, dtype=torch.int32, device="cuda")
    yl = torch.tensor(y_lens, dtype=torch.int32, device="cuda")
    qkv = torch.randn((b, t, 3 * h * dk), generator=gen, device="cuda")
    q, k, v = att._split_heads(qkv, h)
    o, lse = att.prefill_attention_lse(q, k, v, x_len, xl, yl)
    assert torch.equal(o, prefill_attention(q, k, v, x_len, xl, yl))
    want = att.prefill_attention_lse_reference(q, k, x_len, xl, yl)
    hidden = torch.isinf(want)
    assert torch.equal(torch.isinf(lse), hidden)
    assert (lse[hidden] < 0).all()
    torch.testing.assert_close(lse[~hidden], want[~hidden], rtol=0,
                               atol=1e-4)


def _k5_inputs(gen, x_len, x_lens, y_len, y_lens, h=16, dk=32):
    """K1's inputs and outputs and a gradient of o that is non-zero on
    every row, pad rows included."""
    b, t = len(x_lens), x_len + y_len
    xl = torch.tensor(x_lens, dtype=torch.int32, device="cuda")
    yl = torch.tensor(y_lens, dtype=torch.int32, device="cuda")
    qkv = torch.randn((b, t, 3 * h * dk), generator=gen, device="cuda")
    q, k, v = att._split_heads(qkv, h)
    o, lse = att.prefill_attention_lse(q, k, v, x_len, xl, yl)
    do = torch.randn((b, t, h, dk), generator=gen, device="cuda")
    return q, k, v, o, lse, do, xl, yl


@pytest.mark.cuda
@pytest.mark.parametrize("x_len,x_lens,y_len,y_lens", K5_CASES)
def test_prefill_attention_bwd_kernel_matches_twin(x_len, x_lens, y_len,
                                                   y_lens):
    """K5 against its plain twin on K1's own o and lse, at the s1 shapes and
    K1's tile edges: T, x_len and the valid lengths off the 64-row and
    64-key tiles and off K5's 16-row warp fragments and 8-query k-steps,
    T < 16, one-phoneme rows, rows with no visible key (finite zero
    gradients), pad query rows with a non-zero dO, a batch row that is all
    pads.  Two launches give bit-identical gradients."""
    gen = _card()
    q, k, v, o, lse, do, xl, yl = _k5_inputs(gen, x_len, x_lens, y_len,
                                             y_lens)
    before = prefill_attention_bwd.launches
    got = prefill_attention_bwd(q, k, v, o, lse, do, x_len, xl, yl)
    assert prefill_attention_bwd.launches == \
        before + prefill_attention_bwd.launches_per_call
    want = att.prefill_attention_bwd_reference(q, k, v, o, lse, do, x_len,
                                               xl, yl)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        _close_rel(g, w, 1e-4)
    again = prefill_attention_bwd(q, k, v, o, lse, do, x_len, xl, yl)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if 0 in x_lens:  # text rows of that batch row see nothing
        row = x_lens.index(0)
        assert not got[0][row, :x_len].any()
    for row, (xl_b, yl_b) in enumerate(zip(x_lens, y_lens)):
        if xl_b == 0 and yl_b == 0:  # no row of it sees a key: all zero
            assert not any(g[row].any() for g in got)


@pytest.mark.cuda
def test_prefill_attention_bwd_refuses_misaligned_rows():
    """K5 reads o and dO 16 bytes at a time: a contiguous dO that does not
    start on a 16-byte boundary is refused before any launch."""
    gen = _card()
    q, k, v, o, lse, do, xl, yl = _k5_inputs(gen, 8, [8, 3], 9, [9, 4], h=2)
    shifted = torch.zeros(do.numel() + 1, device="cuda")[1:].view(do.shape)
    shifted.copy_(do)
    before = prefill_attention_bwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        prefill_attention_bwd(q, k, v, o, lse, shifted, 8, xl, yl)
    assert prefill_attention_bwd.launches == before


@pytest.mark.cuda
def test_self_attention_autograd_on_the_card():
    """The training attention through its autograd Function: K1 forward, K5
    backward into one d(qkv); o and the gradient match autograd of the
    dense twin (rows that see a key), one K1 launch and one K5 call (its
    three launches) per call."""
    gen = _card()
    b, h, dk, x_len, y_len = 3, 16, 32, 37, 90
    xl = torch.tensor([37, 20, 5], dtype=torch.int32, device="cuda")
    yl = torch.tensor([90, 71, 2], dtype=torch.int32, device="cuda")
    qkv = torch.randn((b, x_len + y_len, 3 * h * dk), generator=gen,
                      device="cuda")
    do = torch.randn((b, x_len + y_len, h, dk), generator=gen, device="cuda")
    outs, grads = [], []
    for card in (True, False):
        x = qkv.clone().requires_grad_()
        before = (prefill_attention.launches, prefill_attention_bwd.launches)
        if card:
            o = self_attention(x, h, x_len, xl, yl)
        else:
            o = att.prefill_attention_reference(*att._split_heads(x, h),
                                                x_len, xl, yl)
        assert o.grad_fn is not None
        o.backward(do)
        if card:
            assert (prefill_attention.launches,
                    prefill_attention_bwd.launches) == (
                before[0] + 1,
                before[1] + prefill_attention_bwd.launches_per_call)
        outs.append(o.detach())
        grads.append(x.grad)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-4)
    _close_rel(grads[0], grads[1], 1e-4)


def _decode_inputs(gen, b, h, cache_len, device):
    """A cache and the new token's q/k/v as views of one fused projection,
    as ``TransformerLayer.qkv`` gives them."""
    dk = 32
    kc = torch.randn((b, cache_len, h, dk), generator=gen, device=device)
    vc = torch.randn((b, cache_len, h, dk), generator=gen, device=device)
    qkv = torch.randn((b, 1, 3 * h * dk), generator=gen, device=device)
    q, k, v = (z.view(b, 1, h, dk) for z in qkv.split(h * dk, dim=-1))
    return q, k, v, kc, vc


def _decode_against_twin(q, k, v, kc, vc, x_len, lens, prompt, step):
    """K2 against its twin on copies of one cache: outputs within 1e-4, the
    caches left bit-equal, and a second launch repeating the first bit for
    bit."""
    kc2, vc2 = kc.clone(), vc.clone()
    before = decode_attention.launches
    got = decode_attention(q, k, v, kc, vc, x_len, lens, prompt, step)
    assert decode_attention.launches == before + 1
    pos = x_len + prompt + step
    kc2[:, pos] = k[:, 0]
    vc2[:, pos] = v[:, 0]
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    want = att.decode_attention_reference(q, kc2, vc2, x_len, lens, prompt,
                                          step)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    again = decode_attention(q, k, v, kc, vc, x_len, lens, prompt, step)
    assert torch.equal(got, again)
    return got


# (B, H, T, valid lengths): the encoders' shapes (BERT at T 64 and 512,
# G2PW's BERT with ragged rows, HuBERT at the 5 s reference's 274 frames of
# which 264 are valid) and K1's tile edges (T and the lengths off the
# 32-row / 32-key tiles, one valid key, one row)
ENCODER_CASES = [
    (1, 16, 64, [64]), (1, 16, 512, [512]), (4, 12, 64, [64, 37, 2, 63]),
    (1, 12, 274, [264]), (2, 12, 33, [33, 1]), (3, 2, 100, [100, 31, 32]),
    (1, 4, 5, [3]), (2, 2, 1, [1, 1]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,lens", ENCODER_CASES)
def test_encoder_attention_kernel_matches_twin(b, h, t, lens):
    """K1 at dk 64 against its twin (views of one fused projection, as the
    encoders' q/k/v can be), a second launch bit-identical, and each valid
    row equal, bit for bit, to a run of that batch row alone, unpadded."""
    gen = _card()
    qkv = torch.randn((b, t, 3 * h * 64), generator=gen, device="cuda")
    q, k, v = (z.view(b, t, h, 64) for z in qkv.split(h * 64, dim=-1))
    valid = torch.tensor(lens, dtype=torch.int32, device="cuda")
    n0 = encoder_attention.launches
    got = encoder_attention(q, k, v, valid)
    want = att.prefill_attention_reference(q, k, v, t, valid,
                                           torch.zeros_like(valid))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(encoder_attention(q, k, v, valid), got,
                               rtol=0, atol=0)
    assert encoder_attention.launches == n0 + 2
    for i, n in enumerate(lens):
        alone = encoder_attention(
            *(z[i:i + 1, :n].contiguous() for z in (q, k, v)),
            valid[i:i + 1])
        torch.testing.assert_close(alone[0], got[i, :n], rtol=0, atol=0)


@pytest.mark.cuda
def test_encoder_attention_refuses_other_head_widths():
    """K1's encoder route has instances for dk 32 and 64 only: Paraformer's
    dk 128 raises."""
    _card()
    z = torch.zeros((1, 8, 2, 128), device="cuda")
    valid = torch.full((1,), 8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="dk=128"):
        encoder_attention(z, z, z, valid)


# (dk, B, H, T, valid lengths): CT-punc at dk 32 (H=8, the JAX bucket of a
# 20-word chunk, of one with a carried tail, of the 200-word cache limit
# plus a chunk) and K1's tile edges at dk 32; Whisper's encoder at dk 64
# (H=12, T=1500, every frame valid)
ASR_CASES = [
    (32, 1, 8, 32, [20]), (32, 1, 8, 64, [37]), (32, 1, 8, 256, [220]),
    (32, 2, 3, 33, [33, 1]), (32, 1, 2, 5, [3]), (64, 1, 12, 1500, [1500]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dk,b,h,t,lens", ASR_CASES)
def test_encoder_attention_kernel_matches_twin_on_the_asr_shapes(dk, b, h, t,
                                                                 lens):
    """K1's encoder route at the ASR chain's shapes against its twin, each
    launch counted for its instance, a second launch bit-identical, and
    each valid row equal to a run of that batch row alone, unpadded."""
    gen = _card()
    qkv = torch.randn((b, t, 3 * h * dk), generator=gen, device="cuda")
    q, k, v = (z.view(b, t, h, dk) for z in qkv.split(h * dk, dim=-1))
    valid = torch.tensor(lens, dtype=torch.int32, device="cuda")
    n64, n32 = encoder_attention.launches, encoder_attention.launches_dk32
    got = encoder_attention(q, k, v, valid)
    want = att.prefill_attention_reference(q, k, v, t, valid,
                                           torch.zeros_like(valid))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(encoder_attention(q, k, v, valid), got,
                               rtol=0, atol=0)
    assert (encoder_attention.launches - n64,
            encoder_attention.launches_dk32 - n32) == \
        ((0, 2) if dk == 32 else (2, 0))
    for i, n in enumerate(lens):
        alone = encoder_attention(
            *(z[i:i + 1, :n].contiguous() for z in (q, k, v)),
            valid[i:i + 1])
        torch.testing.assert_close(alone[0], got[i, :n], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [0, 1, 500, 1119])
def test_decode_attention_kernel_matches_twin(step):
    """K2 at the serving shape (a 1434-slot cache, split over 8 blocks) at
    the first, second, a middle and the last slot, with a one-phoneme row."""
    gen = _card()
    b, h, x_len, prompt = 4, 16, 64, 250
    lens = torch.tensor([64, 41, 1, 58], dtype=torch.int32, device="cuda")
    q, k, v, kc, vc = _decode_inputs(gen, b, h, x_len + prompt + 1120,
                                     "cuda")
    _decode_against_twin(q, k, v, kc, vc, x_len, lens, prompt, step)


@pytest.mark.cuda
@pytest.mark.parametrize("cache_len", [56, 1434])
def test_decode_attention_kernel_fewer_slots_than_split(cache_len):
    """Fewer valid slots than blocks per (b, h), with rows that have no
    text and only the new token to attend to; a cache short enough for one
    block (56 slots) too."""
    gen = _card()
    b, h, x_len, prompt = 4, 16, 4, 1
    lens = torch.tensor([0, 4, 1, 2], dtype=torch.int32, device="cuda")
    q, k, v, kc, vc = _decode_inputs(gen, b, h, cache_len, "cuda")
    for step in (0, 2):
        _decode_against_twin(q, k, v, kc, vc, x_len, lens, prompt, step)


@pytest.mark.cuda
def test_decode_attention_kernel_skips_text_pads():
    """A value planted in a text-pad slot (x_lens[b] <= s < x_len) and one
    beyond the write position do not reach the kernel's output."""
    gen = _card()
    b, h, x_len, prompt = 4, 16, 64, 250
    lens = torch.tensor([64, 41, 17, 58], dtype=torch.int32, device="cuda")
    q, k, v, kc, vc = _decode_inputs(gen, b, h, x_len + prompt + 1120,
                                     "cuda")
    base = _decode_against_twin(q, k, v, kc, vc, x_len, lens, prompt, 7)
    vc[1, 50] = 1e6                    # text pad of row 1
    kc[2, 20] = 1e6
    vc[:, x_len + prompt + 8] = 1e6    # not yet generated
    got = decode_attention(q, k, v, kc, vc, x_len, lens, prompt, 7)
    assert torch.equal(got, base)


def test_decode_attention_takes_views_and_checks_the_slot_first():
    """The wrapper takes q/k/v as strided views of the fused projection
    (same output and cache as contiguous copies), and a slot outside the
    cache raises before anything is written."""
    gen = torch.Generator().manual_seed(2)
    b, h, x_len, prompt = 2, 2, 8, 4
    lens = torch.tensor([8, 3])
    q, k, v, kc, vc = _decode_inputs(gen, b, h, 24, "cpu")
    assert not q.is_contiguous()
    kc2, vc2 = kc.clone(), vc.clone()
    got = decode_attention(q, k, v, kc, vc, x_len, lens, prompt, 5)
    want = decode_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            kc2, vc2, x_len, lens, prompt, 5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    before = (kc.clone(), vc.clone())
    with pytest.raises(ValueError, match="outside the cache"):
        decode_attention(q, k, v, kc, vc, x_len, lens, prompt, 24 - 12)
    assert torch.equal(kc, before[0]) and torch.equal(vc, before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("c,t_len", [(256, 5120), (64, 20000), (32, 777),
                                     (16, 40001), (24, 1000)])
@pytest.mark.parametrize("k", [3, 5, 7, 11])
def test_mrf_conv_kernel_matches_twin(c, t_len, k):
    """Every channel-tile shape, ragged time edges, a channel count that is
    not a multiple of the tile (24) and a tap count without its own
    instance (k=5, the generic loop)."""
    gen = _card()
    x = torch.randn((2, c, t_len), generator=gen, device="cuda")
    w = torch.randn((c, c, k), generator=gen, device="cuda") / (c * k) ** 0.5
    b = torch.randn((c,), generator=gen, device="cuda")
    r = torch.randn((2, c, t_len), generator=gen, device="cuda")
    for d in (1, 3, 5):
        for res in (None, r):
            got = mrf_conv(x, w, b, d, residual=res)
            want = mrf_conv_reference(x, w, b, d, residual=res)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_mrf_conv_is_differentiable_on_the_cpu():
    """The CPU path goes through the same autograd Function as the card's,
    runs the twins both ways and launches nothing."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 8, 40), generator=gen, requires_grad=True)
    w = (torch.randn((8, 8, 3), generator=gen) * 0.3).requires_grad_()
    b = torch.randn((8,), generator=gen, requires_grad=True)
    r = torch.randn((2, 8, 40), generator=gen, requires_grad=True)
    counts = (mrf_conv.launches, mrf_conv_bwd_data.launches,
              mrf_conv_bwd_weight.launches)
    y = mrf_conv(x, w, b, 3, residual=r)
    assert y.grad_fn is not None
    dy = torch.randn(y.shape, generator=gen)
    y.backward(dy)
    assert counts == (mrf_conv.launches, mrf_conv_bwd_data.launches,
                      mrf_conv_bwd_weight.launches)
    torch.testing.assert_close(r.grad, dy, rtol=0, atol=0)
    torch.testing.assert_close(b.grad, dy.sum(dim=(0, 2)))


def _close_rel(got, want, tol):
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("c,t_len", [(256, 320), (64, 1000), (32, 777),
                                     (16, 2048), (24, 1537)])
@pytest.mark.parametrize("k", [3, 5, 11])
def test_mrf_conv_bwd_kernels_match_twins(c, t_len, k):
    """K4 at every channel-tile shape, a ragged T (777, 1537), T not a
    multiple of the time tiles (1000, 777, 1537), a channel count that is not
    a multiple of the tile (24) and a tap count without its own instance
    (k=5):
    dx within 1e-4, dW and db within 1e-3 of the twin's largest magnitude,
    and dW repeated bit for bit by a second launch."""
    gen = _card()
    x = torch.randn((3, c, t_len), generator=gen, device="cuda")
    x[0, :, :7] = 0.0            # lrelu'(0) = 1 in the kernel and the twin
    w = torch.randn((c, c, k), generator=gen, device="cuda") / (c * k) ** 0.5
    dy = torch.randn((3, c, t_len), generator=gen, device="cuda")
    for d in (1, 3, 5):
        before = (mrf_conv_bwd_data.launches, mrf_conv_bwd_weight.launches)
        dx = mrf_conv_bwd_data(dy, x, w, d)
        dw, db = mrf_conv_bwd_weight(dy, x, w.shape, d)
        assert (mrf_conv_bwd_data.launches,
                mrf_conv_bwd_weight.launches) == (before[0] + 1,
                                                  before[1] + 1)
        _close_rel(dx, mrf.mrf_conv_bwd_data_reference(dy, x, w, d), 1e-4)
        ww, wb = mrf.mrf_conv_bwd_weight_reference(dy, x, w.shape, d)
        _close_rel(dw, ww, 1e-3)
        _close_rel(db, wb, 1e-3)
        dw2, db2 = mrf_conv_bwd_weight(dy, x, w.shape, d)
        assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,t_len,k,d", [
    (24, 24, 5, 11, 5),      # T below one tile; the halo passes both edges
    (16, 72, 1, 3, 1),       # a single sample
    (24, 40, 37, 3, 1),      # T % 4 != 0: 4-byte copies; Cin != Cout
    (72, 24, 301, 7, 3),     # Cin, Cout not multiples of the 8 / 16 tiles
    (40, 24, 260, 5, 5),     # generic tap count
    (64, 64, 4100, 11, 5),   # 16-byte copies, T not a multiple of the tile
    (32, 32, 1000, 11, 5),   # the 32 x 256 block
    (200, 128, 300, 7, 1),   # a 4-block channel split with uneven shares
])
def test_mrf_conv_mma_tile_edges(cin, cout, t_len, k, d):
    """The tensor-core loop under K3 and K4's dx at its edges: ragged and
    tiny T, channel counts off the tile, both copy widths, the generic tap
    count, the widest halo and small grids split along the input channels
    (72 -> 24 and 200 -> 128 channels); K3 with and without the residual, dx
    with exact zeros in x (lrelu'(0) = 1).  1e-4 x max(1, max|twin|)."""
    gen = _card()
    x = torch.randn((3, cin, t_len), generator=gen, device="cuda")
    x[1, :, : max(1, t_len // 3)] = 0.0
    w = torch.randn((cout, cin, k), generator=gen, device="cuda") \
        / (cin * k) ** 0.5
    b = torch.randn((cout,), generator=gen, device="cuda")
    r = torch.randn((3, cout, t_len), generator=gen, device="cuda")
    dy = torch.randn((3, cout, t_len), generator=gen, device="cuda")
    for res in (None, r):
        before = mrf_conv.launches
        got = mrf_conv(x, w, b, d, residual=res)
        assert mrf_conv.launches == before + 1
        _close_rel(got, mrf_conv_reference(x, w, b, d, residual=res), 1e-4)
    before = mrf_conv_bwd_data.launches
    dx = mrf_conv_bwd_data(dy, x, w, d)
    assert mrf_conv_bwd_data.launches == before + 1
    _close_rel(dx, mrf.mrf_conv_bwd_data_reference(dy, x, w, d), 1e-4)


@pytest.mark.cuda
def test_mrf_conv_autograd_on_the_card():
    """Forward on K3 and backward on K4 through the autograd Function: the
    output has a grad_fn and the gradients match autograd of the twin."""
    gen = _card()
    x = torch.randn((2, 64, 900), generator=gen, device="cuda")
    w = torch.randn((64, 64, 7), generator=gen, device="cuda") / 21.0
    b = torch.randn((64,), generator=gen, device="cuda")
    r = torch.randn((2, 64, 900), generator=gen, device="cuda")
    dy = torch.randn((2, 64, 900), generator=gen, device="cuda")
    grads = []
    for fn in (mrf_conv, mrf_conv_reference):
        ins = [t.clone().requires_grad_() for t in (x, w, b, r)]
        before = (mrf_conv.launches, mrf_conv_bwd_data.launches,
                  mrf_conv_bwd_weight.launches)
        y = fn(ins[0], ins[1], ins[2], 3, residual=ins[3])
        assert y.grad_fn is not None
        y.backward(dy)
        if fn is mrf_conv:
            assert (mrf_conv.launches, mrf_conv_bwd_data.launches,
                    mrf_conv_bwd_weight.launches) == tuple(
                        n + 1 for n in before)
        grads.append([t.grad for t in ins])
    for got, want in zip(*grads):
        _close_rel(got, want, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,b,t_len,k,d", [
    (24, 24, 3, 5, 11, 5),      # T below the halo: every tap passes an edge
    (16, 72, 3, 1, 3, 1),       # a single sample; three output-channel tiles
    (24, 40, 3, 37, 3, 1),      # T % 4 != 0: 4-byte copies; Cin != Cout
    (72, 24, 3, 301, 7, 3),     # mma.sync route, three input-channel tiles
    (40, 24, 3, 260, 5, 5),     # k = 5
    (32, 32, 1, 1, 15, 5),      # k = 15: 480 (tap, channel) rows; B = 1
    (64, 64, 1, 4100, 15, 5),   # wgmma N = 64, four tap groups; B = 1
    (200, 128, 2, 300, 7, 1),   # wgmma N = 128, input channels off the tile
    (72, 200, 2, 777, 3, 3),    # two N tiles, the second 72 of 128 wide
    (256, 256, 1, 1537, 15, 3),  # two N tiles, five tap groups of three
    (16, 16, 2, 40001, 3, 1),   # the long reduction: 33 clusters of 8
])
def test_mrf_conv_wgrad_tile_edges(cin, cout, b, t_len, k, d):
    """K4's weight gradient at the edges of both routes' tiles and splits:
    ragged and tiny T, channel counts off every tile, both copy widths, tap
    counts without their own instance, the widest halo, and exact zeros in
    x (lrelu(0) = 0).  dW and db within 1e-3 x max(1, max|twin|), one
    launch counted a call, and a second call repeating the first bit for
    bit."""
    gen = _card()
    x = torch.randn((b, cin, t_len), generator=gen, device="cuda")
    x[0, :, : max(1, t_len // 3)] = 0.0
    dy = torch.randn((b, cout, t_len), generator=gen, device="cuda")
    before = mrf_conv_bwd_weight.launches
    dw, db = mrf_conv_bwd_weight(dy, x, (cout, cin, k), d)
    assert mrf_conv_bwd_weight.launches == before + 1
    ww, wb = mrf.mrf_conv_bwd_weight_reference(dy, x, (cout, cin, k), d)
    _close_rel(dw, ww, 1e-3)
    _close_rel(db, wb, 1e-3)
    dw2, db2 = mrf_conv_bwd_weight(dy, x, (cout, cin, k), d)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


S2_STAGES = ((256, 320), (128, 2560), (64, 5120), (32, 10240), (16, 20480))


def _s2_plans(c, t_len):
    """The planner's plans for one Generator stage of the s2 step: B=8,
    k in {3, 7, 11}, d in {1, 3, 5}."""
    return [mrf.wgrad_plan(8, c, c, t_len, k, d) for k in (3, 7, 11)
            for d in (1, 3, 5)]


@pytest.mark.parametrize("c,t_len", S2_STAGES)
def test_wgrad_plan_covers_the_s2_shapes(c, t_len):
    """The planner of K4's weight gradient at the s2 step's 45 shapes, on
    the nominal H100 (132 SMs): every sample of every row summed by exactly
    one split; the grid fits the card at once (its grid-wide barrier needs
    every block resident) and fills at least 70 % of that wave, the rest
    lost to tile and cluster granularity; the cross-cluster scratch under
    16 MB a shape."""
    b = 8
    for plan in _s2_plans(c, t_len):
        assert plan.bn == min(max(c, 16), 128)
        per_row = -(-t_len // plan.ts)
        assert plan.time_tiles == b * per_row
        seen = np.zeros((b, t_len), np.int64)
        for s in range(plan.splits):
            first, end = plan.time_range(s)
            assert end > first
            for tile in range(first, end):
                t0 = tile % per_row * plan.ts
                seen[tile // per_row, t0:t0 + plan.ts] += 1
        assert (seen == 1).all()
        wave = mrf.WGRAD_SMS * (2 if plan.bn <= 32 else 1)
        assert plan.tiles * plan.clusters <= mrf.nominal_clusters(
            plan.bn, plan.cluster)
        assert 0.7 * wave <= plan.blocks <= wave
        assert plan.scratch_floats * 4 < 16 << 20
        assert plan.smem_bytes <= mrf.WGRAD_SMEM


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fill", [0.9, 1.0])
def test_wgrad_plans_launch_repeatedly(fill, dtype, monkeypatch):
    """Each of the 45 s2 shapes' plans of the ``dtype`` instance at the
    cluster threshold ``fill`` launched 50 times: every launch accepted (the
    planner sizes a cooperative grid to what the runtime accepts, not to the
    occupancy query) and every result equal to the twin's (fp32 within
    1e-3, bf16 as the bf16 tests hold it)."""
    gen = _card()
    monkeypatch.setattr(mrf, "WGRAD_FILL", fill)
    b = 8
    close = (lambda g, w: _close_rel(g, w, 1e-3)) \
        if dtype == torch.float32 else _close_bf16
    for c, t_len in S2_STAGES:
        x = torch.randn((b, c, t_len), generator=gen,
                        device="cuda").to(dtype)
        dy = torch.randn((b, c, t_len), generator=gen,
                         device="cuda").to(dtype)
        for k in (3, 7, 11):
            for d in (1, 3, 5):
                ww, wb = mrf.mrf_conv_bwd_weight_reference(dy, x, (c, c, k),
                                                           d)
                first = None
                for _ in range(50):
                    gw, gb = mrf_conv_bwd_weight(dy, x, (c, c, k), d)
                    if first is None:
                        close(gw, ww)
                        close(gb, wb)
                        first = (gw, gb)
                    else:
                        assert torch.equal(gw, first[0])
                        assert torch.equal(gb, first[1])
                torch.cuda.synchronize()


def test_wgrad_plan_scratch_over_the_s2_step():
    """The scratch of the 45 s2 shapes together stays under 160 MB, a fifth
    of the 0.85 GB that the 512-sample chunks it replaced wrote and read."""
    total = sum(plan.scratch_floats * 4 for c, t_len in S2_STAGES
                for plan in _s2_plans(c, t_len))
    assert total < 160e6, total


def test_wgrad_plan_refuses_what_the_kernel_does_not_take():
    """Even or too many taps, a dilation below 1, and a halo too wide for
    the shared memory of a block raise before anything is launched."""
    for k, d in ((4, 1), (17, 1), (3, 0), (15, 40)):
        with pytest.raises(ValueError):
            mrf.wgrad_plan(8, 128, 128, 2560, k, d)
    plan = mrf.wgrad_plan(8, 128, 128, 2560, 15, 5)
    assert plan.taps * -(-15 // plan.taps) >= 15


# ---- the bf16 instances (the fine-tunes under is_half) ----------------------
#
# Each is held against its bf16 twin.  Both round an fp32 result to bf16;
# the fp32 sums differ in order only, so they round alike except near a
# rounding boundary, where they differ by one bf16 step (2^-7 of the value
# at most) or, for K3's chain of three roundings, by a step of a larger
# intermediate.  Tolerance: every element within 2^-6 x max(1, max|twin|)
# (a wrong tap, key or index is off by order 1), and at most 2 % of the
# elements (``share``) off by more than one step of their own value.


def _close_bf16(got, want, share=0.02):
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    err = (g - w).abs()
    assert float(err.max()) <= 2.0 ** -6 * max(1.0, float(w.abs().max())), \
        float(err.max())
    off = float((err > 2.0 ** -7 * w.abs() + 1e-6).float().mean())
    assert off <= share, off


def _bf16_heads(qkv, h):
    return att._split_heads(qkv.to(torch.bfloat16), h)


# K1's bf16 kernel at the edges of its own tiles: 128-row query tiles of
# four 32-row warps and 64-key staged tiles (T, x_len and the valid lengths
# one off each), a one-row T, batch rows whose every row sees no key
K1_BF16_EDGES = [
    (64, [64, 63, 1], 63, [63, 62, 1]),      # T = 127
    (63, [63, 0, 17], 65, [65, 64, 0]),      # T = 128
    (65, [65, 64, 63], 64, [64, 1, 0]),      # T = 129
    (128, [0, 128], 1, [0, 1]),              # row 0 sees no key at all
    (0, [0, 0], 1, [1, 0]),                  # T = 1, audio
    (1, [1, 0], 0, [0, 0]),                  # T = 1, text
]


@pytest.mark.cuda
@pytest.mark.parametrize("x_len,x_lens,y_len,y_lens",
                         K5_CASES + K1_BF16_EDGES)
def test_prefill_attention_bf16_matches_twin(x_len, x_lens, y_len, y_lens):
    """K1's bf16 instance with its lse at the s1 shapes, K1 / K5's tile
    edges (x_len 15 / 16 / 17, T < 16, a batch row of pads, rows with no
    visible key) and its own (K1_BF16_EDGES): o against the bf16 twin (rows
    with no key are 0 in the kernel, NaN in the twin), lse within 1e-4
    (fp32) and -inf exactly where the twin's is; one bf16 launch counted,
    none fp32; two calls bit-identical."""
    gen = _card()
    b, h, dk, t = len(x_lens), 16, 32, x_len + y_len
    xl = torch.tensor(x_lens, dtype=torch.int32, device="cuda")
    yl = torch.tensor(y_lens, dtype=torch.int32, device="cuda")
    q, k, v = _bf16_heads(torch.randn((b, t, 3 * h * dk), generator=gen,
                                      device="cuda"), h)
    before = (prefill_attention.launches, prefill_attention.launches_bf16)
    o, lse = att.prefill_attention_lse(q, k, v, x_len, xl, yl)
    assert (prefill_attention.launches,
            prefill_attention.launches_bf16) == (before[0], before[1] + 1)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want = torch.nan_to_num(att.prefill_attention_reference(
        q, k, v, x_len, xl, yl), nan=0.0)
    _close_bf16(o, want)
    want_lse = att.prefill_attention_lse_reference(q, k, x_len, xl, yl)
    hidden = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), hidden)
    assert not o[hidden.transpose(1, 2)].any()
    torch.testing.assert_close(lse[~hidden], want_lse[~hidden], rtol=0,
                               atol=1e-4)
    o2, lse2 = att.prefill_attention_lse(q, k, v, x_len, xl, yl)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def _chip_smoke():
    """``chip_smoke.py`` loaded by path (it imports nothing at the top but
    the standard library)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_s1_window_kernel_patterns_class_k1_and_k5():
    """The s1 window's profile groups kernels by name (chip_smoke
    K1_KERNEL, K5_KERNEL, on the lower-cased demangled names a trace
    holds): K1's fp32 and bf16 kernels are K1, K5's dsum / dkdv / dq of
    either instance are K5, with or without dropout, and no name is both
    or falls to neither."""
    cs = _chip_smoke()
    k1 = ["(anonymous namespace)::prefill_attention_kernel<32>(float const*, "
          "float const*, float const*, float*, float*, long long, long long, "
          "long long, long long, long long, long long, int const*, int "
          "const*, int, int, int, float)",
          "(anonymous namespace)::prefill_attention_kernel<64>(float const*, "
          "float const*, float const*, float*, float*, long long, long long, "
          "long long, long long, long long, long long, int const*, int "
          "const*, int, int, int, float)",
          "(anonymous namespace)::prefill_attention_bf16_kernel(__nv_bfloat16 "
          "const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
          "__nv_bfloat16*, float*, long long, long long, long long, long "
          "long, long long, long long, int const*, int const*, int, int, "
          "int, float)"]
    # the instances with a DROP template flag (the dropout ones: true)
    k1 += ["(anonymous namespace)::prefill_attention_kernel<32, true>(float "
           "const*, int, float, ev::Dropout)",
           "(anonymous namespace)::prefill_attention_bf16_kernel<false>("
           "__nv_bfloat16 const*, int, float, ev::Dropout)"]
    k5 = [f"(anonymous namespace)::{k}{sfx}_kernel{flag}(float const*, int)"
          for k in ("dsum", "dkdv", "dq") for sfx in ("", "_bf16")
          for flag in ("", "<true>")]
    other = ["void decode_attention_kernel<8>(float const*)",
             "ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_tn",
             "void at::native::vectorized_elementwise_kernel<4>()"]
    for name in k1 + k5 + other:
        name = name.lower()
        got = (bool(cs.K1_KERNEL.search(name)),
               bool(cs.K5_KERNEL.search(name)))
        want = (name in map(str.lower, k1), name in map(str.lower, k5))
        assert got == want, (name, got)


def test_k1_variants_undo_one_choice_each():
    """``bench/k1_variants.py`` writes variants of the tree's K1 bf16
    source that each differ from it in one of the constants at its top."""
    import os

    from easevoice_trainer_tpu_torch.bench import k1_variants
    from easevoice_trainer_tpu_torch.ops import build

    with open(os.path.join(build.CSRC, "prefill_attention_bf16.cu")) as f:
        src = f.read()
    got = k1_variants.variants(src)
    names = {"terms3", "sync", "warps2", "mt1", "ring2", "in_order"}
    assert names < set(got) and len(got) == len(names) + 1
    assert set(got) - names <= {"bkt32", "bkt64"}
    for name, text in got.items():
        changed = [(a, b) for a, b in zip(src.splitlines(),
                                          text.splitlines()) if a != b]
        assert len(changed) == 1, name
        assert changed[0][0].startswith("constexpr "), name


def test_k1_variants_dropout_undo_one_choice_each():
    """``bench/k1_variants.py --dropout`` writes variants of the tree's K1
    bf16 source that each differ from it in one constant of the instance
    with dropout: ``DROP_MT`` the other of 1 and 2, ``DROP_MIN_BLOCKS`` one
    lower; its sources by dtype are the tree's K1 sources."""
    import os

    from easevoice_trainer_tpu_torch.bench import k1_variants
    from easevoice_trainer_tpu_torch.ops import build

    for source, kernel, entry in k1_variants.SOURCES.values():
        with open(os.path.join(build.CSRC, source)) as f:
            text = f.read()
        dropout = entry.replace("attention_", "attention_dropout_")
        for name in (kernel, f'"C" int {entry}', f'"C" int {dropout}'):
            assert f"{name}(" in text, (source, name)
    with open(os.path.join(build.CSRC, "prefill_attention_bf16.cu")) as f:
        src = f.read()
    got = k1_variants.variants_dropout(src)
    names = sorted(got)
    assert len(names) == 2 and names[0].startswith("drop_cap") and \
        names[1].startswith("drop_mt")
    for name, text in got.items():
        changed = [(a, b) for a, b in zip(src.splitlines(),
                                          text.splitlines()) if a != b]
        assert len(changed) == 1, name
        assert changed[0][0].startswith("constexpr int DROP_"), name


def test_k5_variants_bf16_undo_one_choice_each():
    """``bench/k5_variants.py`` writes variants of the tree's K5 bf16
    source, each undoing one choice: a constant at its top, or the
    blocks-an-SM cap of both walks (``no_cap``)."""
    import os
    import re

    from easevoice_trainer_tpu_torch.bench import k5_variants
    from easevoice_trainer_tpu_torch.ops import build

    with open(os.path.join(build.CSRC, "prefill_attention_bwd_bf16.cu")) as f:
        src = f.read()
    got = k5_variants.variants_bf16(src)
    assert {"terms3", "sync", "q8", "no_cap"} < set(got)
    assert any(re.fullmatch(r"cap\d", n) for n in got) and len(got) == 5
    for name, text in got.items():
        changed = [(a, b) for a, b in zip(src.splitlines(),
                                          text.splitlines()) if a != b]
        assert len(changed) == (2 if name == "no_cap" else 1), name


def test_k5_variants_fp32_undo_one_choice_each():
    """``bench/k5_variants.py`` writes variants of the tree's K5 fp32
    source, each undoing one choice: with ``--dropout`` the dropout
    instances' blocks-an-SM cap one lower (``drop_cap2``, the cap they had
    while they drew the mask) or no cap on either walk (``no_cap``);
    without, the four choices of the instances without dropout."""
    import os

    from easevoice_trainer_tpu_torch.bench import k5_variants
    from easevoice_trainer_tpu_torch.ops import build

    with open(os.path.join(build.CSRC, "prefill_attention_bwd.cu")) as f:
        src = f.read()
    got = k5_variants.variants_dropout(src)
    assert sorted(got) == ["drop_cap2", "no_cap"]
    assert set(k5_variants.variants(src)) == {"q8", "exp2f", "no_cap", "cvt"}
    for name, text in got.items():
        changed = [(a, b) for a, b in zip(src.splitlines(),
                                          text.splitlines()) if a != b]
        assert len(changed) == (2 if name == "no_cap" else 1), name
        if name == "drop_cap2":
            assert changed[0][1].startswith(
                "constexpr int DROP_MIN_BLOCKS = 2;"), changed


# K5's bf16 kernels at the edges of their own tiles: 16-row MMA fragments,
# 64-key dkdv blocks, 64-row query tiles and 32-key dq tiles (x_len and T
# one off each), T < 16 with a batch row that is all pads, text rows that
# see no key (lse = -inf), an audio bucket with y_lens 0
K5_BF16_EDGES = [
    (63, [63, 31, 33], 66, [66, 1, 65]),     # T = 129
    (64, [64, 48, 16], 65, [65, 64, 0]),     # T = 129, y_lens 0
    (65, [65, 33, 32], 127, [127, 16, 17]),  # T = 192
    (1, [1, 0], 14, [14, 0]),                # T = 15, row 1 all pads
    (31, [0, 31], 33, [33, 32]),             # row 0's text sees nothing
    (33, [32, 1], 95, [64, 95]),
]


def _k5_bf16(gen, x_len, x_lens, y_len, y_lens, h=16, dk=32):
    """K1's bf16 inputs, its bf16 o and fp32 lse, and a bf16 gradient of o
    on every row."""
    b, t = len(x_lens), x_len + y_len
    xl = torch.tensor(x_lens, dtype=torch.int32, device="cuda")
    yl = torch.tensor(y_lens, dtype=torch.int32, device="cuda")
    q, k, v = _bf16_heads(torch.randn((b, t, 3 * h * dk), generator=gen,
                                      device="cuda"), h)
    o, lse = att.prefill_attention_lse(q, k, v, x_len, xl, yl)
    do = torch.randn((b, t, h, dk), generator=gen,
                     device="cuda").to(torch.bfloat16)
    return q, k, v, o, lse, do, xl, yl


@pytest.mark.cuda
@pytest.mark.parametrize("x_len,x_lens,y_len,y_lens",
                         K5_CASES + K5_BF16_EDGES)
def test_prefill_attention_bwd_bf16_matches_twin(x_len, x_lens, y_len,
                                                 y_lens):
    """K5's bf16 instance on K1's bf16 o and lse, at the same cases and at
    the edges of its own tiles: dq, dk, dv against the bf16 twin, finite,
    zero for every query row whose lse is -inf (it sees no key) and for
    every key no row sees, three bf16 launches counted and no fp32 one,
    repeated launches bit-identical."""
    gen = _card()
    q, k, v, o, lse, do, xl, yl = _k5_bf16(gen, x_len, x_lens, y_len,
                                           y_lens)
    before = (prefill_attention_bwd.launches,
              prefill_attention_bwd.launches_bf16)
    got = prefill_attention_bwd(q, k, v, o, lse, do, x_len, xl, yl)
    assert (prefill_attention_bwd.launches,
            prefill_attention_bwd.launches_bf16) == (
        before[0], before[1] + prefill_attention_bwd.launches_per_call)
    want = att.prefill_attention_bwd_reference(q, k, v, o, lse, do, x_len,
                                               xl, yl)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g.float()).all(), name
        _close_bf16(g, w)
    for _ in range(2):
        again = prefill_attention_bwd(q, k, v, o, lse, do, x_len, xl, yl)
        assert all(torch.equal(a, c) for a, c in zip(got, again))
    blind = torch.isinf(lse).permute(0, 2, 1)   # (B, T, H): sees no key
    assert not got[0][blind].any()
    for row, (xl_b, yl_b) in enumerate(zip(x_lens, y_lens)):
        unseen = list(range(xl_b, x_len)) + list(range(x_len + yl_b,
                                                       x_len + y_len))
        assert not got[1][row, unseen].any() and \
            not got[2][row, unseen].any()
        if xl_b == 0 and yl_b == 0:
            assert not any(g[row].any() for g in got)


@pytest.mark.cuda
def test_prefill_attention_bwd_bf16_strided_views():
    """K5's bf16 instance on a fused qkv that is itself a strided view (a
    column slice of a wider tensor, with batch rows apart by more than T
    time steps) writing into (dq, dk, dv) views of a wider gradient: the
    same bits as on contiguous copies, and nothing written outside the
    views."""
    gen = _card()
    b, h, dk, x_len, y_len = 3, 16, 32, 29, 70
    t, d3 = x_len + y_len, 3 * 16 * 32
    xl = torch.tensor([29, 12, 3], dtype=torch.int32, device="cuda")
    yl = torch.tensor([70, 41, 9], dtype=torch.int32, device="cuda")
    wide = torch.randn((b, t + 5, d3 + 64), generator=gen,
                       device="cuda").to(torch.bfloat16)
    qkv = wide[:, 2:t + 2, 32:32 + d3]
    q, k, v = att._split_heads(qkv, h)
    o, lse = att.prefill_attention_lse(q, k, v, x_len, xl, yl)
    do = torch.randn((b, t, h, dk), generator=gen,
                     device="cuda").to(torch.bfloat16)
    out = torch.full((b, t + 3, d3 + 32), float("nan"), device="cuda",
                     dtype=torch.bfloat16)
    views = att._split_heads(out[:, 1:t + 1, 16:16 + d3], h)
    got = prefill_attention_bwd(q, k, v, o, lse, do, x_len, xl, yl,
                                out=views)
    flat = att._split_heads(qkv.contiguous(), h)
    want = prefill_attention_bwd(*flat, o, lse, do, x_len, xl, yl)
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    inside = torch.zeros(out.shape, dtype=torch.bool, device="cuda")
    inside[:, 1:t + 1, 16:16 + d3] = True
    assert torch.isnan(out.float()[~inside]).all()
    assert not torch.isnan(out.float()[inside]).any()


@pytest.mark.cuda
def test_self_attention_bf16_autograd_on_the_card():
    """The training attention in bf16: K1's and K5's bf16 instances through
    the autograd Function against autograd of the bf16 dense twin; o and
    d(qkv) bf16.  Autograd of the twin takes the softmax's D from the fp32
    o, as JAX does, where K5 reads the bf16 o that K1 wrote: the gradient
    may differ by one step in up to 5 % of its elements."""
    gen = _card()
    b, h, dk, x_len, y_len = 3, 16, 32, 37, 90
    xl = torch.tensor([37, 20, 5], dtype=torch.int32, device="cuda")
    yl = torch.tensor([90, 71, 2], dtype=torch.int32, device="cuda")
    qkv = torch.randn((b, x_len + y_len, 3 * h * dk), generator=gen,
                      device="cuda").to(torch.bfloat16)
    do = torch.randn((b, x_len + y_len, h, dk), generator=gen,
                     device="cuda").to(torch.bfloat16)
    outs, grads = [], []
    for card in (True, False):
        x = qkv.clone().requires_grad_()
        if card:
            o = self_attention(x, h, x_len, xl, yl)
        else:
            o = att.prefill_attention_reference(*att._split_heads(x, h),
                                                x_len, xl, yl)
        o.backward(do)
        outs.append(o.detach())
        grads.append(x.grad)
    assert grads[0].dtype == torch.bfloat16
    _close_bf16(outs[0], outs[1])
    _close_bf16(grads[0], grads[1], share=0.05)


@pytest.mark.cuda
def test_bf16_wrappers_refuse_other_dtypes():
    """A CUDA tensor of a dtype the kernels have no instance for (fp16), or
    of mixed dtypes, raises before any launch; nothing is cast."""
    gen = _card()
    lens = torch.tensor([8, 5], dtype=torch.int32, device="cuda")
    qkv = torch.randn((2, 16, 3 * 2 * 32), generator=gen, device="cuda")
    for dtype in (torch.float16, torch.float64):
        q, k, v = att._split_heads(qkv.to(dtype), 2)
        with pytest.raises(ValueError):
            prefill_attention(q, k, v, 8, lens, lens)
        with pytest.raises(ValueError):
            self_attention(qkv.to(dtype), 2, 8, lens, lens)
    x = torch.randn((2, 16, 40), generator=gen, device="cuda")
    w = torch.randn((16, 16, 3), generator=gen, device="cuda")
    b = torch.randn((16,), generator=gen, device="cuda")
    counts = [fn.launches + fn.launches_bf16 for fn in (
        mrf_conv, mrf_conv_bwd_data, mrf_conv_bwd_weight)]
    for args in ((x.half(), w.half(), b.half()),
                 (x.to(torch.bfloat16), w, b),
                 (x, w.to(torch.bfloat16), b.to(torch.bfloat16))):
        with pytest.raises(ValueError):
            mrf_conv(*args, 1)
        with pytest.raises(ValueError):
            mrf_conv_bwd_data(args[0], args[0], args[1], 1)
        with pytest.raises(ValueError):
            mrf_conv_bwd_weight(args[0], args[0].to(args[1].dtype),
                                (16, 16, 3), 1)
    assert counts == [fn.launches + fn.launches_bf16 for fn in (
        mrf_conv, mrf_conv_bwd_data, mrf_conv_bwd_weight)]


def _bf16_conv_inputs(gen, b, cin, cout, t_len, k):
    bf = torch.bfloat16
    x = torch.randn((b, cin, t_len), generator=gen, device="cuda")
    x[0, :, : max(1, t_len // 3)] = 0.0     # lrelu(0) = 0, lrelu'(0) = 1
    w = torch.randn((cout, cin, k), generator=gen, device="cuda") \
        / (cin * k) ** 0.5
    bias = torch.randn((cout,), generator=gen, device="cuda")
    r = torch.randn((b, cout, t_len), generator=gen, device="cuda")
    dy = torch.randn((b, cout, t_len), generator=gen, device="cuda")
    return (t.to(bf) for t in (x, w, bias, r, dy))


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,t_len,k,d", [
    (256, 256, 320, 11, 5),  # the s2 stages' shapes
    (128, 128, 2560, 7, 3),
    (64, 64, 5120, 3, 1),
    (32, 32, 10240, 11, 5),
    (16, 16, 20480, 7, 3),
    (24, 24, 5, 11, 5),      # T below one tile; the halo passes both edges
    (16, 72, 1, 3, 1),       # a single sample
    (24, 40, 37, 3, 1),      # T % 4 != 0: element loads; Cin != Cout
    (72, 24, 301, 7, 3),     # channels off the tiles
    (40, 24, 260, 5, 5),     # generic tap count
    (200, 128, 300, 7, 1),   # a channel split with uneven shares
    (8, 24, 40, 3, 1),       # K3 reduces over less than one 16-channel chunk
    (12, 40, 96, 7, 3),      # the same, Cin % 8 != 0: element weight loads
    (40, 12, 64, 5, 1),      # K4-dx reduces over Cout = 12
    (24, 40, 262, 11, 5),    # T % 8 == 6, 4-byte copies; the halo crosses
                             # both edges of the 256-sample tiles
    (40, 24, 250, 3, 3),     # T % 8 == 2
    (96, 80, 512, 7, 1),     # Cout (and dx's Cin) off the 64-row tiles
])
def test_mrf_conv_bf16_kernels_match_twins(cin, cout, t_len, k, d):
    """K3's and K4-dx's bf16 instances at the s2 shapes, the tile edges of
    the fp32 tests and those of the bf16 loop (16-channel chunks, 8-sample
    copies, 64-row tiles): K3 with and without the residual, dx with exact
    zeros in x; each against its bf16 twin, one bf16 launch counted a
    call."""
    gen = _card()
    x, w, b, r, dy = _bf16_conv_inputs(gen, 3, cin, cout, t_len, k)
    for res in (None, r):
        before = (mrf_conv.launches, mrf_conv.launches_bf16)
        got = mrf_conv(x, w, b, d, residual=res)
        assert (mrf_conv.launches, mrf_conv.launches_bf16) == (
            before[0], before[1] + 1)
        _close_bf16(got, mrf_conv_reference(x, w, b, d, residual=res))
    before = mrf_conv_bwd_data.launches_bf16
    dx = mrf_conv_bwd_data(dy, x, w, d)
    assert mrf_conv_bwd_data.launches_bf16 == before + 1
    _close_bf16(dx, mrf.mrf_conv_bwd_data_reference(dy, x, w, d))


@pytest.mark.cuda
def test_mrf_conv_bf16_kernels_repeat_bit_for_bit():
    """K3's and K4-dx's bf16 instances launched ten times each on a shape
    whose grid is split along the channels into clusters (the partial sums
    added in rank order through distributed shared memory): every output
    bit-identical to the first."""
    gen = _card()
    x, w, b, r, dy = _bf16_conv_inputs(gen, 3, 200, 128, 300, 7)
    first = (mrf_conv(x, w, b, 1, residual=r),
             mrf_conv_bwd_data(dy, x, w, 1))
    for _ in range(9):
        assert torch.equal(mrf_conv(x, w, b, 1, residual=r), first[0])
        assert torch.equal(mrf_conv_bwd_data(dy, x, w, 1), first[1])


BF16_WGRAD_CASES = [
    # the mma.sync route (Cin or Cout < 64)
    (24, 24, 3, 5, 11, 5),      # T below the halo
    (16, 72, 3, 1, 3, 1),       # a single sample; three output tiles
    (24, 40, 3, 37, 3, 1),      # T % 4 != 0: element loads
    (72, 24, 3, 301, 7, 3),     # three input-channel tiles
    (40, 24, 3, 260, 5, 5),     # k = 5
    (32, 32, 1, 1, 15, 5),      # k = 15, B = 1
    (16, 16, 2, 40001, 3, 1),   # the long reduction
    # the bf16 wgmma route (Cin and Cout >= 64): 128-sample stages, x
    # shifted by pad = (k - 1) d / 2 samples, odd or even
    (256, 256, 8, 320, 11, 5),  # s2 stage 0: N = 128, four tap groups of
                                # three, pad 25, T off the stage
    (128, 128, 8, 2560, 7, 3),  # s2 stage 1: three tap groups, pad 9
    (64, 64, 8, 5120, 3, 1),    # s2 stage 2: N = 64, one tap group, pad 1
    (64, 64, 1, 4100, 15, 5),   # k = 15 at d = 5 (halo 70), five tap
                                # groups, B = 1; T % 8 = 4: 2-byte loads
    (200, 128, 2, 300, 7, 1),   # Cin off the 64-row tile; T % 8 = 4
    (72, 200, 2, 777, 3, 3),    # two N tiles, the second 72 of 128 wide
    (96, 80, 3, 1000, 5, 2),    # pad 4; Cout 80 of a 128-wide N tile;
                                # T off the stage, 16-byte copies
    (128, 64, 2, 2048, 9, 2),   # pad 8 (no shift), three tap groups
    (256, 256, 1, 1537, 15, 3), # B = 1, T odd, five tap groups
    (256, 256, 1, 256, 15, 3),  # two time tiles: one cluster, no scratch
    (64, 64, 8, 40000, 3, 5),   # the long reduction, through the scratch
]


@pytest.mark.cuda
def test_mrf_conv_wgrad_bf16_tile_edges():
    """K4-dW's bf16 instance at the edges of both of its routes' tiles
    (mma.sync below 64 channels, bf16 wgmma at 64 and more) and of both
    splits of the B*T sum (inside one cluster, and across clusters through
    the scratch): the planner's route for each case, one bf16 launch
    counted a call, dW and db against the bf16 twin, a second call
    bit-identical."""
    gen = _card()
    kinds = set()
    for cin, cout, b, t_len, k, d in BF16_WGRAD_CASES:
        x, _, _, _, _ = _bf16_conv_inputs(gen, b, cin, cout, t_len, k)
        dy = torch.randn((b, cout, t_len), generator=gen,
                         device="cuda").to(torch.bfloat16)
        plan = mrf.wgrad_card_plan(b, cin, cout, t_len, k, d,
                                   torch.device("cuda"), torch.bfloat16)
        wgmma = cin >= 64 and cout >= 64
        assert (plan.bn > 32) == wgmma, (cin, cout, plan)
        kinds.add((wgmma, plan.clusters > 1))
        before = (mrf_conv_bwd_weight.launches,
                  mrf_conv_bwd_weight.launches_bf16)
        dw, db = mrf_conv_bwd_weight(dy, x, (cout, cin, k), d)
        assert (mrf_conv_bwd_weight.launches,
                mrf_conv_bwd_weight.launches_bf16) == (before[0],
                                                       before[1] + 1)
        ww, wb = mrf.mrf_conv_bwd_weight_reference(dy, x, (cout, cin, k), d)
        _close_bf16(dw, ww)
        _close_bf16(db, wb)
        dw2, db2 = mrf_conv_bwd_weight(dy, x, (cout, cin, k), d)
        assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert kinds == {(False, False), (False, True), (True, False),
                     (True, True)}, kinds


@pytest.mark.cuda
def test_mrf_conv_bf16_autograd_on_the_card():
    """K3 forward and K4 backward in bf16 through the autograd Function
    against autograd of the bf16 twin."""
    gen = _card()
    x, w, b, r, dy = _bf16_conv_inputs(gen, 2, 64, 64, 900, 7)
    grads = []
    for fn in (mrf_conv, mrf_conv_reference):
        ins = [t.clone().requires_grad_() for t in (x, w, b, r)]
        y = fn(ins[0], ins[1], ins[2], 3, residual=ins[3])
        y.backward(dy)
        grads.append([t.grad for t in ins])
    for got, want in zip(*grads):
        _close_bf16(got, want)


@pytest.mark.parametrize("c,t_len", S2_STAGES)
def test_wgrad_plan_bf16_is_the_mma_route(c, t_len):
    """The bf16 instance's plans at the s2 shapes: the bf16 wgmma route
    (64 input x 64 or 128 output channels a tile, taps in groups of at most
    three, 128-sample stages) at C >= 64 and the mma.sync route (16 or 32
    output channels, all k taps) below; every sample of every row summed
    by exactly one split; the grid within one wave (one wgmma block or two
    mma.sync blocks an SM); the shared memory within a block's."""
    b = 8
    for k in (3, 7, 11):
        for d in (1, 3, 5):
            plan = mrf.wgrad_plan(b, c, c, t_len, k, d,
                                  dtype=torch.bfloat16)
            if c >= 64:
                assert (plan.bn, plan.bi, plan.ts) == (
                    min(c, 128), 64, mrf.WGRAD_TS_BF16)
                assert plan.taps <= 3 and plan.taps * -(-k // plan.taps) >= k
            else:
                assert (plan.bn, plan.taps, plan.ts) == (max(c, 16), k, 128)
            per_row = -(-t_len // plan.ts)
            assert plan.time_tiles == b * per_row
            seen = np.zeros((b, per_row * plan.ts), np.int64)
            for s in range(plan.splits):
                first, end = plan.time_range(s)
                assert end > first
                for tile in range(first, end):
                    t0 = tile % per_row * plan.ts
                    seen[tile // per_row, t0:t0 + plan.ts] += 1
            assert (seen == 1).all()
            assert plan.blocks <= mrf.WGRAD_SMS * (2 if plan.bn <= 32 else 1)
            assert plan.smem_bytes <= mrf.WGRAD_SMEM


def test_wgrad_plan_takes_a_tile_width():
    """``bn`` overrides the planner's tile width (what the design benches
    time): 64 at C = 128 doubles the output-channel tiles, 32 at C = 64
    takes the mma.sync route; a width no kernel has raises.  The bf16
    wgmma route's shared memory counts 2-byte tiles and no lo plane (three
    dy stages, two lrelu(x) stages and two raw x tiles), the fp32 route's
    its two stages of dy hi, lo and x."""
    wide = mrf.wgrad_plan(8, 128, 128, 2560, 7, 3, dtype=torch.bfloat16)
    narrow = mrf.wgrad_plan(8, 128, 128, 2560, 7, 3, dtype=torch.bfloat16,
                            bn=64)
    assert (wide.bn, narrow.bn) == (128, 64)
    assert narrow.tiles == 2 * wide.tiles
    mma = mrf.wgrad_plan(8, 64, 64, 5120, 3, 1, dtype=torch.bfloat16,
                         bn=32)
    assert (mma.bn, mma.bi, mma.taps, mma.ts) == (32, 32, 3, 128)
    with pytest.raises(ValueError):
        mrf.wgrad_plan(8, 128, 128, 2560, 7, 3, bn=48)
    fp32 = mrf.wgrad_plan(8, 256, 256, 320, 11, 5)
    bf16 = mrf.wgrad_plan(8, 256, 256, 320, 11, 5, dtype=torch.bfloat16)
    assert (fp32.ts, bf16.ts) == (64, mrf.WGRAD_TS_BF16)
    halo = 10 * 5
    rx = (mrf.WGRAD_TS_BF16 + halo + 7 + 31) // 32 * 32
    stages = 2 * (3 * 128 * mrf.WGRAD_TS_BF16 + 4 * 64 * rx)
    assert bf16.smem_bytes == max(stages, 4 * (64 * 384 + 128))
    assert fp32.smem_bytes == 4 * max(2 * (2 * 128 * 64 + 64 * 132),
                                      64 * 384 + 128 + 384)
    assert fp32.smem_bytes == 4 * max(2 * (2 * 128 * 64 + 64 * 132),
                                      64 * 384 + 128 + 384)


def test_bf16_twins_round_as_jax():
    """The bf16 twins on the CPU: leaky relu with bf16(0.1), the conv
    rounded before the bias add, the data gradient rounded before the leaky
    relu's derivative, dW / db rounded once; the outputs are bf16 and no
    kernel launch is counted."""
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((2, 8, 30), generator=gen).to(bf)
    w = (torch.randn((8, 8, 3), generator=gen) * 0.3).to(bf)
    b = torch.randn((8,), generator=gen).to(bf)
    counts = [fn.launches_bf16 for fn in (mrf_conv, mrf_conv_bwd_data,
                                          mrf_conv_bwd_weight)]
    y = mrf_conv_reference(x, w, b, 3)
    act = torch.where(x >= 0, x, x * 0.10009765625)
    conv = torch.nn.functional.conv1d(act.float(), w.float(), padding=3,
                                      dilation=3).to(bf)
    assert y.dtype == bf and torch.equal(y, conv + b[:, None])
    dx = mrf.mrf_conv_bwd_data_reference(x, x, w, 3)
    da = torch.nn.functional.conv_transpose1d(x.float(), w.float(),
                                              padding=3, dilation=3).to(bf)
    assert torch.equal(dx, torch.where(x >= 0, da, da * 0.10009765625))
    dw, db = mrf.mrf_conv_bwd_weight_reference(x, x, w.shape, 3)
    assert dw.dtype == db.dtype == bf
    assert counts == [fn.launches_bf16 for fn in (
        mrf_conv, mrf_conv_bwd_data, mrf_conv_bwd_weight)]


def _frcrn_checkpoint(path, cfg):
    """Seeded random FRCRN weights with positive running variances."""
    from easevoice_trainer_tpu_torch import convert
    from easevoice_trainer_tpu_torch.audiokit.frcrn import FRCRN

    state = convert.random_state_dict(FRCRN(cfg),
                                      torch.Generator().manual_seed(3))
    for k in state:
        if k.endswith("running_var"):
            state[k] = state[k].abs() + 0.5
    torch.save(state, str(path))


@pytest.mark.cuda
def test_frcrn_denoiser_card_matches_cpu(tmp_path):
    """The denoiser (STFT, both U-Nets, inverse STFT) on the card against
    the CPU at a small config over a 2.5 s clip (two 2 s buckets): within
    1e-4 of the largest CPU magnitude, TF32 off."""
    from easevoice_trainer_tpu_torch.audiokit.frcrn import FRCRNConfig, \
        FRCRNDenoiser

    _card()
    cfg = FRCRNConfig(channels=16, depth=4, fsmn_hidden=16, lorder=5)
    _frcrn_checkpoint(tmp_path / "frcrn.pth", cfg)
    wav = np.random.default_rng(4).uniform(-0.4, 0.4, 40000).astype(
        np.float32)
    want = FRCRNDenoiser(str(tmp_path / "frcrn.pth"), "cpu", cfg).process(
        wav, 16000)
    got = FRCRNDenoiser(str(tmp_path / "frcrn.pth"), "cuda", cfg).process(
        wav, 16000)
    assert got.shape == want.shape == wav.shape
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= 1e-4, err


@pytest.mark.cuda
def test_normalize_ssl_on_the_card(tmp_path, monkeypatch):
    """``Normalize.ssl`` with ``device="cuda"``: the HuBERT attention on K1
    at head width 64, one launch a layer a clip; the 4-cnhubert features
    within 1e-4 of the largest CPU magnitude and 5-wav32k identical to a
    CPU run of the same stage."""
    import json
    import os

    from easevoice_trainer_tpu_torch import convert
    from easevoice_trainer_tpu_torch.models.cnhubert import CNHubert, \
        HubertConfig
    from easevoice_trainer_tpu_torch.normalization import Normalize
    from easevoice_trainer_tpu_torch.utils import audio_io

    _card()
    cfg = HubertConfig(conv_dim=(32,) * 7, hidden_size=128, num_layers=2,
                       num_heads=2, intermediate_size=256, pos_conv_kernel=16,
                       pos_conv_groups=4)
    hub = tmp_path / "hubert"
    hub.mkdir()
    (hub / "config.json").write_text(json.dumps({
        "conv_dim": list(cfg.conv_dim), "hidden_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 256, "num_conv_pos_embeddings": 16,
        "num_conv_pos_embedding_groups": 4}))
    torch.save(convert.random_state_dict(CNHubert(cfg),
                                         torch.Generator().manual_seed(5)),
               str(hub / "pytorch_model.bin"))
    monkeypatch.setenv("cnhubert_path", str(hub))
    ws = tmp_path / "ws"
    (ws / "refinements").mkdir(parents=True)
    (ws / "denoises").mkdir()
    rng = np.random.default_rng(6)
    names = [f"c{i}.wav" for i in range(3)]
    for i, name in enumerate(names):
        audio_io.write_wav(str(ws / "denoises" / name), rng.uniform(
            -0.4, 0.4, 16000 + 7777 * i).astype(np.float32), 16000)
    (ws / "refinements" / "refinement.list").write_text(
        "\n".join(f"{n}|en|hello" for n in names))
    runs = {}
    for dev in ("cpu", "cuda"):
        norm = Normalize(str(ws), f"out_{dev}", device=dev)
        n0 = encoder_attention.launches
        assert norm.ssl().ok
        runs[dev] = (norm, encoder_attention.launches - n0)
    (cpu, n_cpu), (card, n_card) = runs["cpu"], runs["cuda"]
    assert n_cpu == 0 and n_card == cfg.num_layers * len(names)
    for name in names:
        want = torch.load(os.path.join(cpu.hubert_dir, name + ".pt"))
        got = torch.load(os.path.join(card.hubert_dir, name + ".pt"))
        assert got.device.type == "cpu" and got.shape == want.shape
        err = float((got - want).abs().max()) / max(
            1.0, float(want.abs().max()))
        assert err <= 1e-4, (name, err)
        a, _ = audio_io.read_wav(os.path.join(cpu.wav_dir, name))
        b, _ = audio_io.read_wav(os.path.join(card.wav_dir, name))
        np.testing.assert_array_equal(b, a)


# the Roformers' axial attention (B, H, T): BS-Roformer's time axis (62
# band rows of the 801 frames of an 8 s chunk) and frequency axis (801
# frame rows of 62 bands), Mel-Band Roformer's (60 bands); no padding
ROFORMER_CASES = [(62, 8, 801), (801, 8, 62), (60, 8, 801), (801, 8, 60)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t", ROFORMER_CASES)
def test_encoder_attention_at_the_roformer_shapes(b, h, t):
    """K1 at dk 64 as ``RoformerAttention`` calls it: q and k rotated
    (contiguous), v a view of the fused qkv projection, every key valid;
    within the dk-64 tolerance of its twin, and every batch row equal, bit
    for bit, to a run of that row alone."""
    gen = _card()
    qkv = torch.randn((b, t, 3, h, 64), generator=gen, device="cuda")
    q, k = (qkv[:, :, i].contiguous() for i in (0, 1))
    v = qkv[:, :, 2]
    full = torch.full((b,), t, dtype=torch.int32, device="cuda")
    n0 = encoder_attention.launches
    got = encoder_attention(q, k, v, full)
    want = att.prefill_attention_reference(q, k, v, t, full,
                                           torch.zeros_like(full))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert encoder_attention.launches == n0 + 1
    for i in range(0, b, max(1, b // 16)):
        alone = encoder_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                  full[i:i + 1])
        torch.testing.assert_close(alone[0], got[i], rtol=0, atol=0)


@pytest.mark.cuda
def test_roformer_card_matches_cpu():
    """A 2-layer BS-Roformer at the released widths (dim 512, 62 bands) on
    one second of a chunk: the card (K1) against the CPU (the twin),
    within 1e-4 of the largest CPU magnitude, two K1 launches a layer."""
    from easevoice_trainer_tpu_torch import convert
    from easevoice_trainer_tpu_torch.audiokit.bs_roformer import (
        BSRoformer, BSRoformerConfig)

    _card()
    net = BSRoformer(BSRoformerConfig(depth=2))
    net.load_state_dict(convert.random_state_dict(
        net, torch.Generator().manual_seed(3)))
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (1, 2050, 101, 2)).astype(np.float32))
    with torch.no_grad():
        want = net.eval()(x)
        n0 = encoder_attention.launches
        got = net.cuda()(x.cuda()).cpu()
    assert encoder_attention.launches == n0 + 4
    err = float((got - want).abs().max()) / max(1.0, float(
        want.abs().max()))
    assert err <= 1e-4, err


# ---- dropout: K1 and K5's dropout instances (T2SConfig.dropout > 0) ----------
#
# Each against its twin given the keep mask the kernels draw
# (``attention_keep_mask``): fp32 within K1's 1e-4 absolute and K5's 1e-4
# relative, bf16 within the 2^-6 / one-step rule (``_close_bf16``).

DROPOUT_DTYPES = [torch.float32, torch.bfloat16]
# the global batch row of a call's batch row 0: 0, and a data-parallel
# rank's first row
DROPOUT_ROW0S = [0, 5]


def _dropout_heads(gen, dtype, x_len, x_lens, y_len, y_lens, h=16):
    b, t = len(x_lens), x_len + y_len
    xl = torch.tensor(x_lens, dtype=torch.int32, device="cuda")
    yl = torch.tensor(y_lens, dtype=torch.int32, device="cuda")
    qkv = torch.randn((b, t, 3 * h * 32), generator=gen,
                      device="cuda").to(dtype)
    do = torch.randn((b, t, h, 32), generator=gen, device="cuda").to(dtype)
    return (*att._split_heads(qkv, h), do, xl, yl)


def _k1_dropout(q, k, v, x_len, xl, yl, drop):
    """K1's dropout instance with its lse: (o, lse, the keep bits it wrote,
    which K5 reads)."""
    bits = att.new_mask_bits(q, x_len)
    o, lse = att.prefill_attention_lse(q, k, v, x_len, xl, yl, drop,
                                       mask_bits=bits)
    return o, lse, bits


def _close(got, want, dtype, rel):
    if dtype == torch.bfloat16:
        _close_bf16(got, want)
    elif rel:
        _close_rel(got, want, 1e-4)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DROPOUT_DTYPES)
@pytest.mark.parametrize("x_len,x_lens,y_len,y_lens",
                         K5_CASES + K1_BF16_EDGES + K5_BF16_EDGES)
@pytest.mark.parametrize("row0", DROPOUT_ROW0S)
def test_prefill_attention_dropout_matches_twin(dtype, x_len, x_lens, y_len,
                                                y_lens, row0):
    """K1's dropout instance (p = 0.1) with its lse at the s1 shapes and the
    tile edges of both dtypes: o against the twin with the same keep mask
    (rows that see no key are 0), the lse bit-equal to the instance
    without dropout's (the undropped softmax), one dropout launch counted
    and no other, two calls bit-identical; ``row0`` 0, and 5 as a
    data-parallel rank whose rows start at global row 5."""
    gen = _card()
    q, k, v, _, xl, yl = _dropout_heads(gen, dtype, x_len, x_lens, y_len,
                                        y_lens)
    drop = att.AttentionDropout(0.1, 0x1234_5678_9ABC, 7, row0)
    counts = ("launches", "launches_bf16", "launches_dropout",
              "launches_dropout_bf16")
    before = [getattr(prefill_attention, c) for c in counts]
    o, lse = att.prefill_attention_lse(q, k, v, x_len, xl, yl, drop)
    ran = "launches_dropout" + ("_bf16" if dtype == torch.bfloat16 else "")
    assert [getattr(prefill_attention, c) for c in counts] == [
        n + (c == ran) for n, c in zip(before, counts)]
    b, t, h, _ = q.shape
    mask = drop.keep_mask(b, h, t, x_len, "cuda")
    want = torch.nan_to_num(att.prefill_attention_reference(
        q, k, v, x_len, xl, yl, mask, 0.1), nan=0.0)
    _close(o, want, dtype, rel=False)
    assert torch.equal(lse, att.prefill_attention_lse(q, k, v, x_len, xl,
                                                      yl)[1])
    again = att.prefill_attention_lse(q, k, v, x_len, xl, yl, drop)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DROPOUT_DTYPES)
@pytest.mark.parametrize("x_len,x_lens,y_len,y_lens",
                         K5_CASES + K5_BF16_EDGES)
@pytest.mark.parametrize("row0", DROPOUT_ROW0S)
def test_prefill_attention_bwd_dropout_matches_twin(dtype, x_len, x_lens,
                                                    y_len, y_lens, row0):
    """K5's dropout instance on the o and lse of K1's: dq, dk, dv against
    the twin with the same keep mask, finite, three dropout launches
    counted and no other, repeated launches bit-identical; ``row0`` as in
    the K1 test."""
    gen = _card()
    q, k, v, do, xl, yl = _dropout_heads(gen, dtype, x_len, x_lens, y_len,
                                         y_lens)
    drop = att.AttentionDropout(0.1, 99, 23, row0)
    o, lse, bits = _k1_dropout(q, k, v, x_len, xl, yl, drop)
    counts = ("launches", "launches_bf16", "launches_dropout",
              "launches_dropout_bf16")
    before = [getattr(prefill_attention_bwd, c) for c in counts]
    got = prefill_attention_bwd(q, k, v, o, lse, do, x_len, xl, yl,
                                dropout=drop, mask_bits=bits)
    ran = "launches_dropout" + ("_bf16" if dtype == torch.bfloat16 else "")
    assert [getattr(prefill_attention_bwd, c) for c in counts] == [
        n + 3 * (c == ran) for n, c in zip(before, counts)]
    b, t, h, _ = q.shape
    want = att.prefill_attention_bwd_reference(
        q, k, v, o, lse, do, x_len, xl, yl,
        drop.keep_mask(b, h, t, x_len, "cuda"), 0.1)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g.float()).all(), name
        _close(g, w, dtype, rel=True)
    again = prefill_attention_bwd(q, k, v, o, lse, do, x_len, xl, yl,
                                  dropout=drop, mask_bits=bits)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DROPOUT_DTYPES)
@pytest.mark.parametrize("x_len,x_lens,y_len,y_lens",
                         K5_CASES + K1_BF16_EDGES + K5_BF16_EDGES)
def test_prefill_attention_dropout_writes_the_bits(dtype, x_len, x_lens,
                                                   y_len, y_lens):
    """K1's dropout instance, fp32 and bf16, writes the keep mask as bits
    (``ops/philox.py pack_keep_mask`` of ``attention_keep_mask`` AND-ed
    with the visible pairs), bit for bit over the whole (B, H, T, W)
    tensor, set to all ones before the launch so that the words of keys it
    never walks must be written too, at ``row0`` 5 and ``h0`` 8; repeated
    launches write the same bits and o, and a launch without the tensor
    gives the same o and lse."""
    gen = _card()
    q, k, v, _, xl, yl = _dropout_heads(gen, dtype, x_len, x_lens, y_len,
                                        y_lens, h=8)
    drop = att.AttentionDropout(0.1, 0x5EED_0022, 17, 5, 8)
    bits = torch.full_like(att.new_mask_bits(q, x_len), -1)
    o, lse = att.prefill_attention_lse(q, k, v, x_len, xl, yl, drop,
                                       mask_bits=bits)
    b, t, h, _ = q.shape
    want = att.keep_bits_reference(drop.keep_mask(b, h, t, x_len, "cuda"),
                                   x_len, xl, yl)
    assert torch.equal(bits, want)
    again = torch.zeros_like(bits)
    o2, _ = att.prefill_attention_lse(q, k, v, x_len, xl, yl, drop,
                                      mask_bits=again)
    o3, lse3 = att.prefill_attention_lse(q, k, v, x_len, xl, yl, drop)
    assert torch.equal(again, bits)
    assert torch.equal(o2, o) and torch.equal(o3, o)
    assert torch.equal(lse3, lse)


@pytest.mark.cuda
def test_prefill_attention_bwd_dropout_bits_by_dtype():
    """On the card K5 with dropout reads K1's bits in both dtypes and
    raises without them (it never draws the mask again), before launching
    anything; given them, its gradients equal the twin's within the
    dtype's tolerance."""
    gen = _card()
    drop = att.AttentionDropout(0.1, 7, 1)
    for dtype in DROPOUT_DTYPES:
        q, k, v, do, xl, yl = _dropout_heads(gen, dtype, 40, [1, 40],
                                             95, [95, 60])
        o, lse, bits = _k1_dropout(q, k, v, 40, xl, yl, drop)
        before = prefill_attention_bwd.launches_dropout + \
            prefill_attention_bwd.launches_dropout_bf16
        with pytest.raises(ValueError, match="mask_bits"):
            prefill_attention_bwd(q, k, v, o, lse, do, 40, xl, yl,
                                  dropout=drop)
        assert before == prefill_attention_bwd.launches_dropout + \
            prefill_attention_bwd.launches_dropout_bf16
        got = prefill_attention_bwd(q, k, v, o, lse, do, 40, xl, yl,
                                    dropout=drop, mask_bits=bits)
        b, t, h, _ = q.shape
        want = att.prefill_attention_bwd_reference(
            q, k, v, o, lse, do, 40, xl, yl,
            drop.keep_mask(b, h, t, 40, "cuda"), 0.1)
        for g, w in zip(got, want):
            _close(g, w, dtype, rel=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DROPOUT_DTYPES)
@pytest.mark.parametrize("x_len,x_lens,y_len,y_lens", [
    (37, [37, 0, 5], 95, [95, 71, 2]),       # x_len off every tile, no text
    (64, [64, 63, 1], 63, [63, 62, 0]),      # on the tiles, one off
    (1, [1, 0], 14, [14, 0]),                # T = 15
    (416, [416, 211], 1360, [877, 1360]),    # the long s1 shape
])
@pytest.mark.parametrize("row0", DROPOUT_ROW0S)
def test_dropout_mask_readout(dtype, x_len, x_lens, y_len, y_lens, row0):
    """The keep bits K1, K5's dkdv kernel and K5's dq kernel draw, read
    through their outputs (chip_smoke ``dropout_readout``: q = 0 makes P
    uniform over a row's visible keys, and one-hot v, dO or k turn one
    block of pairs into outputs that are positive exactly where a pair is
    kept), equal ``attention_keep_mask`` on every visible pair, across
    tiles and the text / audio boundary; hidden pairs read 0.  With
    ``row0`` 5 they are the rows 5 .. of the global batch's mask."""
    _card()
    xl = torch.tensor(x_lens, dtype=torch.int32, device="cuda")
    yl = torch.tensor(y_lens, dtype=torch.int32, device="cuda")
    got = _chip_smoke().dropout_readout(
        torch, att, dtype, att.AttentionDropout(0.1, 2 ** 40 + 5, 19, row0),
        x_len, xl, yl, x_len + y_len, h=4)
    assert all(bad == 0 and n > 0 for bad, n in got.values()), got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DROPOUT_DTYPES)
@pytest.mark.parametrize("x_len,x_lens,y_len,y_lens", [
    K5_CASES[0], (40, [1, 40, 33, 5], 95, [95, 60, 1, 33])])
@pytest.mark.parametrize("h0", [0, 8])
def test_dropout_h0_is_the_layer_head(dtype, x_len, x_lens, y_len, y_lens,
                                      h0):
    """A tensor-parallel rank's launch over 8 heads that are the layer's
    heads ``h0 ..``: K1's and K5's dropout instances against the twin with
    the mask of those heads, and bit for bit the outputs and gradients of
    the launch over all 16 heads at those heads (the bits of (h0 = 8, h)
    are those of (h0 = 0, h + 8)); with h0 = 0 the first 8 heads'."""
    gen = _card()
    q, k, v, do, xl, yl = _dropout_heads(gen, dtype, x_len, x_lens, y_len,
                                         y_lens)
    whole = att.AttentionDropout(0.1, 0xABCD_1234_5678, 11, 3)
    part = att.AttentionDropout(0.1, whole.seed, 11, 3, h0)
    heads = slice(h0, h0 + 8)
    q8, k8, v8, do8 = (z[:, :, heads] for z in (q, k, v, do))
    o, lse, bits = _k1_dropout(q, k, v, x_len, xl, yl, whole)
    grads = prefill_attention_bwd(q, k, v, o, lse, do, x_len, xl, yl,
                                  dropout=whole, mask_bits=bits)
    o8, lse8, bits8 = _k1_dropout(q8, k8, v8, x_len, xl, yl, part)
    grads8 = prefill_attention_bwd(q8, k8, v8, o8, lse8, do8, x_len, xl, yl,
                                   dropout=part, mask_bits=bits8)
    assert torch.equal(o8, o[:, :, heads])
    assert torch.equal(lse8, lse[:, heads])
    assert torch.equal(bits8, bits[:, heads])
    for g8, g in zip(grads8, grads):
        assert torch.equal(g8, g[:, :, heads])
    b, t = q.shape[:2]
    mask = part.keep_mask(b, 8, t, x_len, "cuda")
    assert torch.equal(mask, whole.keep_mask(b, 16, t, x_len, "cuda")[
        :, heads])
    want = torch.nan_to_num(att.prefill_attention_reference(
        q8, k8, v8, x_len, xl, yl, mask, 0.1), nan=0.0)
    _close(o8, want, dtype, rel=False)
    want = att.prefill_attention_bwd_reference(q8, k8, v8, o8, lse8, do8,
                                               x_len, xl, yl, mask, 0.1)
    for name, g, w in zip(("dq", "dk", "dv"), grads8, want):
        assert torch.isfinite(g.float()).all(), name
        _close(g, w, dtype, rel=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DROPOUT_DTYPES)
def test_self_attention_dropout_autograd_on_the_card(dtype):
    """The training attention with dropout through the autograd Function
    (K1 and K5's dropout instances; K5 reads the keep bits K1 wrote, which
    the Function saves)
    against autograd of the dense twin with the same mask; p = 0 launches
    the instances without dropout, p = 1 gives zeros."""
    gen = _card()
    b, h, dk, x_len, y_len = 3, 16, 32, 37, 90
    xl = torch.tensor([37, 20, 5], dtype=torch.int32, device="cuda")
    yl = torch.tensor([90, 71, 2], dtype=torch.int32, device="cuda")
    qkv = torch.randn((b, x_len + y_len, 3 * h * dk), generator=gen,
                      device="cuda").to(dtype)
    do = torch.randn((b, x_len + y_len, h, dk), generator=gen,
                     device="cuda").to(dtype)
    drop = att.AttentionDropout(0.1, 4242, 0)
    mask = drop.keep_mask(b, h, x_len + y_len, x_len, "cuda")
    outs, grads = [], []
    for card in (True, False):
        x = qkv.clone().requires_grad_()
        if card:
            o = self_attention(x, h, x_len, xl, yl, drop)
        else:
            o = att.prefill_attention_reference(*att._split_heads(x, h),
                                                x_len, xl, yl, mask, 0.1)
        o.backward(do)
        outs.append(o.detach())
        grads.append(x.grad)
    if dtype == torch.bfloat16:
        _close_bf16(outs[0], outs[1])
        _close_bf16(grads[0], grads[1], share=0.05)
    else:
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-4)
        _close_rel(grads[0], grads[1], 1e-4)
    n0 = prefill_attention.launches_dropout + \
        prefill_attention.launches_dropout_bf16
    off = self_attention(qkv, h, x_len, xl, yl,
                         att.AttentionDropout(0.0, 4242, 0))
    assert torch.equal(off, self_attention(qkv, h, x_len, xl, yl))
    assert n0 == prefill_attention.launches_dropout + \
        prefill_attention.launches_dropout_bf16
    assert not self_attention(qkv, h, x_len, xl, yl,
                              att.AttentionDropout(1.0, 4242, 0)).any()
