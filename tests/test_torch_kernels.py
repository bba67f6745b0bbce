"""The port's kernels (K1-K3 and K4's two entry points) against their plain
twins.

This file imports no JAX, so the ``cuda`` tests run on a machine with the
card and without JAX:

    python3 -m pytest tests/test_torch_kernels.py --noconftest -q

(``tests/conftest.py`` imports jax).  Without a card the ``cuda`` tests skip
and the CPU tests check the twins and the dispatch rule.  Kernel tolerances:
1e-4 absolute on outputs of magnitude ~1, for fp32 sums taken in another
order than the twin's; K4's weight gradient, a sum over B*T products, 1e-3
relative to its largest magnitude.
"""
import numpy as np
import pytest
import torch

from easevoice_trainer_tpu_torch.ops import attention as att
from easevoice_trainer_tpu_torch.ops import decode_attention, mrf_conv, \
    mrf_conv_bwd_data, mrf_conv_bwd_weight, prefill_attention
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


@pytest.mark.cuda
@pytest.mark.parametrize("x_len,x_lens,prompt", [
    (64, [64, 41, 17, 58], 250),   # the serving shape
    (16, [16, 1, 9, 12], 37),      # ragged tiles, a one-phoneme row
])
def test_prefill_attention_kernel_matches_twin(x_len, x_lens, prompt):
    gen = _card()
    b, h, dk, t = len(x_lens), 16, 32, x_len + prompt
    lens = torch.tensor(x_lens, dtype=torch.int32, device="cuda")
    qkv = torch.randn((b, t, 3 * h * dk), generator=gen, device="cuda")
    q, k, v = (z.view(b, t, h, dk) for z in qkv.split(h * dk, dim=-1))
    y_lens = torch.full((b,), prompt, dtype=torch.int32, device="cuda")
    before = prefill_attention.launches
    got = prefill_attention(q, k, v, x_len, lens, y_lens)
    assert prefill_attention.launches == before + 1
    want = att.prefill_attention_reference(q, k, v, x_len, lens, y_lens)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [0, 1, 500, 1119])
def test_decode_attention_kernel_matches_twin(step):
    gen = _card()
    b, h, dk, x_len, prompt = 4, 16, 32, 64, 250
    cache_len = x_len + prompt + 1120
    lens = torch.tensor([64, 41, 1, 58], dtype=torch.int32, device="cuda")
    kc = torch.randn((b, cache_len, h, dk), generator=gen, device="cuda")
    vc = torch.randn((b, cache_len, h, dk), generator=gen, device="cuda")
    q, k, v = (torch.randn((b, 1, h, dk), generator=gen, device="cuda")
               for _ in range(3))
    before = decode_attention.launches
    got = decode_attention(q, k, v, kc, vc, x_len, lens, prompt, step)
    assert decode_attention.launches == before + 1
    torch.testing.assert_close(kc[:, x_len + prompt + step], k[:, 0])
    want = att.decode_attention_reference(q, kc, vc, x_len, lens, prompt,
                                          step)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


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
    multiple of the 512-sample chunk (320, 1000, 777, 1537), a channel count
    that is not a multiple of the tile (24) and the generic tap loop (k=5):
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
