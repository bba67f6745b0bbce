"""The yardstick's operations, bytes and FLOPs against hand-worked values
on small shapes."""
import math

import pytest
import torch

from evbench import costs
from evbench.reference import gpt_s1 as ref


def test_visible_pairs_by_hand():
    # x_len 3, y_len 4; row 0: 2 text, 3 audio; row 1: 3 text, 4 audio.
    # row 0: 7 rows x 2 text keys = 14, audio keys 1+2+3+3 = 9 -> 23
    # row 1: 7 x 3 = 21, audio 1+2+3+4 = 10 -> 31
    assert costs.visible_pairs(3, 4, [2, 3], [3, 4]) == 54


@pytest.mark.parametrize("x_len,y_len", [(5, 7), (16, 9), (1, 30)])
def test_visible_pairs_against_the_mask(x_len, y_len):
    g = torch.Generator().manual_seed(x_len + y_len)
    b = 6
    x_lens = torch.randint(1, x_len + 1, (b,), generator=g)
    y_lens = torch.randint(1, y_len + 1, (b,), generator=g)
    mask = ref.hybrid_mask(x_len, y_len, x_lens, y_lens)
    assert costs.visible_pairs(x_len, y_len, x_lens.tolist(),
                               y_lens.tolist()) == int(mask.sum())


def test_attention_costs_by_hand():
    # b 2, t 10, h 4, dk 8, 100 pairs, bf16
    ops, nbytes = costs.attention_fwd_cost(2, 10, 4, 8, 100)
    assert ops == 4 * 8 * 100 * 4
    assert nbytes == 2 * 4 * 2 * 10 * 4 * 8 + 4 * 2 * 4 * 10
    ops, nbytes = costs.attention_bwd_cost(2, 10, 4, 8, 100, 4)
    assert ops == 10 * 8 * 100 * 4
    assert nbytes == 4 * 8 * 2 * 10 * 4 * 8 + 4 * 2 * 4 * 10


def test_mrf_costs_by_hand():
    c = costs.mrf_conv_costs(2, 4, 10, 3, residual=True)
    assert c["k3"] == (2 * 2 * 10 * 4 * 4 * 3, 2 * (3 * 80 + 48 + 4))
    assert c["dx"] == (1920, 2 * (3 * 80 + 48))
    assert c["dw"] == (1920, 2 * (2 * 80 + 48 + 4))


def test_least_seconds_takes_the_longer_bound():
    peak = costs.PEAKS["bf16_flops_per_s"]
    assert costs.least_seconds(peak, 1.0) == pytest.approx(1.0)
    assert costs.least_seconds(1.0, costs.PEAKS["hbm_bytes_per_s"]) == \
        pytest.approx(1.0)


def test_count_flops_of_a_matmul():
    a = torch.empty((3, 5))
    assert costs.count_flops(lambda: torch.empty((3, 4)) @
                             torch.empty((4, 5))) == 2 * 3 * 4 * 5
    del a


def test_poly_flops_fits_exactly_and_checks():
    fit = costs.PolyFlops([lambda t: t, lambda t: t * t],
                          lambda t: 6 * t + 2 * t * t, [(1,), (2,), (5,)])
    assert fit(100) == 600 + 20000
    with pytest.raises(ValueError):
        costs.PolyFlops([lambda t: t], lambda t: t * t, [(1,), (3,)])


def test_s1_flop_model_matches_a_direct_count(tiny_s1):
    from evbench.drivers import gpt_s1

    cfg, _ = tiny_s1
    model = gpt_s1.flop_model(cfg)
    shapes = ref.param_shapes(cfg)

    def direct():
        P = {k: torch.empty(v, requires_grad=True) for k, v in shapes.items()}
        out = ref.loss(P, cfg, torch.zeros((1, 21), dtype=torch.long),
                       torch.tensor([21]), torch.zeros((1, 34),
                                                       dtype=torch.long),
                       torch.tensor([34]), torch.empty((1, 21, 1024)))
        torch.autograd.grad(out, list(P.values()), allow_unused=True)
    assert model(21, 34) == costs.count_flops(direct)
    # six flops a parameter a token, plus attention: a sanity bound
    n_layer_params = 4 * 64 * 64 + 2 * 64 * 128
    assert model(21, 34) > 6 * cfg["n_layer"] * n_layer_params * 55


def test_s2_flop_model_grows_with_the_clip(tiny_s2):
    from evbench.drivers import sovits_s2

    cfg, _ = tiny_s2
    model = sovits_s2.flop_model(cfg)
    a, b, c = model(40, 8), model(80, 8), model(80, 16)
    assert 0 < a < b < c
    assert math.isclose(model(40, 8), model(40, 8))
