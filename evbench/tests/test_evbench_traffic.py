"""The traffic is a function of its file and the seed."""
import numpy as np
import pytest

from evbench import common, traffic


@pytest.mark.parametrize("name", ["s1_long_b32", "s1_sliced_b32",
                                  "s2_sliced_b32", "s2_long_b32"])
def test_same_seed_same_traffic(name):
    spec = common.traffic_file(name)
    a, b = traffic.items(spec, 2 ** 40 + 5), traffic.items(spec, 2 ** 40 + 5)
    assert [(x.name, x.seconds, x.phonemes.tolist()) for x in a] == \
        [(x.name, x.seconds, x.phonemes.tolist()) for x in b]


@pytest.mark.parametrize("name", ["s1_long_b32", "s2_sliced_b32"])
def test_another_seed_same_sizes_other_order(name):
    spec = common.traffic_file(name)
    a, b = traffic.items(spec, 11), traffic.items(spec, 12)
    assert [x.seconds for x in a] != [x.seconds for x in b]
    # the same (duration, phonemes) pairs: the same padded shapes
    assert sorted((x.seconds, len(x.phonemes)) for x in a) == \
        sorted((x.seconds, len(x.phonemes)) for x in b)
    assert any(not np.array_equal(x.phonemes, y.phonemes)
               for x, y in zip(a, b))


def test_sizes_follow_the_file():
    spec = common.traffic_file("s1_long_b32")
    secs = [x.seconds for x in traffic.items(spec, 3)]
    assert len(secs) == spec["count"]
    assert spec["seconds"]["low"] <= min(secs)
    assert max(secs) <= spec["seconds"]["high"]
    rates = [len(x.phonemes) / x.seconds for x in traffic.items(spec, 3)]
    assert 7.9 <= min(rates) and max(rates) <= 12.1


def test_large_seeds():
    spec = common.traffic_file("s2_long_b32")
    assert len(traffic.items(spec, 2 ** 63 + 12345)) == spec["count"]
    assert common.sub_seed(2 ** 40, 1) != common.sub_seed(2 ** 40 + 1, 1)


def test_log_uniform_quantiles():
    q = traffic.quantiles({"dist": "log_uniform", "low": 4, "high": 12}, 4)
    assert np.allclose(np.log(q[1:] / q[:-1]), np.log(3) / 4)
