"""Fixtures of the benchmark's tests: the repository root on the path, the
card decided inside a fixture (never at import), tiny configurations for
CPU runs."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """Skips unless a CUDA card is present; decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the port's kernels have no CPU "
                    "mode there)")
    return torch.device("cuda")


@pytest.fixture
def tiny_s1():
    """The s1 configuration and the long traffic, cut to a CPU test's size
    (widths too: this never runs on the card)."""
    from evbench import common

    cfg = common.load_json(os.path.join(common.HERE, "configs",
                                        "gpt_s1_v2.json"))
    cfg.update(hidden_dim=64, embedding_dim=64, head=4, linear_units=128,
               n_layer=2, trace_steps=2)
    traffic = dict(common.traffic_file("s1_long_b32"), count=24,
                   batch_size=4,
                   seconds={"dist": "uniform", "low": 1.0, "high": 3.0})
    return cfg, traffic


@pytest.fixture
def tiny_s2():
    from evbench import common

    cfg = common.load_json(os.path.join(common.HERE, "configs",
                                        "sovits_s2_v2.json"))
    cfg = copy.deepcopy(cfg)
    cfg["model"].update(inter_channels=16, hidden_channels=32,
                        filter_channels=64, n_layers=2,
                        upsample_initial_channel=32, gin_channels=32,
                        ssl_dim=64)
    cfg["train"]["segment_size"] = 2560
    traffic = dict(common.traffic_file("s2_sliced_b32"), count=12,
                   batch_size=4,
                   seconds={"dist": "uniform", "low": 1.0, "high": 2.0})
    return cfg, traffic
