"""K5 (the attention backward: its row-sum, dK/dV and dQ kernels, group
``k5`` of ``kernels/``) in the traced micro-batches, as ``k1_roofline``
reads K1."""
import os

from evbench import common, costs

_K1 = common.load_module(os.path.join(os.path.dirname(__file__),
                                      "k1_roofline.py"),
                         "evbench_metric_k1_roofline")


def read(ctx):
    return _K1.read(ctx, "k5", costs.attention_bwd_cost)
