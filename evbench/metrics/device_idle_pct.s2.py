"""The share of the traced s2 window in which no kernel, copy or set ran
on the card, in %."""
import os

from evbench import common

_S1 = common.load_module(os.path.join(os.path.dirname(__file__),
                                      "device_idle_pct.s1.py"),
                         "evbench_metric_device_idle_pct_s1")
read = _S1.read
