"""Model FLOPs of the window's s2 steps (G and D, forward and backward, of
each clip at its unpadded frames and the fixed segment, counted over the
plain reference) over the window's seconds at the chip's bf16 peak, in %."""
import os

from evbench import common

_S1 = common.load_module(os.path.join(os.path.dirname(__file__),
                                      "s1_mfu.py"), "evbench_metric_s1_mfu")
read = _S1.read
