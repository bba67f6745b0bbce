"""Host ms of one s2 step's load: ``S2Dataset.load_item`` for its rows
(the wav read and its spectrogram, the SSL features), ``collate_s2``, the
trainer's host-to-device copy and the step's draws, timed by the
benchmark's loop, averaged over the window's steps."""
import os

from evbench import common

_S1 = common.load_module(os.path.join(os.path.dirname(__file__),
                                      "s1_batch_load_ms.py"),
                         "evbench_metric_s1_batch_load_ms")
read = _S1.read
