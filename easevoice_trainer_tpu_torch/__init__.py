"""EaseVoice Trainer on PyTorch + CUDA: the port of ``easevoice_trainer_tpu``.

This first slice covers voice-clone synthesis (reference clip -> AR GPT ->
VITS decoder -> wav) on one NVIDIA H100, with three hand-written Hopper
kernels under ``csrc/``: prefill attention (K1), decode attention (K2) and
the MRF ResBlock conv (K3).  Host-side code without JAX (text frontend,
segmentation, audio IO, checkpoint name rules) is imported from
``easevoice_trainer_tpu``; nothing here imports JAX.
"""

__version__ = "0.1.0"
