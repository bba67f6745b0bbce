"""EaseVoice Trainer on PyTorch + CUDA: the port of ``easevoice_trainer_tpu``.

Slice 1 covers voice-clone synthesis (reference clip -> AR GPT -> VITS
decoder -> wav), slice 2 the s2 SoVITS GAN fine-tune (``train/``), both on
one NVIDIA H100, with hand-written Hopper kernels under ``csrc/``: prefill
attention (K1), decode attention (K2), the MRF ResBlock conv (K3) and its
backward (K4).  The host-side code (text frontend, segmentation, audio IO,
the s2 data loader, checkpoint name rules, the mel filterbank) is a copy of
the JAX package's, under the same module names; nothing here imports JAX or
``easevoice_trainer_tpu``.
"""

__version__ = "0.1.0"
