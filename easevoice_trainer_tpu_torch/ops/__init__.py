"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch twins."""
from .attention import decode_attention, prefill_attention
from .mrf import mrf_conv

KERNELS = (prefill_attention, decode_attention, mrf_conv)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
