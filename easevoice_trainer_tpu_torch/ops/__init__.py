"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch twins."""
from .attention import decode_attention, prefill_attention
from .mrf import mrf_conv, mrf_conv_bwd_data, mrf_conv_bwd_weight

KERNELS = (prefill_attention, decode_attention, mrf_conv, mrf_conv_bwd_data,
           mrf_conv_bwd_weight)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
