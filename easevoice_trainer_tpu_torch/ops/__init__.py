"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch twins."""
from .attention import decode_attention, encoder_attention, \
    prefill_attention, prefill_attention_bwd, self_attention
from .mrf import mrf_conv, mrf_conv_bwd_data, mrf_conv_bwd_weight

KERNELS = (prefill_attention, decode_attention, mrf_conv, mrf_conv_bwd_data,
           mrf_conv_bwd_weight, prefill_attention_bwd, encoder_attention)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
