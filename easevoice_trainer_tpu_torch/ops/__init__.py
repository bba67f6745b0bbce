"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch twins."""
from .attention import decode_attention, encoder_attention, \
    prefill_attention, prefill_attention_bwd, self_attention
from .mrf import mrf_conv, mrf_conv_bwd_data, mrf_conv_bwd_weight

KERNELS = (prefill_attention, decode_attention, mrf_conv, mrf_conv_bwd_data,
           mrf_conv_bwd_weight, prefill_attention_bwd, encoder_attention)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    encoder_attention.launches_dk32 = 0


def launch_counts() -> dict:
    """Launches of each kernel; K1's dk-32 encoder instance (CT-punc) is
    ``encoder_attention_dk32``, apart from the dk-64 ``encoder_attention``."""
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    counts["encoder_attention_dk32"] = encoder_attention.launches_dk32
    return counts
