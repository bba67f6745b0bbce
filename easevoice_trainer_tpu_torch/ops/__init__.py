"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch twins."""
from .attention import decode_attention, encoder_attention, \
    prefill_attention, prefill_attention_bwd, self_attention
from .mrf import mrf_conv, mrf_conv_bwd_data, mrf_conv_bwd_weight

KERNELS = (prefill_attention, decode_attention, mrf_conv, mrf_conv_bwd_data,
           mrf_conv_bwd_weight, prefill_attention_bwd, encoder_attention)
# the kernels with a bf16 instance (the fine-tunes under is_half), which
# counts its launches in ``launches_bf16``
BF16_KERNELS = (prefill_attention, prefill_attention_bwd, mrf_conv,
                mrf_conv_bwd_data, mrf_conv_bwd_weight)
# the kernels with dropout instances (the s1 fine-tune with dropout > 0),
# which count in ``launches_dropout`` and ``launches_dropout_bf16``
DROPOUT_KERNELS = (prefill_attention, prefill_attention_bwd)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in BF16_KERNELS:
        fn.launches_bf16 = 0
    for fn in DROPOUT_KERNELS:
        fn.launches_dropout = fn.launches_dropout_bf16 = 0
    encoder_attention.launches_dk32 = 0


def launch_counts() -> dict:
    """Launches of each kernel; K1's dk-32 encoder instance (CT-punc) is
    ``encoder_attention_dk32``, apart from the dk-64 ``encoder_attention``,
    each bf16 instance ``<name>_bf16`` and each dropout instance
    ``<name>_dropout`` (fp32) and ``<name>_dropout_bf16``."""
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    counts["encoder_attention_dk32"] = encoder_attention.launches_dk32
    for fn in BF16_KERNELS:
        counts[fn.__name__ + "_bf16"] = fn.launches_bf16
    for fn in DROPOUT_KERNELS:
        counts[fn.__name__ + "_dropout"] = fn.launches_dropout
        counts[fn.__name__ + "_dropout_bf16"] = fn.launches_dropout_bf16
    return counts
