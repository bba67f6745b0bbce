"""K3 (the ResBlock conv forward) with K4-dx and K4-dW (its data and
weight gradients) in the traced s2 steps: the summed least time of their
calls over the summed device time of their kernels (group ``mrf`` of
``kernels/``), in %."""
from evbench import costs, evtrace


def read(ctx):
    if ctx.trace is None:
        return None
    device = ctx.trace.kernel_seconds(evtrace.kernels_of("mrf"))
    if device <= 0:
        return None
    dtype = ctx.cfg["compute_dtype"]
    least = 0.0
    for step in ctx.trace.steps:
        for b, ch, t, k, residual in step["mrf"]:
            for ops, nbytes in costs.mrf_conv_costs(
                    b, ch, t, k, residual, costs.elem_bytes(dtype)).values():
                least += costs.least_seconds(ops, nbytes,
                                             costs.flops_per_s(dtype))
    return 100.0 * least / device
