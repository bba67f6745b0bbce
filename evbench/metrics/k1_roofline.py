"""K1 (the attention forward with its lse) in the traced micro-batches:
the least time of its calls (operations over the visible pairs at the
peak, or bytes at the memory's rate) over the device time of the kernels
the attention forward launches (group ``k1`` of ``kernels/``), in %."""
from evbench import costs, evtrace


def least(ctx, cost):
    dtype = ctx.cfg["compute_dtype"]
    total = 0.0
    for s in ctx.trace.steps:
        b, t = len(s["x_lens"]), s["x_len"] + s["y_len"]
        pairs = costs.visible_pairs(s["x_len"], s["y_len"], s["x_lens"],
                                    s["y_lens"])
        ops, nbytes = cost(b, t, s["heads"], s["dk"], pairs,
                           costs.elem_bytes(dtype))
        total += s["layers"] * costs.least_seconds(
            ops, nbytes, costs.flops_per_s(dtype))
    return total


def read(ctx, group="k1", cost=costs.attention_fwd_cost):
    if ctx.trace is None:
        return None
    device = ctx.trace.kernel_seconds(evtrace.kernels_of(group))
    if device <= 0:
        return None
    return 100.0 * least(ctx, cost) / device
