"""Model FLOPs of the window's s1 micro-batches (forward and backward of
each utterance at its unpadded lengths, counted over the plain reference)
over the window's seconds at the chip's bf16 peak, in %."""
from evbench import costs


def read(ctx):
    flops = sum(s["flops"] for s in ctx.window["steps"])
    if not flops:
        return None
    return 100.0 * flops / (ctx.window["seconds"]
                            * costs.PEAKS["bf16_flops_per_s"])
