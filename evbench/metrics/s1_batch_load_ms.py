"""Host ms of one s1 micro-batch's load: ``GPTDataset.load_item`` for its
rows, ``collate_gpt`` and the trainer's host-to-device copy, timed by the
benchmark's loop, averaged over the window's micro-batches."""


def read(ctx):
    steps = ctx.window["steps"]
    if not steps:
        return None
    return 1e3 * sum(s["load_s"] for s in steps) / len(steps)
