"""Device milliseconds a batch takes: the union of the card's kernel,
copy and memset intervals in the traced slice, over the batches
dispatched in it."""


def read(ctx):
    if not ctx.batches or ctx.trace.busy_s <= 0:
        return None
    return ctx.trace.busy_s * 1e3 / ctx.batches
