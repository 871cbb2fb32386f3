"""The share of the traced slice in which no kernel, copy or memset ran
on the card."""


def read(ctx):
    if ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
