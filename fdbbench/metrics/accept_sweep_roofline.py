"""accept_sweep's share of its roofline (kernels/accept_sweep.py)."""


def read(ctx):
    return ctx.roofline("accept_sweep")
