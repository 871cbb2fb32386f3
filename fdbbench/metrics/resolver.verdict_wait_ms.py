"""Milliseconds a batch's statuses are waited for on the host, from the
program's device profile (``verdict_reduce_wall_ms``) over the traced
slice."""


def read(ctx):
    n = ctx.profile.get("batches_live", 0)
    return ctx.profile["verdict_reduce_wall_ms"] / n if n else None
