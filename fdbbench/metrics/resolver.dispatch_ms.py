"""Milliseconds a batch spends in the resolver's dispatch (pack, route,
copy and enqueue of the step), from the program's device profile
(``dispatch_wall_ms``) over the traced slice."""


def read(ctx):
    n = ctx.profile.get("batches_live", 0)
    return ctx.profile["dispatch_wall_ms"] / n if n else None
