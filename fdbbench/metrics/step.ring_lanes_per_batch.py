"""Launches of the presharded lanes' ring walk (csrc/ring.cu
``ring_lanes_kernel``) a batch in the traced slice: one a query kind
(point reads, range reads) a txn slice the router made, on a config
with range writes. Nothing to read where the kernel does not launch:
one resolver, a lane fleet off the card, or a program without it."""


def read(ctx):
    launches = ctx.trace.kernel(("ring_lanes_kernel",))[0]
    if not launches or not ctx.batches:
        return None
    return launches / ctx.batches
