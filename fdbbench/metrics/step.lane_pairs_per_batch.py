"""Launches of the presharded lanes' pair kernel (csrc/lanes.cu
``lane_pairs_kernel``) a batch in the traced slice: one a txn slice the
router made. Nothing to read where the kernel does not launch: one
resolver, or a program without it."""


def read(ctx):
    launches = ctx.trace.kernel(("lane_pairs_kernel",))[0]
    if not launches or not ctx.batches:
        return None
    return launches / ctx.batches
