"""``fdb_accept_sweep`` (csrc/accept.cu): greedy acceptance over a dense
conflict relation, a pack launch and a sweep launch per call, on the
plain routes (the fast variant, the resolver lanes).

Its bytes and operations are the frozen ``sweep_cost`` over the batch
width and the accepted transactions: every call sweeps ``txns`` rows,
and the traced slice's accepted transactions are spread over its calls.
"""

from fdbbench import roofline

PARTS = ("accept_pack_kernel", "accept_sweep_kernel")
# a launch of this means fused_accept's own sweep shares the trace
OTHERS = ("accept_ring_kernel",)


def costs(ctx):
    launches, _ = ctx.trace.kernel(PARTS)
    if not launches:
        return []
    return [roofline.sweep_cost(ctx.params["txns"],
                                ctx.accepted / launches)]
