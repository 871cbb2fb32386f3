"""``fdb_fused_accept`` (csrc/accept.cu): the ring check, the pair tiles
and the sweep of the full step's accept decision, one launch of each
per call.

Its bytes are the tensors it reads and the accepted bits it writes; its
operations are the frozen ``accept_ops`` on a sampled call's own inputs:
the batch, and the ring as it stood before the call. ``accept_ops``
counts the work of the admissible transactions, which only the step
knows; the sample gives it those the call accepted, a subset, so the
count is a lower bound and the share never reads high.
"""

import torch

from fdbbench import roofline

PARTS = ("accept_ring_kernel", "accept_pairs_kernel", "accept_sweep_kernel")
# a launch of these means a standalone accept_sweep shares the trace
OTHERS = ("accept_pack_kernel",)


def costs(ctx):
    out = []
    for s in ctx.samples:
        b = roofline.Batch(s["blobs"], s["counts"], s["rv"], s["base"],
                           ctx.params, s["ring"].ring_v.device)
        a0 = torch.from_numpy(s["accepted"]).to(b.rv.device)
        out.append((roofline.accept_bytes(s["ring"], b, a0),
                    roofline.accept_ops(s["ring"], b, a0)))
    return out
