"""Ring lanes: each query against the ring of recent committed range writes.

The counterpart of ``foundationdb_tpu/ops/pallas_ring.py``. Ref
semantics: the ring walk of ConflictSet::detectConflicts
(fdbserver/SkipList.cpp) — does any write newer than my read version
intersect my read range.

:func:`ring_hits` launches the CUDA kernel of ``csrc/ring.cu`` for CUDA
tensors and runs :func:`ring_hits_plain` for CPU tensors; it never falls
back from the kernel to the plain version. :func:`ring_hits_lanes` is
the same check for the n lanes of the presharded step, each lane's
query slots against its own ring; on the CPU it runs
:func:`ring_hits_plain` over the lane axis.
"""

import torch

from foundationdb_tpu_torch.ops import _kernels
from foundationdb_tpu_torch.ops.intervals import point_in, ranges_overlap


def ring_hits_plain(qlo, qhi, rv, ring_b, ring_e, ring_v, ring_mask,
                    point_mode=False):
    """The broadcast form: [..., Q, KR] overlap with a W-limb compare
    inside. Leading dimensions, if any, pair queries with their own ring
    (the presharded step's lanes)."""
    b, e = ring_b[..., None, :, :], ring_e[..., None, :, :]
    if point_mode:
        ov = point_in(qlo[..., :, None, :], b, e)
    else:
        ov = ranges_overlap(qlo[..., :, None, :], qhi[..., :, None, :], b, e)
    newer = ring_v[..., None, :] > rv[..., :, None]
    return torch.any(ov & newer & ring_mask[..., None, :], dim=-1)


def ring_hits(qlo, qhi, rv, ring_b, ring_e, ring_v, ring_mask,
              point_mode=False):
    """Per-query ring-conflict bits.

    qlo/qhi: int64[Q, W] query begins/ends (qhi ignored in point mode);
    rv: int64[Q] read versions; ring_b/e: int64[KR, W]; ring_v:
    int64[KR]; ring_mask: bool[KR]. Returns bool[Q]: query q hits some
    live ring write newer than rv[q].
    """
    if qlo.device.type == "cpu":
        return ring_hits_plain(qlo, qhi, rv, ring_b, ring_e, ring_v,
                               ring_mask, point_mode)
    Q, W = qlo.shape
    KR = ring_v.shape[0]
    _kernels.check_args(
        "ring_hits", qlo.device, W,
        {"qlo": (qlo, (Q, W)), "qhi": (qhi, (Q, W)), "rv": (rv, (Q,)),
         "ring_b": (ring_b, (KR, W)), "ring_e": (ring_e, (KR, W)),
         "ring_v": (ring_v, (KR,))},
        {"ring_mask": (ring_mask, (KR,))})
    args = [t.contiguous() for t in (qlo, qhi, rv, ring_b, ring_e, ring_v,
                                     ring_mask)]
    out = torch.empty((Q,), dtype=torch.bool, device=qlo.device)
    lib = _kernels.lib("ring")
    with torch.cuda.device(qlo.device):
        rc = lib.fdb_ring_hits(
            *[t.data_ptr() for t in args], Q, KR, W, int(point_mode),
            out.data_ptr(), _kernels.stream_of(qlo),
        )
    _kernels.check(rc, "ring_hits kernel launch")
    _kernels.count("ring_hits")
    return out


def ring_slot_hits(qlo, qhi, rv, mask, ring, point_mode, use_kernel=False):
    """bool[T, S]: ring hits of S masked query slots per txn.

    qlo/qhi: int64[T, S, W]; rv: int64[T]; mask: bool[T, S]; ring: the
    (ring_b, ring_e, ring_v, ring_mask) tuple. ``use_kernel`` picks
    :func:`ring_hits` over :func:`ring_hits_plain` (never for S == 0)."""
    T, S, W = qlo.shape
    rv_q = rv[:, None].expand(T, S).reshape(-1)
    fn = ring_hits if use_kernel and S else ring_hits_plain
    hit = fn(qlo.reshape(T * S, W), qhi.reshape(T * S, W), rv_q, *ring,
             point_mode=point_mode)
    return hit.reshape(T, S) & mask


def ring_hits_lanes(qlo, qhi, rv, ring_b, ring_e, ring_v, ring_mask,
                    point_mode=False):
    """Per-slot ring-conflict bits of n lanes, each against its own ring.

    qlo/qhi: int64[n, Q, W] query begins/ends (qhi ignored in point
    mode); rv: int64[n, Q] read versions; ring_b/e: int64[n, KR, W];
    ring_v: int64[n, KR]; ring_mask: bool[n, KR]. Returns bool[n, Q]:
    slot q of lane j hits some live write of lane j's ring newer than
    rv[j, q]. CUDA tensors launch csrc/ring.cu's ``ring_lanes_kernel``;
    CPU tensors run :func:`ring_hits_plain`.
    """
    n, Q, W = qlo.shape
    KR = ring_v.shape[1]
    _kernels.check_args(
        "ring_hits_lanes", qlo.device, W,
        {"qlo": (qlo, (n, Q, W)), "qhi": (qhi, (n, Q, W)),
         "rv": (rv, (n, Q)), "ring_b": (ring_b, (n, KR, W)),
         "ring_e": (ring_e, (n, KR, W)), "ring_v": (ring_v, (n, KR))},
        {"ring_mask": (ring_mask, (n, KR))})
    if qlo.device.type == "cpu":
        return ring_hits_plain(qlo, qhi, rv, ring_b, ring_e, ring_v,
                               ring_mask, point_mode)
    args = [t.contiguous() for t in (qlo, qhi, rv, ring_b, ring_e, ring_v,
                                     ring_mask)]
    out = torch.empty((n, Q), dtype=torch.bool, device=qlo.device)
    lib = _kernels.lib("ring")
    with torch.cuda.device(qlo.device):
        rc = lib.fdb_ring_hits_lanes(
            *[t.data_ptr() for t in args], n, Q, KR, W, int(point_mode),
            out.data_ptr(), _kernels.stream_of(qlo),
        )
    _kernels.check(rc, "ring_hits_lanes kernel launch")
    _kernels.count("ring_hits_lanes")
    return out
