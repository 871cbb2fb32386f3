"""The accept step: ring check + intra-batch conflicts + greedy acceptance.

The counterpart of ``foundationdb_tpu/ops/pallas_scan.py``.
:func:`fused_accept` takes ``a0`` (each txn admissible after the history
lanes that stay in torch) and returns the accepted bits. For CUDA tensors
it launches the three kernels of ``csrc/accept.cu``; for CPU tensors it
runs :func:`fused_accept_plain`. It never falls back from the kernel to
the plain version.

:func:`conflict_matrix` and :func:`sweep_accept` are the plain routes
of ops/conflict.py when the fused kernel is off: ``sweep_accept`` takes
a dense O and launches csrc/accept.cu's ``fdb_accept_sweep`` for CUDA
tensors, and runs :func:`jacobi_accept` for CPU tensors. Greedy
sequential acceptance is the unique fixpoint of the Jacobi map
a ← a0 ∧ ¬(a·O) (induction on txn index), so every route gives the same
bits; the sweep computes it on the card with no host round trip, which
the Jacobi loop makes every iteration and no CUDA graph could hold.
"""

import torch

from foundationdb_tpu_torch.ops import _kernels
from foundationdb_tpu_torch.ops.intervals import point_in, ranges_overlap
from foundationdb_tpu_torch.ops.ring import ring_slot_hits

MAX_TXNS = 1024  # csrc/accept.cu FDB_MAX_TXNS: 32 words, staged by the sweep
# csrc/accept.cu FDB_SWEEP_MAX_WORDS: the widest relation the sweep takes
MAX_SWEEP_TXNS = 1024 * 32

# lane flags of csrc/accept.cu
LANE_PP, LANE_P_RR, LANE_RW_P, LANE_RW_RR = 1, 2, 4, 8
LANE_PR_RING, LANE_RR_RING = 16, 32

WRITE_SENTINEL = 0xFFFFFFFF  # hash of a masked point-write slot
READ_SENTINEL = 0xFFFFFFFE  # hash of a masked point-read slot


def conflict_matrix(batch, params):
    """bool[T, T] O[w, r]: an accepted earlier txn w kills txn r because
    w's writes meet r's reads. Strictly upper-triangular (w < r), both
    txns live. The four lanes of ops/conflict.py's torch route."""
    T = params.txns
    dev = batch.rv.device
    O = torch.zeros((T, T), dtype=torch.bool, device=dev)
    if params.point_writes and params.point_reads:
        wh = torch.where(batch.pw_mask, batch.pw_hash, WRITE_SENTINEL)
        rh = torch.where(batch.pr_mask, batch.pr_hash, READ_SENTINEL)
        eq = wh[:, :, None, None] == rh[None, None, :, :]  # [T1, PW, T2, PR]
        O |= eq.any(dim=3).any(dim=1)
    if params.point_writes and params.range_reads:
        inr = point_in(batch.pw_key[:, :, None, None, :],
                       batch.rr_b[None, None], batch.rr_e[None, None])
        m = batch.pw_mask[:, :, None, None] & batch.rr_mask[None, None]
        O |= (inr & m).any(dim=3).any(dim=1)
    if params.range_writes and params.point_reads:
        inr = point_in(batch.pr_key[None, None],
                       batch.rw_b[:, :, None, None, :],
                       batch.rw_e[:, :, None, None, :])  # [T1, RW, T2, PR]
        m = batch.rw_mask[:, :, None, None] & batch.pr_mask[None, None]
        O |= (inr & m).any(dim=3).any(dim=1)
    if params.range_writes and params.range_reads:
        ov = ranges_overlap(batch.rr_b[None, None], batch.rr_e[None, None],
                            batch.rw_b[:, :, None, None, :],
                            batch.rw_e[:, :, None, None, :])
        m = batch.rw_mask[:, :, None, None] & batch.rr_mask[None, None]
        O |= (ov & m).any(dim=3).any(dim=1)
    upper = torch.ones((T, T), dtype=torch.bool, device=dev).triu(1)
    return O & upper & batch.txn_mask[:, None] & batch.txn_mask[None, :]


def jacobi_accept(a0, O):
    """Greedy acceptance as the fixpoint of a ← a0 ∧ ¬(a·O).

    One [T] x [T, T] product per iteration, as many as the longest
    conflict chain. float32 keeps the 0/1 sums exact (T <= 2^24)."""
    Of = O.to(torch.float32)
    a = a0
    while True:
        killed = (a.to(torch.float32) @ Of) > 0.5
        a_new = a0 & ~killed
        if torch.equal(a_new, a):
            return a_new
        a = a_new


def sweep_accept(a0, O):
    """Greedy acceptance over a strictly upper-triangular conflict
    relation O (bool[T, T], O[w, r]: accepted w kills r): bool[T].

    For CUDA tensors the two launches of ``fdb_accept_sweep`` (O packed
    into a bitset by warp ballots, then the word-by-word sweep); for CPU
    tensors :func:`jacobi_accept`. Never falls back from one to the
    other."""
    if a0.device.type == "cpu":
        return jacobi_accept(a0, O)
    T = a0.shape[0]
    if T > MAX_SWEEP_TXNS:
        raise ValueError(f"accept_sweep takes txns <= {MAX_SWEEP_TXNS}, got {T}")
    _kernels.check_args("accept_sweep", a0.device, None, {},
                        {"a0": (a0, (T,)), "O": (O, (T, T))})
    a0, O = a0.contiguous(), O.contiguous()
    obits = torch.empty((T * ((T + 31) // 32),), dtype=torch.int32,
                        device=a0.device)
    accepted = torch.empty((T,), dtype=torch.bool, device=a0.device)
    lib = _kernels.lib("accept")
    with torch.cuda.device(a0.device):
        rc = lib.fdb_accept_sweep(a0.data_ptr(), O.data_ptr(), T,
                                  obits.data_ptr(), accepted.data_ptr(),
                                  _kernels.stream_of(a0))
    _kernels.check(rc, "accept_sweep kernel launch")
    _kernels.count("accept_sweep")
    return accepted


def _lanes(state, batch, params):
    """Lane gating of the fused step: a side is live iff its params gate
    and its array width are both nonzero (packers may zero-width lanes a
    workload never uses)."""
    PRn, PWn = batch.pr_hash.shape[1], batch.pw_hash.shape[1]
    RRn, RWn = batch.rr_b.shape[1], batch.rw_b.shape[1]
    KR = state.ring_v.shape[0]
    p = params
    return {
        LANE_PP: bool(p.point_writes and p.point_reads and PWn and PRn),
        LANE_P_RR: bool(p.point_writes and p.range_reads and PWn and RRn),
        LANE_RW_P: bool(p.range_writes and p.point_reads and RWn and PRn),
        LANE_RW_RR: bool(p.range_writes and p.range_reads and RWn and RRn),
        LANE_PR_RING: bool(p.range_writes and p.point_reads and PRn and KR),
        LANE_RR_RING: bool(p.range_writes and p.range_reads and RRn and KR),
    }


def ring_kill_plain(state, batch, params):
    """bool[T]: a live point or range read of the txn hits a live ring
    write newer than its read version."""
    lanes = _lanes(state, batch, params)
    kill = torch.zeros((params.txns,), dtype=torch.bool, device=batch.rv.device)
    ring = (state.ring_b, state.ring_e, state.ring_v, state.ring_mask)
    if lanes[LANE_PR_RING]:
        kill |= ring_slot_hits(batch.pr_key, batch.pr_key, batch.rv,
                               batch.pr_mask, ring, True).any(dim=1)
    if lanes[LANE_RR_RING]:
        kill |= ring_slot_hits(batch.rr_b, batch.rr_e, batch.rv,
                               batch.rr_mask, ring, False).any(dim=1)
    return kill


def fused_accept_plain(state, batch, params, a0):
    """The plain PyTorch version: ring kills, the O matrix of the four
    lanes, and the Jacobi fixpoint."""
    kill = ring_kill_plain(state, batch, params)
    return jacobi_accept(a0 & ~kill, conflict_matrix(batch, params))


def fused_accept(state, batch, params, a0):
    """The accept decision: bool[T] accepted bits (see module doc)."""
    if a0.device.type == "cpu":
        return fused_accept_plain(state, batch, params, a0)
    T, W = params.txns, params.key_width
    if T > MAX_TXNS:
        raise ValueError(f"fused_accept takes txns <= {MAX_TXNS}, got {T}")
    b = batch
    PR, PW = b.pr_hash.shape[1], b.pw_hash.shape[1]
    RR, RW = b.rr_b.shape[1], b.rw_b.shape[1]
    KR = state.ring_v.shape[0]
    _kernels.check_args(
        "fused_accept", a0.device, W,
        {"rv": (b.rv, (T,)), "pw_hash": (b.pw_hash, (T, PW)),
         "pw_key": (b.pw_key, (T, PW, W)), "pr_hash": (b.pr_hash, (T, PR)),
         "pr_key": (b.pr_key, (T, PR, W)), "rr_b": (b.rr_b, (T, RR, W)),
         "rr_e": (b.rr_e, (T, RR, W)), "rw_b": (b.rw_b, (T, RW, W)),
         "rw_e": (b.rw_e, (T, RW, W)), "ring_b": (state.ring_b, (KR, W)),
         "ring_e": (state.ring_e, (KR, W)), "ring_v": (state.ring_v, (KR,))},
        {"a0": (a0, (T,)), "pw_mask": (b.pw_mask, (T, PW)),
         "pr_mask": (b.pr_mask, (T, PR)), "rr_mask": (b.rr_mask, (T, RR)),
         "rw_mask": (b.rw_mask, (T, RW)),
         "ring_mask": (state.ring_mask, (KR,))})
    flags = sum(bit for bit, on in _lanes(state, batch, params).items() if on)
    qhit = torch.empty((T * (PR + RR),), dtype=torch.uint8, device=a0.device)
    return launch_fused_accept(state, batch, params, a0, flags, qhit)


def launch_fused_accept(state, batch, params, a0, flags, qhit):
    """Launch csrc/accept.cu with these lane ``flags`` on tensors
    :func:`fused_accept` has checked; ``qhit`` (uint8[T * (PR + RR)])
    receives each read slot's ring hit. Returns the accepted bits."""
    T, W = params.txns, params.key_width
    b = batch
    PR, PW = b.pr_hash.shape[1], b.pw_hash.shape[1]
    RR, RW = b.rr_b.shape[1], b.rw_b.shape[1]
    KR = state.ring_v.shape[0]
    args = [t.contiguous() for t in (
        a0, b.rv, b.pw_hash, b.pw_mask, b.pw_key, b.pr_hash, b.pr_mask,
        b.pr_key, b.rr_b, b.rr_e, b.rr_mask, b.rw_b, b.rw_e, b.rw_mask,
        state.ring_b, state.ring_e, state.ring_v, state.ring_mask,
    )]
    dev = a0.device
    obits = torch.empty((T * ((T + 31) // 32),), dtype=torch.int32,
                        device=dev)
    accepted = torch.empty((T,), dtype=torch.bool, device=dev)
    lib = _kernels.lib("accept")
    with torch.cuda.device(dev):
        rc = lib.fdb_fused_accept(
            *[t.data_ptr() for t in args], T, PR, PW, RR, RW, KR, W,
            flags, qhit.data_ptr(), obits.data_ptr(),
            accepted.data_ptr(), _kernels.stream_of(a0),
        )
    _kernels.check(rc, "fused_accept kernel launch")
    _kernels.count("fused_accept")
    return accepted
