"""The resolver's conflict-detection step on PyTorch tensors.

Reference semantics (fdbserver/Resolver.actor.cpp + fdbserver/SkipList.cpp,
ConflictSet::detectConflicts): a resolver keeps the last ~5s of committed
write ranges; a transaction commits iff none of its read conflict ranges
intersects a write range committed after its read version — including
writes of earlier transactions *in the same batch* that were themselves
accepted.

The port of ``foundationdb_tpu/ops/conflict.py``, held to it bit for
bit: the same four history structures, the same lanes, the same
statuses and the same state after every batch. Three layouts:

- one device, flat ring (:func:`resolve_batch`), with the CUDA kernels;
- one device, a bucket-partitioned ring (``ring_partition_bits > 0``):
  2^PB sub-rings keyed by the begin key's top bucket bits; a query
  checks its two end partitions' sub-rings exactly and a per-partition
  version max for the partitions between them;
- n resolver lanes (:func:`resolve_batch` with ``n_lanes``, and
  :func:`resolve_batch_presharded`). The JAX package runs one lane per
  device of a ``shard_map`` mesh; here the lanes are a leading tensor
  axis of one device's state. The state keeps the mesh's global shapes
  (``ht`` of ``n << HB``, ring fields of ``n * KR``, ``ring_head`` of
  ``[n]``, the coarse summaries once), viewed ``[n, ...]`` inside the
  step. A ``psum`` of bools becomes an ``any`` over the lane axis and a
  ``pmax`` of the replicated summaries a single scatter-max into the one
  copy, which every lane shares.

The kernels run only on the single-device flat ring, as in the JAX
package (which turns its Pallas kernels off for lanes and for the
partitioned ring).

1. **Point-version hash table** ``ht[2^HB]``: max commit-version offset
   per key-hash bucket (scatter-max on write, gather on read).
2. **Range ring** of the last ``KR`` committed range writes, checked
   exactly (ops/ring.py).
3. **Coarse interval summary** ``(range_L, range_R)[C]`` absorbing range
   writes evicted from the ring: a query [qlo, qhi] can only meet a
   stored interval if ``min(prefmax_L[qhi], sufmax_R[qlo])`` exceeds its
   read version — conservative, never a miss.
4. **Coarse point summary** ``point_coarse[C]`` with a per-batch sparse
   table for range reads.

Intra-batch ordering is greedy sequential acceptance over the conflict
relation O[w, r] (ops/accept.py): the fused CUDA kernel computes it
directly; the plain routes build O in torch and sweep it on the card
(``sweep_accept``), or take the Jacobi fixpoint a ← a0 ∧ ¬(a·O) on the
CPU.

Representation: uint32 quantities (limbs, hashes, versions) are int64
tensors with zero extension (ops/intervals.py); bucket indices and the
ring head are int32; masks bool. The state is updated in place, where
the JAX package donated its buffers to the next step. Versions are
offsets from a host-held base (core/versions.py); 0 means "no write".
"""

import threading
from typing import NamedTuple

import torch

from foundationdb_tpu_torch import convert  # (which imports this module)
from foundationdb_tpu_torch.core.status import COMMITTED, CONFLICT, TOO_OLD
from foundationdb_tpu_torch.ops import _kernels
from foundationdb_tpu_torch.ops.accept import (
    MAX_TXNS,
    READ_SENTINEL,
    WRITE_SENTINEL,
    conflict_matrix,
    fused_accept,
    sweep_accept,
)
from foundationdb_tpu_torch.ops.intervals import point_in, ranges_overlap
from foundationdb_tpu_torch.ops.ring import ring_slot_hits


class ResolverParams(NamedTuple):
    """Static shape config."""

    txns: int = 1024  # T
    point_reads: int = 4  # PR per txn
    point_writes: int = 4  # PW per txn
    range_reads: int = 2  # RR per txn
    range_writes: int = 2  # RW per txn
    key_width: int = 9  # W = limbs + 1 (length limb)
    hash_bits: int = 22  # point table size 2^HB
    ring_capacity: int = 4096  # KR
    bucket_bits: int = 14  # C = 2^bucket_bits coarse buckets
    use_ring_kernel: bool = False  # ring lanes via csrc/ring.cu
    # record point writes into the coarse per-bucket summary even when
    # this variant has no range-read lanes to read it: set only on the
    # point-specialized fast variant (Resolver), which shares history
    # with a full variant whose later range reads must see these writes
    record_point_coarse: bool = False
    # bucket-partitioned ring, single device only: 2^bits sub-rings keyed
    # by the begin key's top bucket bits (0 = the flat ring)
    ring_partition_bits: int = 0
    # the whole accept step via csrc/accept.cu (subsumes the ring lanes)
    use_accept_kernel: bool = False


class ResolverState(NamedTuple):
    """Device-resident conflict history (the MVCC window)."""

    window_start: torch.Tensor  # int64[] — oldest admissible read version
    ht: torch.Tensor  # int64[2^HB] point-write version table
    ring_b: torch.Tensor  # int64[KR, W] range-write begins
    ring_e: torch.Tensor  # int64[KR, W] range-write ends
    ring_v: torch.Tensor  # int64[KR] commit versions
    ring_lo: torch.Tensor  # int32[KR] begin bucket
    ring_hi: torch.Tensor  # int32[KR] end bucket
    ring_mask: torch.Tensor  # bool[KR]
    ring_head: torch.Tensor  # int32[]; [2^PB] partitioned; [n] lanes
    range_L: torch.Tensor  # int64[C] evicted range-writes: v at begin bucket
    range_R: torch.Tensor  # int64[C] evicted range-writes: v at end bucket
    point_coarse: torch.Tensor  # int64[C] point writes per bucket


class ResolveBatch(NamedTuple):
    """One commit batch, packed to static shapes (invalid slots masked).

    The packer (resolver/packing.py) fills it with numpy arrays (uint32,
    int32, bool); a compiled step's convert.BatchStager (or
    convert.batch_from_numpy) moves it to tensors."""

    rv: torch.Tensor  # [T] read-version offsets
    txn_mask: torch.Tensor  # bool[T]
    pr_hash: torch.Tensor  # [T, PR]
    pr_key: torch.Tensor  # [T, PR, W] limb-encoded point-read keys
    pr_bucket: torch.Tensor  # int32[T, PR]
    pr_mask: torch.Tensor  # bool[T, PR]
    pw_hash: torch.Tensor  # [T, PW]
    pw_key: torch.Tensor  # [T, PW, W]
    pw_bucket: torch.Tensor  # int32[T, PW]
    pw_mask: torch.Tensor  # bool[T, PW]
    rr_b: torch.Tensor  # [T, RR, W]
    rr_e: torch.Tensor  # [T, RR, W]
    rr_lo: torch.Tensor  # int32[T, RR]
    rr_hi: torch.Tensor  # int32[T, RR]
    rr_mask: torch.Tensor  # bool[T, RR]
    rw_b: torch.Tensor  # [T, RW, W]
    rw_e: torch.Tensor  # [T, RW, W]
    rw_lo: torch.Tensor  # int32[T, RW]
    rw_hi: torch.Tensor  # int32[T, RW]
    rw_mask: torch.Tensor  # bool[T, RW]
    cv: torch.Tensor  # [] commit-version offset for this batch
    new_window_start: torch.Tensor  # []


class ShardBatch(NamedTuple):
    """One commit batch compacted per key-range lane, the presharded
    layout (resolver/packing.py ShardRouter builds it in numpy).

    Each conflict side is a flat slot array of ``n * Q`` entries, lane j
    owning slots ``[j*Q, (j+1)*Q)``, with the owning txn's index: point
    entries go to exactly the lane of their key, range entries get a
    slot in every lane their span touches and carry the whole unclipped
    range. ``rv``, ``txn_mask``, ``cv`` and ``new_window_start`` are
    replicated (parallel/mesh.py ``_SHARD_REPLICATED``). Padding slots
    point at txn 0 with mask False."""

    rv: torch.Tensor  # [T]
    txn_mask: torch.Tensor  # bool[T]
    pr_hash: torch.Tensor  # [n*Qpr]
    pr_key: torch.Tensor  # [n*Qpr, W]
    pr_bucket: torch.Tensor  # int32[n*Qpr]
    pr_txn: torch.Tensor  # int32[n*Qpr] owning txn slot in [0, T)
    pr_mask: torch.Tensor  # bool[n*Qpr]
    pw_hash: torch.Tensor  # [n*Qpw]
    pw_key: torch.Tensor  # [n*Qpw, W]
    pw_bucket: torch.Tensor  # int32[n*Qpw]
    pw_txn: torch.Tensor  # int32[n*Qpw]
    pw_mask: torch.Tensor  # bool[n*Qpw]
    rr_b: torch.Tensor  # [n*Qrr, W]
    rr_e: torch.Tensor  # [n*Qrr, W]
    rr_lo: torch.Tensor  # int32[n*Qrr]
    rr_hi: torch.Tensor  # int32[n*Qrr]
    rr_txn: torch.Tensor  # int32[n*Qrr]
    rr_mask: torch.Tensor  # bool[n*Qrr]
    rw_b: torch.Tensor  # [n*Qrw, W]
    rw_e: torch.Tensor  # [n*Qrw, W]
    rw_lo: torch.Tensor  # int32[n*Qrw]
    rw_hi: torch.Tensor  # int32[n*Qrw]
    rw_txn: torch.Tensor  # int32[n*Qrw]
    rw_mask: torch.Tensor  # bool[n*Qrw]
    cv: torch.Tensor  # []
    new_window_start: torch.Tensor  # []


def init_state(params: ResolverParams, device="cpu",
               n_lanes=None) -> ResolverState:
    """A fresh history. ``n_lanes`` gives the lane-sharded layout at the
    mesh's global shapes (hash table ``n << HB``, ring ``n * KR``, one
    ring head a lane); else one device's, with one ring head a
    sub-ring when the ring is partitioned."""
    n = 1 if n_lanes is None else int(n_lanes)
    kr, c, w = n * params.ring_capacity, 1 << params.bucket_bits, params.key_width
    i64, i32 = torch.int64, torch.int32
    if n_lanes is not None:
        head_shape = (n,)
    elif params.ring_partition_bits:
        head_shape = (1 << params.ring_partition_bits,)
    else:
        head_shape = ()

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ResolverState(
        window_start=z((), i64),
        ht=z((n << params.hash_bits,), i64),
        ring_b=z((kr, w), i64),
        ring_e=z((kr, w), i64),
        ring_v=z((kr,), i64),
        ring_lo=z((kr,), i32),
        ring_hi=z((kr,), i32),
        ring_mask=z((kr,), torch.bool),
        ring_head=z(head_shape, i32),
        range_L=z((c,), i64),
        range_R=z((c,), i64),
        point_coarse=z((c,), i64),
    )


def _sparse_table(vals):
    """Sparse-table (doubling) range-max levels over a 1-D tensor:
    level l gives the max over [i, i + 2^l)."""
    levels = [vals]
    n = vals.shape[0]
    span = 1
    while span < n:
        prev = levels[-1]
        shifted = torch.cat([prev[span:], prev.new_zeros((span,))])
        levels.append(torch.maximum(prev, shifted))
        span *= 2
    return levels


def _range_max(levels, lo, hi):
    """Max over [lo, hi] inclusive, O(1) per query.

    The level is floor(log2(max(len, 1))) clipped to the table, taken
    with integer compares: the JAX step's float32 log2 gives the same
    level for every length up to 2^14 buckets (and is exact where
    float32 rounding would not be)."""
    n = levels[0].shape[0]
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    length = (hi - lo + 1).clamp(min=1)
    # 2, 4, ..., made on the device: a tensor built from a Python list
    # would be a host copy that synchronises the stream
    pow2 = torch.arange(1, len(levels), dtype=torch.int64, device=lo.device)
    pow2 = torch.ones_like(pow2) << pow2
    j = (length[..., None] >= pow2).sum(dim=-1)
    stacked = torch.stack(levels)  # [L, C]
    a = stacked[j, lo.clamp(0, n - 1)]
    b = stacked[j, (hi - (1 << j) + 1).clamp(0, n - 1)]
    return torch.maximum(a, b)


def _scatter_max_(dst, idx, vals):
    """dst[idx] = max(dst[idx], vals), in place (jnp .at[].max)."""
    dst.scatter_reduce_(0, idx.reshape(-1).to(torch.int64),
                        vals.reshape(-1), "amax", include_self=True)


def _lex_lt_by_limb(a, b, W):
    """lex_lt where ``a(i)`` and ``b(i)`` give limb i of each side: a
    sub-ring gathered per query is built one limb at a time, never as a
    [..., KRs, W] tensor."""
    lt = eq = None
    for i in range(W):
        ai, bi = a(i), b(i)
        if lt is None:
            lt, eq = ai < bi, ai == bi
        else:
            lt = lt | (eq & (ai < bi))
            eq = eq & (ai == bi)
    return lt


class _SubRings:
    """The partitioned ring's views: P = 2^PB sub-rings of KRs entries,
    sub-ring p holding the single-partition writes whose begin bucket has
    top bits p, and each sub-ring's newest live version."""

    def __init__(self, state, params):
        pb = params.ring_partition_bits
        self.P = P = 1 << pb
        self.KRs = KRs = params.ring_capacity // P
        self.shift = params.bucket_bits - pb
        self.W = W = params.key_width
        self.b = state.ring_b.view(P, KRs, W)
        self.e = state.ring_e.view(P, KRs, W)
        self.v = state.ring_v.view(P, KRs)
        self.m = state.ring_mask.view(P, KRs)
        # the conservative verdict for a query's middle partitions (its
        # end partitions get exact checks)
        self.part_max = torch.where(self.m, self.v, 0).amax(dim=1)

    def part(self, bucket):
        return (bucket.to(torch.int64) >> self.shift).clamp(0, self.P - 1)

    def hits(self, qb, qe, rv, pq, point):
        """bool[T, S]: each query slot against the live entries newer
        than its read version in sub-ring ``pq`` [T, S]; a point query
        (key qb) lies in an entry, a range [qb, qe) meets one."""
        def sub(x):
            return lambda i: x[:, :, i][pq]  # [T, S, KRs]

        def qry(x):
            return lambda i: x[..., i][..., None]  # [T, S, 1]

        W = self.W
        if point:
            ov = (~_lex_lt_by_limb(qry(qb), sub(self.b), W)
                  & _lex_lt_by_limb(qry(qb), sub(self.e), W))
        else:
            ov = (_lex_lt_by_limb(qry(qb), sub(self.e), W)
                  & _lex_lt_by_limb(sub(self.b), qry(qe), W))
        newer = (self.v[pq] > rv[:, None, None]) & self.m[pq]
        return (ov & newer).any(dim=2)


def _check_lanes(state, n, hash_bits):
    if state.ht.shape[0] != n << hash_bits or state.ring_head.shape != (n,):
        raise ValueError(
            f"a {n}-lane step needs a state of {n} lanes (init_state with "
            f"n_lanes={n}); got ht of {state.ht.shape[0]} slots and ring "
            f"heads of shape {tuple(state.ring_head.shape)}: ownership "
            "would silently un-own part of the key space")


def resolve_batch(state: ResolverState, batch: ResolveBatch,
                  params: ResolverParams, n_lanes=None):
    """One resolver step: (statuses int32[T], accepted bool[T], state).

    Updates ``state`` in place and returns it. With ``n_lanes`` it is the
    "hash" lane-sharded step over a state of the mesh's global shapes
    (``init_state(..., n_lanes=n)``): every lane sees the whole batch;
    lane j owns the point hashes h with h mod n == j (its slice of the
    table) and the range writes whose begin bucket lies in its j-th
    contiguous share of the buckets (its ring). Whichever lane records a
    write is a lane whose check sees it, so OR-ing the lanes' verdicts
    loses nothing. Ref parity: Resolver::resolveBatch +
    ConflictSet::detectConflicts.
    """
    T = params.txns
    rv = batch.rv  # [T]
    dev = rv.device
    HB = params.hash_bits
    hb_mask = (1 << HB) - 1
    C = state.point_coarse.shape[0]
    lanes = n_lanes is not None
    n = int(n_lanes) if lanes else 1
    if lanes:
        _check_lanes(state, n, HB)
    # the partitioned ring is a single-device layout (the lanes shard the
    # ring by bucket instead); the kernels take the flat ring only
    PB = 0 if lanes else params.ring_partition_bits
    sub = _SubRings(state, params) if PB and params.range_writes else None
    accept_on = params.use_accept_kernel and not lanes and not PB
    ring_on = (params.use_ring_kernel and not accept_on and not lanes
               and not PB)
    # every lane's ring at once: a lane checks the whole batch against
    # its own ring, and the any over lanes is the check against all
    ring = (state.ring_b, state.ring_e, state.ring_v, state.ring_mask)

    # ───────────────────────── history conflicts ─────────────────────────
    too_old = rv < state.window_start
    hist = torch.zeros((T,), dtype=torch.bool, device=dev)

    # the ring and coarse interval summaries hold range writes only: a
    # config without range writes never checks them
    if params.range_writes:
        pref_L = torch.cummax(state.range_L, dim=0).values
        suf_R = torch.cummax(state.range_R.flip(0), dim=0).values.flip(0)

    if params.point_reads:
        h = batch.pr_hash & hb_mask
        if lanes:
            # only the owning lane (h mod n) checks a point read, in its
            # own slice of the table
            h = h + ((batch.pr_hash % n) << HB)
        ht_v = state.ht[h]  # [T, PR]
        hit = (ht_v > rv[:, None]) & batch.pr_mask
        if params.range_writes:
            if sub is not None:
                # a point's partition is its bucket's: any single-partition
                # entry holding it lives there (spanning ones are coarse)
                hit |= sub.hits(batch.pr_key, batch.pr_key, rv,
                                sub.part(batch.pr_bucket), True) & batch.pr_mask
            elif not accept_on:  # else the accept kernel checks the ring
                hit |= ring_slot_hits(batch.pr_key, batch.pr_key, rv,
                                      batch.pr_mask, ring, True, ring_on)
            bk = batch.pr_bucket.to(torch.int64)
            coarse = torch.minimum(pref_L[bk], suf_R[bk])
            hit |= (coarse > rv[:, None]) & batch.pr_mask
        hist |= hit.any(dim=1)

    if params.range_reads:
        RR = batch.rr_b.shape[1]
        hit = torch.zeros((T, RR), dtype=torch.bool, device=dev)
        if params.range_writes:
            if sub is not None:
                # exact checks against the two end partitions' sub-rings,
                # the per-partition version max for the ones between
                p_lo, p_hi = sub.part(batch.rr_lo), sub.part(batch.rr_hi)
                ring_hit = (sub.hits(batch.rr_b, batch.rr_e, rv, p_lo, False)
                            | sub.hits(batch.rr_b, batch.rr_e, rv, p_hi, False))
                pidx = torch.arange(sub.P, device=dev)
                mid = (pidx > p_lo[..., None]) & (pidx < p_hi[..., None])
                mid_max = torch.where(mid, sub.part_max, 0).amax(dim=2)
                ring_hit |= mid_max > rv[:, None]
                hit |= ring_hit & batch.rr_mask
            elif not accept_on:
                hit |= ring_slot_hits(batch.rr_b, batch.rr_e, rv,
                                      batch.rr_mask, ring, False, ring_on)
            coarse_rng = torch.minimum(pref_L[batch.rr_hi.to(torch.int64)],
                                       suf_R[batch.rr_lo.to(torch.int64)])
            hit |= (coarse_rng > rv[:, None]) & batch.rr_mask
        if params.point_writes:
            levels = _sparse_table(state.point_coarse)
            pmax = _range_max(levels, batch.rr_lo, batch.rr_hi)
            hit |= (pmax > rv[:, None]) & batch.rr_mask
        hist |= hit.any(dim=1)

    # a0: admissible before intra-batch ordering (history + window + mask)
    a0 = (~too_old) & (~hist) & batch.txn_mask

    if accept_on:
        accepted = fused_accept(state, batch, params, a0)
    else:
        # With lanes, each lane builds the rows of O from the writes it
        # owns and the kill vector sums over lanes; the owners partition
        # the writes (each hash has one residue, each bucket one share),
        # so that sum reads the OR of the lanes' rows: the whole matrix.
        accepted = sweep_accept(a0, conflict_matrix(batch, params))

    status = torch.where(too_old, TOO_OLD,
                         torch.where(accepted, COMMITTED, CONFLICT))
    status = torch.where(batch.txn_mask, status, CONFLICT).to(torch.int32)

    # ───────────────────────── history update ─────────────────────────────
    cv = batch.cv
    if params.point_writes:
        ok = batch.pw_mask & accepted[:, None]  # [T, PW]
        val = torch.where(ok, cv, 0)
        h = batch.pw_hash & hb_mask
        if lanes:  # only the owning lane records a point write
            h = h + ((batch.pw_hash % n) << HB)
        _scatter_max_(state.ht, h, val)
        # replicated: every lane applies the same update to one copy
        if params.range_reads or params.record_point_coarse:
            _scatter_max_(state.point_coarse, batch.pw_bucket.clamp(0, C - 1), val)

    if params.range_writes and batch.rw_b.shape[1]:
        W = params.key_width
        ok = (batch.rw_mask & accepted[:, None]).reshape(-1)  # [T*RW]
        lo = batch.rw_lo.reshape(-1)
        hi = batch.rw_hi.reshape(-1)
        kr = params.ring_capacity
        head = state.ring_head.to(torch.int64)
        if lanes:
            # lane j records the entries whose begin bucket is in its share
            lane = (lo.to(torch.int64) * n) // C
            rank, counts = _group_ranks(ok, lane, n)
            pos = torch.where(ok, lane * kr + (head[lane.clamp(0, n - 1)]
                                               + rank) % kr, n * kr)
            new_head = (head + counts) % kr
        elif sub is not None:
            # single-partition entries go to their sub-ring; spanning ones
            # (and a flood overflowing a sub-ring in one batch) fold into
            # the coarse summaries, the same direction as eviction
            KRs = sub.KRs
            part_lo, part_hi = sub.part(lo), sub.part(hi)
            single = part_lo == part_hi
            rank, counts = _group_ranks(ok & single, part_lo, sub.P)
            ok_ring = ok & single & (rank < KRs)
            ok_coarse = ok & (~single | (single & (rank >= KRs)))
            pos = torch.where(ok_ring,
                              part_lo * KRs + (head[part_lo] + rank) % KRs, kr)
            new_head = (head + counts.clamp(max=KRs)) % KRs
            c_val = torch.where(ok_coarse, cv, 0)
            _scatter_max_(state.range_L, lo.clamp(0, C - 1), c_val)
            _scatter_max_(state.range_R, hi.clamp(0, C - 1), c_val)
        else:
            slot_order = torch.cumsum(ok, dim=0) - 1  # position among accepted
            pos = torch.where(ok, (head + slot_order) % kr, kr)
            new_head = (head + ok.sum()) % kr
        _write_ring(state, pos, new_head, batch.rw_b.reshape(-1, W),
                    batch.rw_e.reshape(-1, W), lo, hi, cv, C)

    # monotone: never regress the window (a recovered resolver's fence
    # must survive proxies whose cv-derived window is still behind it)
    state.window_start.copy_(torch.maximum(state.window_start,
                                           batch.new_window_start))
    return status, accepted, state


def _group_ranks(ok, group, n_groups):
    """Each accepted entry's rank among its group's accepted entries, in
    entry order, and each group's count. ok: bool[N]; group: int64[N]."""
    onehot = ok[:, None] & (
        group[:, None] == torch.arange(n_groups, device=ok.device)[None, :])
    ranks = torch.cumsum(onehot.to(torch.int64), dim=0) - 1
    rank = torch.where(onehot, ranks, 0).sum(dim=1)
    return rank, onehot.sum(dim=0)


def _write_ring(state, pos, new_head, b, e, lo, hi, cv, C):
    """Write the entries at ring positions ``pos`` (the spare position
    len(ring) for an entry that is not written), folding the live
    entries they evict into the coarse interval summaries first, and
    move the ring heads. Valid positions are distinct (the callers' per
    ring bounds), so each ring slot takes at most one entry."""
    kr = state.ring_v.shape[0]
    n = pos.shape[0]
    # src[k]: the entry that lands in ring slot k, or -1; every dropped
    # entry points at the spare slot kr, which is cut off
    src = torch.full((kr + 1,), -1, dtype=torch.int64, device=pos.device)
    src.scatter_(0, pos, torch.arange(n, device=pos.device))
    src = src[:kr]
    written = src >= 0
    ev_val = torch.where(written & state.ring_mask, state.ring_v, 0)
    _scatter_max_(state.range_L, state.ring_lo.clamp(0, C - 1), ev_val)
    _scatter_max_(state.range_R, state.ring_hi.clamp(0, C - 1), ev_val)
    take = src.clamp(min=0)
    col = written[:, None]
    state.ring_b.copy_(torch.where(col, b[take], state.ring_b))
    state.ring_e.copy_(torch.where(col, e[take], state.ring_e))
    state.ring_v.copy_(torch.where(written, cv, state.ring_v))
    state.ring_lo.copy_(torch.where(written, lo[take], state.ring_lo))
    state.ring_hi.copy_(torch.where(written, hi[take], state.ring_hi))
    state.ring_mask.copy_(state.ring_mask | written)
    state.ring_head.copy_(new_head)


def validate_params(params: ResolverParams):
    """Shape invariants the step's safety argument depends on."""
    if params.txns * params.range_writes > params.ring_capacity:
        raise ValueError(
            f"ring_capacity {params.ring_capacity} < txns*range_writes "
            f"{params.txns * params.range_writes}: one batch could wrap the "
            "ring and silently drop committed range-writes from history"
        )
    if params.bucket_bits > 30 or params.hash_bits > 28:
        raise ValueError("bucket_bits/hash_bits unreasonably large")
    if params.use_accept_kernel and params.txns > MAX_TXNS:
        raise ValueError(
            f"use_accept_kernel requires txns <= {MAX_TXNS}: the sweep "
            f"stages its rows in one block (got {params.txns})"
        )
    pb = params.ring_partition_bits
    if pb:
        if pb > params.bucket_bits:
            raise ValueError(
                "ring_partition_bits exceeds bucket_bits: partitions are "
                "keyed by the top coarse-bucket bits")
        if params.ring_capacity % (1 << pb):
            raise ValueError(
                "ring_capacity must divide evenly into 2^ring_partition_bits "
                "sub-rings")
        if params.use_ring_kernel or params.use_accept_kernel:
            raise ValueError(
                "ring_partition_bits and the ring/accept kernels are "
                "mutually exclusive: the kernels take the flat ring layout "
                "(ignoring an explicit kernel request would misattribute "
                "measurements)")


def resolve_batch_presharded(state: ResolverState, sb: ShardBatch,
                             params: ResolverParams):
    """The compacted-lane step, the "range" sharding mode.

    ``sb`` is a ShardBatch whose per-lane fields are viewed ``[n, Q, ...]``
    (parallel/mesh.py ``lane_view``) and ``state`` has n lanes. Each lane
    checks only the entries routed to it against its own table slice and
    ring, so the [Q, KR] ring scan and the pairwise matrix shrink with n.
    Any read and write that overlap share a key, and both are routed to
    that key's lane, so every conflict is checked on some lane; the
    lanes' per-txn hit counts and [T, T] pair counts sum into one before
    the > 0 threshold (the psum of the JAX package). ``rv``, ``txn_mask``
    and the versions are replicated, so one verdict vector comes out.
    """
    n = sb.pr_txn.shape[0]
    T = params.txns
    rv = sb.rv
    dev = rv.device
    HB = params.hash_bits
    hb_mask = (1 << HB) - 1
    C = state.point_coarse.shape[0]
    W = params.key_width
    _check_lanes(state, n, HB)
    KR = state.ring_v.shape[0] // n
    rb = state.ring_b.view(n, KR, W)
    re = state.ring_e.view(n, KR, W)
    rvv = state.ring_v.view(n, KR)
    rm = state.ring_mask.view(n, KR)
    Qpr, Qpw = sb.pr_txn.shape[1], sb.pw_txn.shape[1]
    Qrr, Qrw = sb.rr_txn.shape[1], sb.rw_txn.shape[1]
    lane_ids = torch.arange(n, device=dev)[:, None]  # [n, 1]

    # ───────────────────────── history conflicts ─────────────────────────
    too_old = rv < state.window_start
    # per-txn hit counts by scatter-add; padding slots point at txn 0 with
    # mask False and add zero
    hist_i = torch.zeros((T,), dtype=torch.int32, device=dev)

    if params.range_writes:
        pref_L = torch.cummax(state.range_L, dim=0).values
        suf_R = torch.cummax(state.range_R.flip(0), dim=0).values.flip(0)

    if Qpr:
        txn = sb.pr_txn.to(torch.int64)
        rv_q = rv[txn]  # [n, Qpr]
        hit = (state.ht[(lane_ids << HB) + (sb.pr_hash & hb_mask)] > rv_q) \
            & sb.pr_mask
        if params.range_writes:
            in_rng = point_in(sb.pr_key[:, :, None, :], rb[:, None],
                              re[:, None])  # [n, Qpr, KR]
            newer = (rvv[:, None, :] > rv_q[:, :, None]) & rm[:, None, :]
            hit |= (in_rng & newer).any(dim=2) & sb.pr_mask
            bk = sb.pr_bucket.to(torch.int64)
            coarse = torch.minimum(pref_L[bk], suf_R[bk])
            hit |= (coarse > rv_q) & sb.pr_mask
        hist_i.index_add_(0, txn.reshape(-1), hit.reshape(-1).to(torch.int32))

    if Qrr:
        txn = sb.rr_txn.to(torch.int64)
        rv_q = rv[txn]  # [n, Qrr]
        hit = torch.zeros((n, Qrr), dtype=torch.bool, device=dev)
        if params.range_writes:
            ov = ranges_overlap(sb.rr_b[:, :, None, :], sb.rr_e[:, :, None, :],
                                rb[:, None], re[:, None])  # [n, Qrr, KR]
            newer = (rvv[:, None, :] > rv_q[:, :, None]) & rm[:, None, :]
            hit |= (ov & newer).any(dim=2) & sb.rr_mask
            coarse_rng = torch.minimum(pref_L[sb.rr_hi.to(torch.int64)],
                                       suf_R[sb.rr_lo.to(torch.int64)])
            hit |= (coarse_rng > rv_q) & sb.rr_mask
        if params.point_writes:
            levels = _sparse_table(state.point_coarse)
            pmax = _range_max(levels, sb.rr_lo, sb.rr_hi)
            hit |= (pmax > rv_q) & sb.rr_mask
        hist_i.index_add_(0, txn.reshape(-1), hit.reshape(-1).to(torch.int32))

    hist = hist_i > 0

    # ─────────────────────── intra-batch conflict matrix ───────────────────
    # O[t1, t2] counts (write txn, read txn) pairs over every lane; a
    # spanning write and a spanning read seen on two lanes add twice
    # before the > 0 threshold
    O_i = torch.zeros((T * T,), dtype=torch.int32, device=dev)

    def pairs(w_txn, r_txn, val):  # val: bool[n, Qw, Qr]
        idx = (w_txn.to(torch.int64)[:, :, None] * T
               + r_txn.to(torch.int64)[:, None, :])
        O_i.index_add_(0, idx.reshape(-1), val.reshape(-1).to(torch.int32))

    if Qpw and Qpr:
        wh = torch.where(sb.pw_mask, sb.pw_hash, WRITE_SENTINEL)
        rh = torch.where(sb.pr_mask, sb.pr_hash, READ_SENTINEL)
        pairs(sb.pw_txn, sb.pr_txn, wh[:, :, None] == rh[:, None, :])
    if Qpw and Qrr:
        inr = point_in(sb.pw_key[:, :, None, :], sb.rr_b[:, None],
                       sb.rr_e[:, None])  # [n, Qpw, Qrr]
        pairs(sb.pw_txn, sb.rr_txn,
              inr & sb.pw_mask[:, :, None] & sb.rr_mask[:, None, :])
    if Qrw and Qpr:
        inr = point_in(sb.pr_key[:, None], sb.rw_b[:, :, None, :],
                       sb.rw_e[:, :, None, :])  # [n, Qrw, Qpr]
        pairs(sb.rw_txn, sb.pr_txn,
              inr & sb.rw_mask[:, :, None] & sb.pr_mask[:, None, :])
    if Qrw and Qrr:
        ov = ranges_overlap(sb.rr_b[:, None], sb.rr_e[:, None],
                            sb.rw_b[:, :, None, :], sb.rw_e[:, :, None, :])
        pairs(sb.rw_txn, sb.rr_txn,
              ov & sb.rw_mask[:, :, None] & sb.rr_mask[:, None, :])

    upper = torch.ones((T, T), dtype=torch.bool, device=dev).triu(1)
    O = ((O_i.view(T, T) > 0) & upper & sb.txn_mask[:, None]
         & sb.txn_mask[None, :])
    a0 = (~too_old) & (~hist) & sb.txn_mask
    accepted = sweep_accept(a0, O)

    status = torch.where(too_old, TOO_OLD,
                         torch.where(accepted, COMMITTED, CONFLICT))
    status = torch.where(sb.txn_mask, status, CONFLICT).to(torch.int32)

    # ───────────────────────── history update ─────────────────────────────
    cv = sb.cv
    if Qpw:
        ok = sb.pw_mask & accepted[sb.pw_txn.to(torch.int64)]  # [n, Qpw]
        val = torch.where(ok, cv, 0)
        _scatter_max_(state.ht, (lane_ids << HB) + (sb.pw_hash & hb_mask), val)
        if params.range_reads or params.record_point_coarse:
            # lanes record different subsets into the one replicated copy
            # (the JAX package's pmax)
            _scatter_max_(state.point_coarse, sb.pw_bucket.clamp(0, C - 1), val)

    if Qrw:
        ok = sb.rw_mask & accepted[sb.rw_txn.to(torch.int64)]  # [n, Qrw]
        slot = torch.cumsum(ok, dim=1) - 1
        # a skewed split can overflow a lane's ring in one batch: the
        # excess folds into the coarse interval summaries, the same
        # direction as eviction
        ok_ring = ok & (slot < KR)
        overflow = ok & (slot >= KR)
        head = state.ring_head.to(torch.int64)
        pos = torch.where(ok_ring, lane_ids * KR + (head[:, None] + slot) % KR,
                          n * KR)
        new_head = (head + ok.sum(dim=1).clamp(max=KR)) % KR
        o_val = torch.where(overflow, cv, 0)
        _scatter_max_(state.range_L, sb.rw_lo.clamp(0, C - 1), o_val)
        _scatter_max_(state.range_R, sb.rw_hi.clamp(0, C - 1), o_val)
        _write_ring(state, pos.reshape(-1), new_head, sb.rw_b.reshape(-1, W),
                    sb.rw_e.reshape(-1, W), sb.rw_lo.reshape(-1),
                    sb.rw_hi.reshape(-1), cv, C)

    state.window_start.copy_(torch.maximum(state.window_start,
                                           sb.new_window_start))
    return status, accepted, state


def validate_presharded_params(params: ResolverParams):
    """Invariants of the compacted-lane step. The flat ring's
    T*RW <= KR wrap check does not apply: a lane's ring overflow folds
    into the coarse summaries instead of wrapping."""
    if params.use_ring_kernel or params.use_accept_kernel:
        raise ValueError(
            "the presharded step has no kernel lanes: the kernels take the "
            "dense [T, K] layout (ignoring an explicit kernel request would "
            "misattribute measurements)")
    if params.ring_partition_bits:
        raise ValueError(
            "ring_partition_bits is a single-device layout; the presharded "
            "step shards the ring across lanes instead")
    if params.bucket_bits > 30 or params.hash_bits > 28:
        raise ValueError("bucket_bits/hash_bits unreasonably large")


# card steps since the last reset_graph_counts(): dispatches through a
# StaticStep, graph captures and graph replays (every dispatch on a card
# is one replay; a capture precedes the first)
graph_counts = {"dispatches": 0, "captures": 0, "replays": 0}
_tls = threading.local()  # .capturing: inside StaticStep._capture


def reset_graph_counts():
    for k in graph_counts:
        graph_counts[k] = 0


def capturing():
    """Whether this thread is inside a StaticStep's capture (its warm-up
    on a scratch state, or the capture itself)."""
    return getattr(_tls, "capturing", False)


class StaticStep:
    """A resolver step compiled for one batch signature: the port's
    counterpart of a jitted step with donated state.

    ``fn(state, inputs)`` is the eager step (it updates ``state`` in place
    and returns the statuses). ``run(batch)`` copies a packed numpy batch
    into fixed input tensors (convert.BatchStager) and runs the step on
    the live ``state``, whose tensors it never replaces. On a card the
    first run (or ``prepare``) captures the step in a
    ``torch.cuda.CUDAGraph`` and every run replays it: the host work
    between the copy and the statuses (the chain of torch ops, the kernel
    wrappers' checks and ``ctypes`` calls) happens once, at capture. On
    the CPU there is no graph: the step runs eagerly, with the same
    buffers.

    The statuses come back in a fixed output tensor that the next run
    overwrites: a caller that reads them later copies them first
    (convert.host_reader). A capture or replay that fails raises; the
    step never runs eagerly on a card instead."""

    def __init__(self, fn, state, layout):
        self._fn = fn
        self.state = state
        self._layout = layout
        self.device = state.window_start.device
        self._stager = None
        self._graph = None
        self._out = None
        self.held = {}  # kernel launches one replay makes, by wrapper
        self.runs = 0

    def prepare(self, batch):
        """Set up the inputs for ``batch``'s signature and, on a card,
        capture the step, without running it on the live state. Returns
        the inputs, filled from ``batch``."""
        if self._stager is None:
            self._stager = convert.BatchStager(self._layout, batch,
                                                 self.device)
        inputs = self._stager.copy_in(batch)
        if self.device.type == "cuda" and self._graph is None:
            self._capture(inputs)
        return inputs

    def run(self, batch):
        inputs = self.prepare(batch)
        self.runs += 1
        if self.device.type != "cuda":
            out = self._fn(self.state, inputs)
            if self._out is None:
                self._out = torch.empty_like(out)
            self._out.copy_(out)
            return self._out
        graph_counts["dispatches"] += 1
        self._graph.replay()
        graph_counts["replays"] += 1
        _kernels.add_launches(self.held)
        return self._out

    def _capture(self, inputs):
        """Warm up on a scratch copy of the state (the warm-up runs the
        step; on the live state it would record the batch twice), then
        capture on the live state, on this thread only: other threads
        (a status reader waiting on an event) go on meanwhile."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        _tls.capturing = True
        try:
            with torch.cuda.stream(side):
                scratch = type(self.state)(*(f.clone() for f in self.state))
                self._fn(scratch, inputs)
            cur.wait_stream(side)
            del scratch
            graph = torch.cuda.CUDAGraph()
            with _kernels.capturing() as held:
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    out = self._fn(self.state, inputs)
        finally:
            _tls.capturing = False
        self._graph, self._out, self.held = graph, out, held
        graph_counts["captures"] += 1


class StepCache:
    """A history's compiled steps, by key and batch signature: the port
    of the reference's ``count_retraces``. Each new signature under a key
    is one capture (one XLA compile in the reference), counted in
    ``captures[key]``; on the CPU, where nothing is captured, the same
    count marks a static step's first set-up, so it means the same on
    both devices."""

    def __init__(self):
        self._steps = {}
        self.captures = {}
        # called with the key at each new capture (the owning resolver's
        # device profile counts them as compiles)
        self.on_capture = None

    def run(self, key, batch, make_step):
        """``make_step()`` builds the StaticStep of ``key`` on a miss.
        Returns the step's (static) statuses."""
        return self._step(key, batch, make_step).run(batch)

    def prepare(self, key, batch, make_step):
        """Compile ``key``'s step for ``batch``'s signature ahead of its
        first dispatch (StaticStep.prepare); the history is untouched."""
        self._step(key, batch, make_step).prepare(batch)

    def _step(self, key, batch, make_step):
        sig = (key, convert.signature(batch))
        step = self._steps.get(sig)
        if step is None:
            step = self._steps[sig] = make_step()
            self.captures[key] = self.captures.get(key, 0) + 1
            if self.on_capture is not None:
                self.on_capture(key)
        return step

    def stats(self):
        steps = self._steps.values()
        return {"captures": {str(k): n for k, n in self.captures.items()},
                "runs": sum(s.runs for s in steps),
                "graphs": sum(s._graph is not None for s in steps)}


def make_resolve_fn(params: ResolverParams, state: ResolverState):
    """The compiled single-batch step over ``state``: a StaticStep whose
    ``run(batch)`` gives statuses int32[T]."""
    validate_params(params)
    return StaticStep(lambda s, b: resolve_batch(s, b, params)[0], state,
                      ResolveBatch)


def scan_of(step_fn):
    """Lift a single-batch step into a multi-batch one:
    (state, batches[B, ...]) → (state, statuses[B, T]), threading the
    history through the B batches in order, exactly as B calls would."""

    def scan_step(state, batches):
        rows = []
        for b in range(batches.rv.shape[0]):
            status, _accepted, state = step_fn(
                state, type(batches)(*(x[b] for x in batches)))
            rows.append(status)
        return state, torch.stack(rows)

    return scan_step


def make_resolve_scan_fn(params: ResolverParams, state: ResolverState):
    """The compiled multi-batch step over ``state`` for backlogs: a
    StaticStep whose ``run(batches)`` gives statuses [B, T] for a stack of
    B batches, the B steps unrolled into one graph, with the same kernels
    as the single step. (The JAX package strips its ring kernel from
    scans by default because XLA overlaps the plain lanes across scan
    iterations; the port keeps it.)"""
    validate_params(params)
    scan = scan_of(lambda s, b: resolve_batch(s, b, params))
    return StaticStep(lambda s, b: scan(s, b)[1], state, ResolveBatch)


def rebase_state(state: ResolverState, delta):
    """Shift all version offsets down by ``delta`` (saturating at 0), in
    place. Safe when delta <= the window start: clamped entries had
    versions no admissible read can still see."""
    d = int(delta)
    for v in (state.window_start, state.ht, state.ring_v, state.range_L,
              state.range_R, state.point_coarse):
        v.sub_(d).clamp_(min=0)
    return state
