"""The resolver's conflict-detection step on PyTorch tensors.

Reference semantics (fdbserver/Resolver.actor.cpp + fdbserver/SkipList.cpp,
ConflictSet::detectConflicts): a resolver keeps the last ~5s of committed
write ranges; a transaction commits iff none of its read conflict ranges
intersects a write range committed after its read version — including
writes of earlier transactions *in the same batch* that were themselves
accepted.

The port of ``foundationdb_tpu/ops/conflict.py`` (single device, flat
ring), held to it bit for bit: the same four history structures, the
same lanes, the same statuses and the same state after every batch.

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
relation O[w, r] (ops/accept.py): the CUDA kernels compute it directly,
the torch route as the Jacobi fixpoint a ← a0 ∧ ¬(a·O).

Representation: uint32 quantities (limbs, hashes, versions) are int64
tensors with zero extension (ops/intervals.py); bucket indices and the
ring head are int32; masks bool. The state is updated in place, where
the JAX package donated its buffers to the next step. Versions are
offsets from a host-held base (core/versions.py); 0 means "no write".
"""

from typing import NamedTuple

import torch

from foundationdb_tpu_torch.core.status import COMMITTED, CONFLICT, TOO_OLD
from foundationdb_tpu_torch.ops.accept import (
    MAX_TXNS,
    conflict_matrix,
    fused_accept,
    jacobi_accept,
)
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
    ring_partition_bits: int = 0  # only the flat ring (0) is ported
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
    ring_head: torch.Tensor  # int32[]
    range_L: torch.Tensor  # int64[C] evicted range-writes: v at begin bucket
    range_R: torch.Tensor  # int64[C] evicted range-writes: v at end bucket
    point_coarse: torch.Tensor  # int64[C] point writes per bucket


class ResolveBatch(NamedTuple):
    """One commit batch, packed to static shapes (invalid slots masked).

    The packer (resolver/packing.py) fills it with numpy arrays (uint32,
    int32, bool); convert.batch_from_numpy moves it to tensors."""

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


def init_state(params: ResolverParams, device="cpu") -> ResolverState:
    kr, c, w = params.ring_capacity, 1 << params.bucket_bits, params.key_width
    i64, i32 = torch.int64, torch.int32

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ResolverState(
        window_start=z((), i64),
        ht=z((1 << params.hash_bits,), i64),
        ring_b=z((kr, w), i64),
        ring_e=z((kr, w), i64),
        ring_v=z((kr,), i64),
        ring_lo=z((kr,), i32),
        ring_hi=z((kr,), i32),
        ring_mask=z((kr,), torch.bool),
        ring_head=z((), i32),
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
    pow2 = torch.tensor([1 << l for l in range(1, len(levels))],
                        dtype=torch.int64, device=lo.device)
    j = (length[..., None] >= pow2).sum(dim=-1)
    stacked = torch.stack(levels)  # [L, C]
    a = stacked[j, lo.clamp(0, n - 1)]
    b = stacked[j, (hi - (1 << j) + 1).clamp(0, n - 1)]
    return torch.maximum(a, b)


def _scatter_max_(dst, idx, vals):
    """dst[idx] = max(dst[idx], vals), in place (jnp .at[].max)."""
    dst.scatter_reduce_(0, idx.reshape(-1).to(torch.int64),
                        vals.reshape(-1), "amax", include_self=True)


def resolve_batch(state: ResolverState, batch: ResolveBatch,
                  params: ResolverParams, axis_name=None, n_shards=1):
    """One resolver step: (statuses int32[T], accepted bool[T], state).

    Updates ``state`` in place and returns it. Ref parity:
    Resolver::resolveBatch + ConflictSet::detectConflicts.
    """
    if axis_name is not None or n_shards != 1:
        raise NotImplementedError("the sharded resolver step is not ported yet")
    if params.ring_partition_bits:
        raise NotImplementedError("the partitioned ring is not ported yet")
    T = params.txns
    rv = batch.rv  # [T]
    dev = rv.device
    hb_mask = (1 << params.hash_bits) - 1

    # ───────────────────────── history conflicts ─────────────────────────
    too_old = rv < state.window_start
    hist = torch.zeros((T,), dtype=torch.bool, device=dev)

    # the ring and coarse interval summaries hold range writes only: a
    # config without range writes never checks them
    if params.range_writes:
        pref_L = torch.cummax(state.range_L, dim=0).values
        suf_R = torch.cummax(state.range_R.flip(0), dim=0).values.flip(0)

    accept_on = params.use_accept_kernel
    ring_on = params.use_ring_kernel and not accept_on
    ring = (state.ring_b, state.ring_e, state.ring_v, state.ring_mask)

    if params.point_reads:
        ht_v = state.ht[batch.pr_hash & hb_mask]  # [T, PR]
        hit = (ht_v > rv[:, None]) & batch.pr_mask
        if params.range_writes:
            if not accept_on:  # else the accept kernel checks the ring
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
            if not accept_on:
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
        accepted = jacobi_accept(a0, conflict_matrix(batch, params))

    status = torch.where(too_old, TOO_OLD,
                         torch.where(accepted, COMMITTED, CONFLICT))
    status = torch.where(batch.txn_mask, status, CONFLICT).to(torch.int32)

    # ───────────────────────── history update ─────────────────────────────
    cv = batch.cv
    C = state.point_coarse.shape[0]
    if params.point_writes:
        ok = batch.pw_mask & accepted[:, None]  # [T, PW]
        val = torch.where(ok, cv, 0)
        _scatter_max_(state.ht, batch.pw_hash & hb_mask, val)
        if params.range_reads or params.record_point_coarse:
            _scatter_max_(state.point_coarse, batch.pw_bucket.clamp(0, C - 1), val)

    if params.range_writes and batch.rw_b.shape[1]:
        _append_ring(state, batch, params, accepted, C)

    # monotone: never regress the window (a recovered resolver's fence
    # must survive proxies whose cv-derived window is still behind it)
    state.window_start.copy_(torch.maximum(state.window_start,
                                           batch.new_window_start))
    return status, accepted, state


def _append_ring(state, batch, params, accepted, C):
    """Append the accepted range writes at the ring head, folding the
    entries they evict into the coarse interval summaries first."""
    kr, W = params.ring_capacity, params.key_width
    ok = (batch.rw_mask & accepted[:, None]).reshape(-1)  # [T*RW]
    n = ok.shape[0]
    head = state.ring_head.to(torch.int64)
    slot_order = torch.cumsum(ok, dim=0) - 1  # position among accepted
    pos = torch.where(ok, (head + slot_order) % kr, kr)
    new_head = (head + ok.sum()) % kr
    # src[k]: the entry that lands in ring slot k, or -1. Valid positions
    # are distinct (T*RW <= KR, validate_params); every dropped entry
    # points at the spare slot kr, which is cut off.
    src = torch.full((kr + 1,), -1, dtype=torch.int64, device=ok.device)
    src.scatter_(0, pos, torch.arange(n, device=ok.device))
    src = src[:kr]
    written = src >= 0
    # fold evicted entries into the coarse interval summary first
    ev_val = torch.where(written & state.ring_mask, state.ring_v, 0)
    _scatter_max_(state.range_L, state.ring_lo.clamp(0, C - 1), ev_val)
    _scatter_max_(state.range_R, state.ring_hi.clamp(0, C - 1), ev_val)
    # append
    take = src.clamp(min=0)
    col = written[:, None]
    state.ring_b.copy_(torch.where(col, batch.rw_b.reshape(n, W)[take],
                                   state.ring_b))
    state.ring_e.copy_(torch.where(col, batch.rw_e.reshape(n, W)[take],
                                   state.ring_e))
    state.ring_v.copy_(torch.where(written, batch.cv, state.ring_v))
    state.ring_lo.copy_(torch.where(written, batch.rw_lo.reshape(n)[take],
                                    state.ring_lo))
    state.ring_hi.copy_(torch.where(written, batch.rw_hi.reshape(n)[take],
                                    state.ring_hi))
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
            f"holds the kill vector in one warp (got {params.txns})"
        )
    if params.ring_partition_bits:
        raise NotImplementedError("the partitioned ring is not ported yet")


def resolve_batch_presharded(state, sb, params, axis_name=None):
    """The compacted-lane sharded step: not ported yet."""
    raise NotImplementedError("resolve_batch_presharded is not ported yet")


def make_resolve_fn(params: ResolverParams):
    """The single-batch step (state, batch) → (status, accepted, state)."""
    validate_params(params)
    return lambda state, batch: resolve_batch(state, batch, params)


def scan_of(step_fn):
    """Lift a single-batch step into a multi-batch one:
    (state, batches[B, ...]) → (state, statuses[B, T]), threading the
    history through the B batches in order, exactly as B calls would."""

    def scan_step(state, batches):
        rows = []
        for b in range(batches.rv.shape[0]):
            status, _accepted, state = step_fn(
                state, ResolveBatch(*(x[b] for x in batches)))
            rows.append(status)
        return state, torch.stack(rows)

    return scan_step


def make_resolve_scan_fn(params: ResolverParams):
    """The multi-batch step for backlogs, with the same kernels as the
    single step. (The JAX package strips its ring kernel from scans by
    default because XLA overlaps the plain lanes across scan iterations;
    eager PyTorch has no such overlap, so the port keeps the kernel.)"""
    validate_params(params)
    return scan_of(lambda s, b: resolve_batch(s, b, params))


def rebase_state(state: ResolverState, delta):
    """Shift all version offsets down by ``delta`` (saturating at 0), in
    place. Safe when delta <= the window start: clamped entries had
    versions no admissible read can still see."""
    d = int(delta)
    for v in (state.window_start, state.ht, state.ring_v, state.range_L,
              state.range_R, state.point_coarse):
        v.sub_(d).clamp_(min=0)
    return state
