"""Abort-aware intra-batch commit scheduling.

Ref: "The Transactional Conflict Problem" (arxiv 1804.00947) — the order
transactions take inside a shared-version batch decides how many of them
OCC aborts. Members of a batch share one commit version and resolve in
batch order; an accepted member's writes enter the history at that
version, so a later member whose read set overlaps them is rejected. The
canonical win is reader before writer: T reads x, W blind-writes x;
arrival order [W, T] aborts T, order [T, W] commits both.

The pass runs on the host in the commit proxy, before packing, over the
conflict sets the clients encoded (raw flat entries when the whole batch
is flat at one width: an entry is order-isomorphic to its key). It
builds reader→writer precedence edges per key (a hash pass for points,
an interval pass for ranges) and orders the batch by Kahn's algorithm
with the arrival index as tie-break, so untouched batches keep arrival
order. Cycles (read-modify-write cliques on a hot key) are broken by
placing the arrival-first member.

Any order of a shared-version batch is a valid serialization and the
resolver re-validates every member, so the pass changes which legal
order a batch commits in, never correctness. It is deterministic. The
port's copy of ``foundationdb_tpu/server/scheduler.py``: the same
orders for the same batches.
"""

import heapq
import struct

_LEN_WORD = struct.Struct(">I")

# bail-out bounds: past these the pass would cost more than the aborts
# it saves (a 1024-txn batch with a few keys each stays far inside)
MAX_EDGES = 65_536
MAX_RANGES = 512
# per-key clique bound: a key with readers*writers past this is a hot
# clique whose members mostly abort regardless of order — skip its
# edges instead of materializing the quadratic fan-out
MAX_KEY_FANOUT = 4_096


class SchedulePlan:
    """The scheduler's verdict for one batch: ``order[pos]`` is the
    original index committed at position ``pos``. ``restore`` maps the
    pipeline's position-ordered results back to request order, so
    callers (and their futures) never observe the permutation."""

    __slots__ = ("order", "reordered", "deferred")

    def __init__(self, order, reordered, deferred):
        self.order = order
        self.reordered = reordered
        self.deferred = deferred

    @property
    def identity(self):
        return self.reordered == 0

    def restore(self, results):
        out = [None] * len(results)
        for pos, i in enumerate(self.order):
            out[i] = results[pos]
        return out


def _entries_keys(blob, num_limbs):
    """Raw point keys sliced out of a flat entry blob (entry = padded
    key ‖ length word): one struct read per key, zero numpy."""
    w = 4 * num_limbs + 4
    out = []
    for off in range(0, len(blob), w):
        (n,) = _LEN_WORD.unpack_from(blob, off + w - 4)
        out.append(blob[off:off + n])
    return out


def _entries_ranges(blob, num_limbs):
    """[(begin, end)] sliced out of a flat range blob (lower ‖ upper
    entry pairs)."""
    ks = _entries_keys(blob, num_limbs)
    return list(zip(ks[0::2], ks[1::2]))


def _entries_raw(blob, w):
    """Fixed-width entry slices, NOT decoded to keys. An entry (padded
    key ‖ length word) is order-isomorphic to its key — ``entry(a) <
    entry(b) ⟺ a < b`` — so when every request in the batch carries
    same-width flat blobs, the entries themselves serve as canonical
    keys for the hash and interval passes with zero per-key decode.
    0/1-entry blobs — the bulk of point traffic — skip the loop."""
    nb = len(blob)
    if nb == 0:
        return ()
    if nb == w:
        return (blob,)
    return [blob[o:o + w] for o in range(0, nb, w)]


def _conflict_sets(req, entry_w):
    """((read_points, read_ranges), (write_points, write_ranges)) for
    one request. ``entry_w`` non-None = the whole batch is flat at that
    entry width: points and range bounds stay as raw entry slices (one
    shared key-space — see ``_entries_raw``). Otherwise decode flat
    blobs to real keys, or split the legacy byte-pair lists (the point
    test mirrors proxy._split_ranges without building successors)."""
    f = getattr(req, "flat_conflicts", None)
    if f is not None and entry_w is not None:
        if f.read_ranges:
            rr = _entries_raw(f.read_range_blob, entry_w)
            rr = list(zip(rr[0::2], rr[1::2]))
        else:
            rr = ()
        if f.write_ranges:
            wr = _entries_raw(f.write_range_blob, entry_w)
            wr = list(zip(wr[0::2], wr[1::2]))
        else:
            wr = ()
        return (
            (_entries_raw(f.read_point_blob, entry_w), rr),
            (_entries_raw(f.write_point_blob, entry_w), wr),
        )
    if f is not None:
        return (
            (_entries_keys(f.read_point_blob, f.num_limbs),
             _entries_ranges(f.read_range_blob, f.num_limbs)),
            (_entries_keys(f.write_point_blob, f.num_limbs),
             _entries_ranges(f.write_range_blob, f.num_limbs)),
        )
    sides = []
    for ranges in (req.read_conflict_ranges, req.write_conflict_ranges):
        pts, rgs = [], []
        for b, e in ranges:
            if len(e) == len(b) + 1 and e[-1] == 0 and e.startswith(b):
                pts.append(b)
            else:
                rgs.append((b, e))
        sides.append((pts, rgs))
    return sides[0], sides[1]


def _overlaps(point_set, ranges, keys, key_ranges):
    """Does {keys ∪ key_ranges} intersect {point_set ∪ ranges}?"""
    for k in keys:
        if k in point_set:
            return True
        for b, e in ranges:
            if b <= k < e:
                return True
    for rb, re_ in key_ranges:
        for k in point_set:
            if rb <= k < re_:
                return True
        for b, e in ranges:
            if rb < e and b < re_:
                return True
    return False


def schedule(requests):
    """Order a commit batch to minimize self-inflicted aborts.

    Returns a :class:`SchedulePlan`, or None when the batch is too
    small, carries no read/write overlap at all, or exceeds the pass's
    work bounds (the caller keeps arrival order — always sound).
    """
    n = len(requests)
    if n < 2:
        return None
    # one shared key-space for the whole batch: raw entry slices when
    # every request is flat at the same width (zero per-key decode),
    # raw key bytes otherwise
    entry_w = None
    limbs = {getattr(r.flat_conflicts, "num_limbs", None)
             if getattr(r, "flat_conflicts", None) is not None else None
             for r in requests}
    if len(limbs) == 1 and None not in limbs:
        entry_w = 4 * limbs.pop() + 4
    reads = []
    writes = []
    n_ranges = 0
    for r in requests:
        rd, wr = _conflict_sets(r, entry_w)
        n_ranges += len(rd[1]) + len(wr[1])
        if n_ranges > MAX_RANGES:
            return None
        reads.append(rd)
        writes.append(wr)
    # per-key reader/writer indices (the hash pass), built once; edges
    # then come key-centric so keys read or written by only one side
    # cost nothing past the index insert
    readers_by_key = {}
    writers_by_key = {}
    range_writers = []  # [(begin, end, writer id)] — the interval pass
    for j in range(n):
        for k in reads[j][0]:
            lst = readers_by_key.get(k)
            if lst is None:
                readers_by_key[k] = [j]
            elif lst[-1] != j:
                lst.append(j)
        for k in writes[j][0]:
            lst = writers_by_key.get(k)
            if lst is None:
                writers_by_key[k] = [j]
            elif lst[-1] != j:
                lst.append(j)
        for b, e in writes[j][1]:
            range_writers.append((b, e, j))
    if not writers_by_key and not range_writers:
        return None
    # reader→writer precedence edges: reader i must resolve before any
    # j that writes a key i reads (i committing after j's write at the
    # shared commit version would be a guaranteed abort). MUTUAL pairs
    # — i and j both read-and-write the same key, the RMW clique — get
    # NO edge: exactly one member commits in every order, so an edge
    # buys nothing and a clique of them would otherwise force a cycle
    # break that scrambles arrival order for free.
    succ = [None] * n  # i -> set of writers that must come after i
    indeg = [0] * n
    n_edges = 0

    def add_edge(i, j):
        nonlocal n_edges
        ws = succ[i]
        if ws is None:
            ws = succ[i] = set()
        if j not in ws:
            ws.add(j)
            indeg[j] += 1
            n_edges += 1

    for k, writers in writers_by_key.items():
        readers = readers_by_key.get(k)
        if not readers:
            continue
        if len(readers) * len(writers) > MAX_KEY_FANOUT:
            continue  # hot clique: order cannot save its members
        wset = set(writers)
        rset = set(readers)
        for i in readers:
            i_rmw = i in wset
            for j in writers:
                if j != i and not (i_rmw and j in rset):
                    add_edge(i, j)
        if n_edges > MAX_EDGES:
            return None
    if range_writers or n_ranges:
        for i in range(n):
            rp, rrg = reads[i]
            for b, e, j in range_writers:
                if j != i and any(b <= k < e for k in rp):
                    add_edge(i, j)
            for rb, re_ in rrg:
                for b, e, j in range_writers:
                    if j != i and rb < e and b < re_:
                        add_edge(i, j)
                for k, writers in writers_by_key.items():
                    if rb <= k < re_:
                        for j in writers:
                            if j != i:
                                add_edge(i, j)
        if n_edges > MAX_EDGES:
            return None
    if n_edges == 0:
        return None
    # Kahn with arrival-index priority: the unique minimal reordering —
    # conflict-free batches come out in arrival order exactly
    ready = [i for i in range(n) if indeg[i] == 0]
    heapq.heapify(ready)
    order = []
    placed = [False] * n
    placed_writes = set()
    placed_range_writes = []
    deferred = 0
    cursor = 0  # arrival scan position for cycle breaking
    while len(order) < n:
        if ready:
            i = heapq.heappop(ready)
            if placed[i]:
                continue
        else:
            # cycle (an RMW clique): force the arrival-first unplaced
            # member — it commits; the rest of the cycle is doomed in
            # every order and counts below as deferred
            while placed[cursor]:
                cursor += 1
            i = cursor
        placed[i] = True
        order.append(i)
        rp, rrg = reads[i]
        if _overlaps(placed_writes, placed_range_writes, rp, rrg):
            # placed after a writer of its read set: this member will
            # abort this window and retry at the next commit version —
            # the "defer to the next window" outcome
            deferred += 1
        else:
            wp, wrg = writes[i]
            placed_writes.update(wp)
            placed_range_writes.extend(wrg)
        if succ[i]:
            for j in succ[i]:
                indeg[j] -= 1
                if indeg[j] == 0 and not placed[j]:
                    heapq.heappush(ready, j)
    reordered = sum(1 for pos, i in enumerate(order) if pos != i)
    return SchedulePlan(tuple(order), reordered, deferred)
