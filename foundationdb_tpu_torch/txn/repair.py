"""Client-side transaction repair: a conflicted txn fixed, not rerun.

Ref: "Repairing Conflicts among MVCC Transactions" (arxiv 1603.00542),
as the JAX package's ``txn/repair.py`` does it. An OCC-rejected
transaction usually failed on a handful of conflicting writes; the rest
of what it read is still valid. The engine records the attempt's
operation log: every storage-backed point read (key → value) and range
read (signature → rows). A 1020 from a commit with
``report_conflicting_keys`` (forced on while repair is on) carries the
conflicting read ranges and ``conflict_version``, the commit version
whose writes rejected the txn:

- a read NOT in the report was checked by the resolver against every
  write in ``(read_version, conflict_version]`` and found clean: its
  recorded value equals its value at conflict_version;
- the conflicting reads are re-read, only them, at conflict_version.

That rebuilds a consistent snapshot at conflict_version with no GRV.
Then either every refreshed value equals the recorded one (a spurious
conflict): the op log **replays** verbatim — the mutations and conflict
ranges stay, the read version moves to conflict_version, and the retry
loop resubmits without running the body (``Transaction.repair_ready``);
or a value moved: the body re-runs (**fallback**) at conflict_version
from the verified read cache, without a backoff, for up to
``txn_repair_max_rounds`` rounds in a row.

Every resubmission carries its full read conflict ranges, and the
resolver checks ``(conflict_version, new commit version]`` as usual:
repair changes where the reads come from, never what is declared read.
Outcomes are counted on the commit proxy (``repair_attempts``,
``repair_commits``, ``repair_fallbacks``).
"""

from foundationdb_tpu_torch.core.errors import FDBError


class RepairEngine:
    """One attempt's operation log: storage-backed reads by key (point)
    and by call signature (range), and whether it may replay."""

    __slots__ = ("point_reads", "range_reads", "unreplayable", "rounds")

    def __init__(self, rounds=0):
        self.point_reads = {}  # key -> value as first read this attempt
        self.range_reads = {}  # (b, e, limit, reverse) -> tuple(rows)
        # reads the engine cannot verify at a later version (selector
        # resolution): the op log still seeds the fallback rerun, but
        # never replays
        self.unreplayable = False
        self.rounds = rounds  # repair rounds this txn spent in a row


def _overlaps_point(key, ranges):
    for b, e in ranges:
        if b <= key < e:
            return True
    return False


def _overlaps_span(begin, end, ranges):
    for b, e in ranges:
        if b < end and begin < e:
            return True
    return False


def note(cluster, name, n=1):
    """Count a repair outcome on the commit proxy this client talks to
    (a fleet's first member, as the reference does)."""
    if n <= 0:
        return
    cluster._inner_proxies()[0].note_repair(name, n)


def attempt(tr, error):
    """The ``Transaction.on_error`` repair hook: True when the txn was
    repaired (replay-ready or cache-seeded, read version moved, no
    backoff owed), False when the caller must restart it cold."""
    eng = tr._repair
    if eng is None or error.code != 1020:
        return False
    ranges = getattr(error, "conflicting_key_ranges", None)
    cv = getattr(error, "conflict_version", None)
    if ranges is None or cv is None:
        return False  # a blanket 1020 (a dead resolver): no repair basis
    # the port has no special keys, so no management writes to guard
    if tr._watches_pending:
        return False  # watch txns restart cold
    rounds = eng.rounds + 1
    if rounds > tr._knobs.txn_repair_max_rounds:
        return False  # the livelock bound: back to the honest backoff
    note(tr._cluster, "repair_attempts")
    # re-read ONLY the conflicting keys, at exactly the version whose
    # writes rejected us; everything else the resolver proved unchanged
    cache = {}
    digest_ok = not eng.unreplayable
    try:
        for k, v0 in eng.point_reads.items():
            if _overlaps_point(k, ranges):
                v1 = tr._cluster.read_storage(k).get(k, cv)
                cache[k] = v1
                if v1 != v0:
                    digest_ok = False
            else:
                cache[k] = v0
        range_cache = {}
        for sig, rows0 in eng.range_reads.items():
            b, e, limit, reverse = sig
            if _overlaps_span(b, e, ranges):
                st = tr._cluster.read_storage(b)
                rows1 = tuple(st.get_range(b, e, cv, limit=limit,
                                           reverse=reverse))
                range_cache[sig] = rows1
                if rows1 != rows0:
                    digest_ok = False
            else:
                range_cache[sig] = rows0
    except FDBError:
        # the refresh itself failed (conflict_version not readable on the
        # storage, or already out of its window): restart cold
        return False
    if digest_ok:
        # spurious conflict: keep writes, mutations and conflict ranges;
        # only the read version moves. The retry loop sees
        # ``repair_ready`` and resubmits without running the body.
        eng.rounds = rounds
        eng.point_reads.update(cache)
        eng.range_reads.update(range_cache)
        tr._read_version = cv
        tr._state = "active"
        tr._repair_ready = True
        tr._repair_assisted = True
        return True
    # a value moved: the recorded writes may embed stale reads, so the
    # body re-runs, seeded. The cold restart's keep-set, minus the sleep.
    note(tr._cluster, "repair_fallbacks")
    keep = (tr._retries, tr._backoff, tr._retry_limit, tr._max_retry_delay)
    tr._reset()
    (tr._retries, tr._backoff, tr._retry_limit, tr._max_retry_delay) = keep
    tr._repair = RepairEngine(rounds=rounds)
    tr._read_version = cv
    tr._repair_cache = cache
    tr._repair_range_cache = range_cache
    tr._repair_assisted = True
    return True
