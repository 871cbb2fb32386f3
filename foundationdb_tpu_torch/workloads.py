"""Seeded commit-batch streams for the Resolver: lists of
``(txns, commit_version, new_window_start)``, ready for
``Resolver.resolve`` or ``Resolver.resolve_many``.

The key model and mixes follow the repo's benchmark configurations
(BASELINE.json): ``user%08d`` keys, Zipfian key choice, a commit version
that advances by one per txn of each batch (FDB-style), read versions a
lag of up to ``lag`` versions behind the batch's commit version, and a
5-second MVCC window (5,000,000 versions).

- :func:`ycsb_a`: YCSB-A, 50/50 point read / point update.
- :func:`range_heavy`: 50% 8-key scans (range reads), 50% 4-key
  clearRange writes (range writes), Zipfian start keys.
- :func:`mixed`: up to 4 point reads, 4 point writes, 2 range reads and
  2 range writes per txn.

For the database (server/cluster.py), the same streams become client
commit requests (:func:`commit_requests`), and :func:`preload_requests`
loads ``user%08d`` rows as YCSB's 1 KB records (10 fields of 100 bytes)
in batches of blind sets.

Everything is drawn from ``numpy.random.default_rng(seed)``.
"""

import numpy as np

from foundationdb_tpu_torch.core import flatpack
from foundationdb_tpu_torch.core.commit import CommitRequest
from foundationdb_tpu_torch.core.mutations import Mutation, Op
from foundationdb_tpu_torch.core.versions import MAX_READ_TRANSACTION_LIFE_VERSIONS
from foundationdb_tpu_torch.resolver.skiplist import TxnRequest

NKEYS = 1_000_000
THETA = 0.99
FIRST_VERSION = 10_000_000
FIELDS, FIELD_BYTES = 10, 100  # a YCSB record: 10 fields of 100 bytes


def user_key(i):
    return b"user%08d" % i


def zipfian_cdf(nkeys, theta):
    """The cumulative distribution of Zipfian key ids over ``nkeys``."""
    w = 1.0 / np.arange(1, nkeys + 1, dtype=np.float64) ** theta
    return np.cumsum(w / w.sum())


def zipfian_sampler(nkeys, theta, rng, cdf=None):
    """n → int64[n] key ids, P(id = k) ∝ 1 / (k + 1)^theta. ``cdf`` (from
    :func:`zipfian_cdf`) lets many samplers share one table."""
    if cdf is None:
        cdf = zipfian_cdf(nkeys, theta)

    def sample(n):
        return np.minimum(np.searchsorted(cdf, rng.random(n)),
                          nkeys - 1).astype(np.int64)

    return sample


def _stream(nbatches, txns, seed, nkeys, theta, lag, make_txn_fields):
    """Drive ``make_txn_fields(rng, sample, T) → list of field dicts`` per
    batch and attach versions."""
    rng = np.random.default_rng(seed)
    sample = zipfian_sampler(nkeys, theta, rng)
    out = []
    cv = FIRST_VERSION
    for _ in range(nbatches):
        cv += txns
        lags = rng.integers(0, lag, txns)
        fields = make_txn_fields(rng, sample, txns)
        batch = [TxnRequest(read_version=cv - 1 - int(lg), **f)
                 for lg, f in zip(lags, fields)]
        out.append((batch, cv, max(0, cv - MAX_READ_TRANSACTION_LIFE_VERSIONS)))
    return out


def ycsb_a(nbatches, txns=1024, seed=0, nkeys=NKEYS, theta=THETA, lag=1000):
    """YCSB-A: each txn one point read or one point update, 50/50."""

    def fields(rng, sample, T):
        ids = sample(T)
        is_read = rng.random(T) < 0.5
        return [
            {"point_reads": [user_key(i)]} if r else
            {"point_writes": [user_key(i)]}
            for i, r in zip(ids.tolist(), is_read.tolist())
        ]

    return _stream(nbatches, txns, seed, nkeys, theta, lag, fields)


def _span(start, span, nkeys):
    return (user_key(start), user_key(min(start + span, nkeys - 1)))


def range_heavy(nbatches, txns=1024, seed=0, nkeys=NKEYS, theta=THETA,
                lag=1000, scan_span=8, clear_span=4):
    """Range-heavy: half 8-key scans, half 4-key clearRanges."""

    def fields(rng, sample, T):
        starts = sample(T)
        is_scan = rng.random(T) < 0.5
        return [
            {"range_reads": [_span(s, scan_span, nkeys)]} if sc else
            {"range_writes": [_span(s, clear_span, nkeys)]}
            for s, sc in zip(starts.tolist(), is_scan.tolist())
        ]

    return _stream(nbatches, txns, seed, nkeys, theta, lag, fields)


def mixed(nbatches, txns=1024, seed=0, nkeys=NKEYS, theta=THETA, lag=1000,
          max_span=8):
    """Mixed: 0-4 point reads, 0-4 point writes, 0-2 range reads and 0-2
    range writes per txn, each range 1..max_span keys wide."""

    def fields(rng, sample, T):
        counts = np.stack([rng.integers(0, 5, T), rng.integers(0, 5, T),
                           rng.integers(0, 3, T), rng.integers(0, 3, T)], 1)
        keys = iter(sample(int(counts.sum())).tolist())
        spans = iter(rng.integers(1, max_span + 1, int(counts[:, 2:].sum()))
                     .tolist())
        out = []
        for npr, npw, nrr, nrw in counts.tolist():
            out.append({
                "point_reads": [user_key(next(keys)) for _ in range(npr)],
                "point_writes": [user_key(next(keys)) for _ in range(npw)],
                "range_reads": [_span(next(keys), next(spans), nkeys)
                                for _ in range(nrr)],
                "range_writes": [_span(next(keys), next(spans), nkeys)
                                 for _ in range(nrw)],
            })
        return out

    return _stream(nbatches, txns, seed, nkeys, theta, lag, fields)


STREAMS = {"ycsb_a": ycsb_a, "range_heavy": range_heavy, "mixed": mixed}


def records(n, seed=0, record_bytes=FIELDS * FIELD_BYTES):
    """``n`` random YCSB records of ``record_bytes`` each."""
    blob = np.random.default_rng(seed).bytes(n * record_bytes)
    return [blob[i:i + record_bytes]
            for i in range(0, n * record_bytes, record_bytes)]


def _request(read_version, mutations, reads, writes, key_limbs):
    """A CommitRequest as a client builds it, with its flat blobs."""
    return CommitRequest(
        read_version, mutations, reads, writes,
        flat_conflicts=flatpack.encode_conflicts(reads, writes, key_limbs))


def preload_requests(nkeys, key_limbs, batch=1024, seed=0,
                     record_bytes=FIELDS * FIELD_BYTES):
    """Batches of blind-set CommitRequests loading ``user%08d`` rows
    0..nkeys-1 with random records (read-free: the proxy assigns their
    read version). A generator: one batch's records at a time."""
    for start in range(0, nkeys, batch):
        n = min(batch, nkeys - start)
        vals = records(n, seed=seed + start, record_bytes=record_bytes)
        out = []
        for i, v in zip(range(start, start + n), vals):
            k = user_key(i)
            out.append(_request(None, [Mutation(Op.SET, k, v)], [],
                                [(k, k + b"\x00")], key_limbs))
        yield out


def commit_requests(txns, commit_version, read_version, key_limbs, value):
    """A stream batch (``txns`` at ``commit_version``) as client commit
    requests: conflict ranges are the txn's (a point as ``[k, k+\\x00)``),
    mutations a set of ``value`` per point write and a clear of each
    range write. Each read lags ``read_version`` as far as the txn's
    lags its batch; a read-free txn leaves its read version to the
    proxy."""
    out = []
    for t in txns:
        reads = list(t.read_ranges())
        writes = list(t.write_ranges())
        muts = [Mutation(Op.SET, k, value) for k in t.point_writes]
        muts += [Mutation(Op.CLEAR_RANGE, b, e) for b, e in t.range_writes]
        rv = None
        if reads:
            rv = max(0, read_version - (commit_version - 1 - t.read_version))
        out.append(_request(rv, muts, reads, writes, key_limbs))
    return out
