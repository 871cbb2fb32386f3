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

Everything is drawn from ``numpy.random.default_rng(seed)``.
"""

import numpy as np

from foundationdb_tpu_torch.core.versions import MAX_READ_TRANSACTION_LIFE_VERSIONS
from foundationdb_tpu_torch.resolver.skiplist import TxnRequest

NKEYS = 1_000_000
THETA = 0.99
FIRST_VERSION = 10_000_000


def user_key(i):
    return b"user%08d" % i


def zipfian_sampler(nkeys, theta, rng):
    """n → int64[n] key ids, P(id = k) ∝ 1 / (k + 1)^theta."""
    w = 1.0 / np.arange(1, nkeys + 1, dtype=np.float64) ** theta
    cdf = np.cumsum(w / w.sum())

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
