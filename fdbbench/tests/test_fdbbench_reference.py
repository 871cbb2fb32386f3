"""The reference and its judge on small hand-made conflict cases, and
the control: the reference with 16-bit version offsets is caught."""

import types

import numpy as np
import pytest

from fdbbench import reference as ref
from fdbbench import traffic

C, X, O = ref.COMMITTED, ref.CONFLICT, ref.TOO_OLD


def hand_pool(txns, reads, writes, lags):
    """A pool of hand-made batches: per batch per txn one read run and one
    write run of key ranks (lo, hi); an empty run is (0, 0)."""
    arr = lambda runs, k: np.array([[[r[k]] for r in b] for b in runs],
                                   dtype=np.int32)
    return types.SimpleNamespace(
        txns=txns, n_batches=len(reads), max_span=4,
        read_lo=arr(reads, 0), read_hi=arr(reads, 1),
        write_lo=arr(writes, 0), write_hi=arr(writes, 1),
        lags=np.array(lags, dtype=np.int64))


V = traffic.Versions(first=1000, per_batch=100, window=1000)


def judge(pool, statuses):
    j = ref.Judge(pool, V, n_keys=32)
    for i, s in enumerate(statuses):
        j.batch(i, s)
    return j.numbers()


# batch 0 commits at 1100: txn 0 writes key 5; txn 1 reads 5 (conflicts
# with txn 0); txn 2 reads 6..8 (free); txn 3 reads [4, 7) and writes 9
# (conflicts with txn 0). Batch 1 commits at 1200: txn 0 reads 5 at
# 1099 (before 1100: conflict), txn 1 reads 5 at 1199 (after: free),
# txn 2 reads 9 at 1050, which txn 3 of batch 0 never wrote (it aborted),
# txn 3 reads 6 at 100 (below the window start 200: too old).
POOL = hand_pool(
    4,
    reads=[[(0, 0), (5, 6), (6, 9), (4, 7)], [(5, 6), (5, 6), (9, 10), (6, 7)]],
    writes=[[(5, 6), (22, 23), (20, 21), (9, 10)],
            [(1, 2), (2, 3), (3, 4), (4, 5)]],
    lags=[[0, 0, 0, 0], [100, 0, 149, 1099]])
TRUTH = [[C, X, C, X], [X, C, C, O]]


def test_exact_decisions():
    got = ref.decide(POOL, V, 32, [0, 1])
    assert [g.tolist() for g in got] == TRUTH
    n = judge(POOL, TRUTH)
    assert n["unsound_commits"] == 0 and n["bad_statuses"] == 0
    assert n["false_conflict_pct"] == 0 and n["committed"] == 4


def test_commit_that_conflicts_is_unsound():
    s = [list(TRUTH[0]), list(TRUTH[1])]
    s[0][1] = C  # reads key 5 after txn 0 of its batch wrote it
    n = judge(POOL, s)
    assert n["unsound_commits"] == 1
    s = [list(TRUTH[0]), list(TRUTH[1])]
    s[1][0] = C  # reads key 5 below batch 0's write
    assert judge(POOL, s)["unsound_commits"] == 1


def test_false_conflicts_are_counted_and_judged_on_the_run_history():
    s = [list(TRUTH[0]), list(TRUTH[1])]
    s[0][2] = X  # a conservative abort: allowed, counted
    n = judge(POOL, s)
    assert n["unsound_commits"] == 0
    assert n["false_conflict_pct"] == pytest.approx(100 / 8)
    # had batch 0's txn 3 committed, batch 1's txn 2 would conflict on 9
    s = [[C, X, C, C], [X, C, C, O]]
    assert judge(POOL, s)["unsound_commits"] == 2  # txn 3 itself, and 9


def test_bad_statuses():
    s = [list(TRUTH[0]), list(TRUTH[1])]
    s[1][3] = C  # too old, yet committed
    assert judge(POOL, s)["bad_statuses"] == 1
    s = [list(TRUTH[0]), list(TRUTH[1])]
    s[0][0] = 7
    assert judge(POOL, s)["bad_statuses"] == 1
    assert judge(POOL, [TRUTH[0], None])["bad_statuses"] == 4
    assert judge(POOL, [TRUTH[0], TRUTH[1][:3]])["bad_statuses"] == 4


def test_control_in_16_bit_versions_is_caught():
    """The reference put in the program's place with its version offsets
    cut from 32 to 16 bits: its statuses fail the judge."""
    keys = traffic.KeySpace(20_000, 8)
    mix = {"draws": 1, "request_distribution": "zipfian",
           "ops": [{"side": "read", "shape": "point", "draw": 0},
                   {"side": "write", "shape": "point", "draw": 0}]}
    pool = traffic.Pool(keys, mix, 40, 256, (0, 4999), seed=11)
    v = traffic.Versions(10_000_000, 1024, 5_000_000)
    runs = list(range(120))
    for bits, caught in ((None, False), (16, True)):
        j = ref.Judge(pool, v, 20_000)
        for i, s in zip(runs, ref.decide(pool, v, 20_000, runs,
                                         version_bits=bits)):
            j.batch(i, s)
        n = j.numbers()
        assert (n["unsound_commits"] > 0) == caught, (bits, n)
        assert (n["false_conflict_pct"] > 1.0) == caught, (bits, n)
