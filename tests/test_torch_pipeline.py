"""The batching commit pipeline of the port against the JAX package's.

The JAX side runs ``foundationdb_tpu.server.cluster.Cluster(
commit_pipeline=..., **TEST_KNOBS)`` as its own tests do (its background
probe, history and scan daemons off, so nothing commits but the test);
the port side runs ``Cluster(device="cpu", ...)``. On deterministic
request streams — one ``_run_batch`` of the batcher, manual-mode pumps,
``commit_async`` / ``commit_finish`` — per-request outcomes (commit
version or error code), the final rows and the resolver's 12 state
fields must be identical (tolerance 0), at pipeline depths 1, 2 and 4,
on the flat and the legacy pack path, with the port's accept kernel on
and off (on the CPU, its plain version). Then the pipeline's faults,
GRV batching rounds, the version gates of a proxy fleet, and thread-mode
invariants under concurrent clients, which have no deterministic
interleaving to compare. Every wait has a timeout; every cluster is
closed in ``finally``.
"""

import functools
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from foundationdb_tpu.core import flatpack as jflat
from foundationdb_tpu.core.commit import CommitRequest as JRequest
from foundationdb_tpu.core.errors import FDBError as JError
from foundationdb_tpu.core.mutations import Mutation as JMutation
from foundationdb_tpu.core.mutations import Op as JOp
from foundationdb_tpu.resolver.resolver import ResolverDown as JResolverDown
from foundationdb_tpu.server import batcher as jbatcher
from foundationdb_tpu.server import grv as jgrv
from foundationdb_tpu.server import proxy as jproxy
from foundationdb_tpu.server.cluster import Cluster as JCluster
from foundationdb_tpu.server.sequencer import Sequencer as JSequencer
from foundationdb_tpu_torch.convert import state_to_numpy
from foundationdb_tpu_torch.core import flatpack as tflat
from foundationdb_tpu_torch.core.commit import CommitRequest as TRequest
from foundationdb_tpu_torch.core.errors import FDBError as TError
from foundationdb_tpu_torch.core.mutations import Mutation as TMutation
from foundationdb_tpu_torch.core.mutations import Op as TOp
from foundationdb_tpu_torch.resolver.resolver import ResolverDown as TResolverDown
from foundationdb_tpu_torch.server import batcher as tbatcher
from foundationdb_tpu_torch.server import grv as tgrv
from foundationdb_tpu_torch.server import proxy as tproxy
from foundationdb_tpu_torch.server.cluster import Cluster as TCluster
from foundationdb_tpu_torch.server.sequencer import Sequencer as TSequencer

from tests.conftest import TEST_KNOBS

torch.set_num_threads(1)

WAIT_S = 60  # every future and join is bounded by this


class Side:
    """One package's names, so each scenario is written once."""

    def __init__(self, name, cluster, request, flat, mutation, op, error,
                 resolver_down, batcher, grv, proxy, sequencer, state,
                 extra_knobs):
        self.name = name
        self.request = request
        self.flat = flat
        self.mutation = mutation
        self.op = op
        self.error = error
        self.resolver_down = resolver_down
        self.batcher = batcher
        self.grv = grv
        self.proxy = proxy
        self.sequencer = sequencer
        self.state = state
        self._cluster = cluster
        self._extra = extra_knobs

    def cluster(self, **kw):
        return self._cluster(**self._extra, **kw)


# the JAX cluster's thread-mode daemons commit probes and scan on their
# own clock: off, so the versions granted are the test's alone
JAX = Side("jax", JCluster, JRequest, jflat, JMutation, JOp, JError,
           JResolverDown, jbatcher, jgrv, jproxy, JSequencer,
           lambda c: [np.asarray(f) for f in c.resolvers[0].state],
           dict(health_probe_enabled=False, history_enabled=False,
                consistency_scan_enabled=False))
PORT = Side("port", TCluster, TRequest, tflat, TMutation, TOp, TError,
            TResolverDown, tbatcher, tgrv, tproxy, TSequencer,
            lambda c: list(state_to_numpy(c.resolvers[0].state)),
            dict(device="cpu"))

WINDOW = 12_000  # MVCC window: the stale read version leaves it, rv stays
PADS = 12  # commits between the stale and the fresh read version


def _pt(k):
    return (k, k + b"\x00")


def _request(side, knobs, rv, muts, reads, writes):
    flat = None
    if knobs.get("commit_pack_path", "flat") == "flat":
        flat = side.flat.encode_conflicts(sorted(reads), sorted(writes),
                                          knobs["key_limbs"])
    return side.request(rv, muts, sorted(reads), sorted(writes),
                        flat_conflicts=flat)


def _stream(side, c, knobs, n=40):
    """CommitRequests reaching every verdict, deterministically: blind
    writes (commit), same-rv read-modify-writes of one hot key (the
    first commits, the rest conflict), range reads over keys the stream
    writes, clear ranges (range writes into the ring), a read version
    older than the window (1007), and in each chunk a blind write
    followed by a read of its key, which commits only when the batch
    scheduler puts the read first."""
    db = c.database()
    db[b"hot"] = b"0"
    rv_old = c.grv_proxy.get_read_version()
    for i in range(PADS):
        db[b"pad%02d" % i] = b"x"
    rv = c.grv_proxy.get_read_version()
    S, O = side.mutation, side.op
    reqs = []
    for i in range(n):
        kind = i % 8
        k = b"k%02d" % i
        if kind == 7:
            reqs.append(_request(side, knobs, rv_old, [S(O.SET, k, b"s")],
                                 [_pt(b"hot")], [_pt(k)]))
        elif kind in (2, 3):
            reqs.append(_request(side, knobs, rv,
                                 [S(O.SET, b"hot", b"h%02d" % i)],
                                 [_pt(b"hot")], [_pt(b"hot")]))
        elif kind == 4:
            reqs.append(_request(side, knobs, rv, [S(O.SET, k, b"r")],
                                 [(b"k%02d" % (i - 6), b"k%02d" % (i - 1))],
                                 [_pt(k)]))
        elif kind == 5:
            b, e = b"k%02d" % (i - 13), b"k%02d" % (i - 10)
            reqs.append(_request(side, knobs, rv, [S(O.CLEAR_RANGE, b, e)],
                                 [], [(b, e)]))
        elif kind == 1:
            w = b"w%02d" % (i - 1)  # the blind write just before
            reqs.append(_request(side, knobs, rv, [S(O.SET, k, b"v")],
                                 [_pt(w)], [_pt(k)]))
        elif kind == 0:
            w = b"w%02d" % i
            reqs.append(_request(side, knobs, rv, [S(O.SET, w, b"w")], [],
                                 [_pt(w)]))
        else:
            reqs.append(_request(side, knobs, rv, [S(O.SET, k, b"v")], [],
                                 [_pt(k)]))
    return reqs


def _outcome(side, r):
    return ("err", r.code) if isinstance(r, side.error) else ("v", r)


def drive_run_batch(side, knobs, depth, backlog_target=4):
    """One thread-mode cluster, one deterministic ``_run_batch`` of the
    stream in chunks of 4, ``backlog_target`` chunks a group. Returns
    (outcomes, rows, state, groups that took the pipelined route)."""
    c = side.cluster(commit_pipeline="thread", commit_batch_max=4,
                     commit_pipeline_depth=depth, **knobs)
    try:
        bp = c.commit_proxy
        assert bp.pipeline_depth == depth
        reqs = _stream(side, c, knobs)
        bp._backlog_target = backlog_target
        pairs = [(r, side.batcher.CommitFuture(bp)) for r in reqs]
        bp._run_batch(pairs)
        bp.drain_pipeline()
        piped = bp.stages._count.get("apply", 0)
        outcomes = [_outcome(side, f.result(timeout=WAIT_S)) for _, f in pairs]
        rows = c.database().get_range(b"", b"\xff")
        return outcomes, rows, side.state(c), piped
    finally:
        c.close()


def _knobs(pack_path, **kw):
    return dict(TEST_KNOBS, commit_pack_path=pack_path,
                max_read_transaction_life_versions=WINDOW, **kw)


@functools.lru_cache(maxsize=None)
def _jax_run_batch(pack_path, depth):
    return drive_run_batch(JAX, _knobs(pack_path), depth)


@pytest.mark.parametrize("accept_kernel", ["on", "off"])
@pytest.mark.parametrize("pack_path", ["flat", "legacy"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_run_batch_matches_jax(depth, pack_path, accept_kernel):
    want = _jax_run_batch(pack_path, depth)
    got = drive_run_batch(PORT, _knobs(pack_path, accept_kernel=accept_kernel),
                          depth)
    assert got[0] == want[0]
    assert got[1] == want[1]
    for i, (a, b) in enumerate(zip(got[2], want[2])):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"state field {i}"
    codes = {o[1] for o in got[0] if o[0] == "err"}
    assert {1007, 1020} <= codes and any(o[0] == "v" for o in got[0])
    # depth > 1 must really take the pipelined route, not the serial one
    assert (got[3] > 0) == (depth > 1) and got[3] == want[3]
    # the scheduler put each chunk's reader before its writer
    assert all(got[0][i][0] == "v" for i in range(1, 40, 8))


@functools.lru_cache(maxsize=None)
def _jax_unscheduled():
    return drive_run_batch(JAX, _knobs("flat", commit_batch_scheduling=False),
                           2)


def test_scheduling_off_matches_jax():
    """commit_batch_scheduling=False commits each batch in arrival
    order, as the JAX package does: the reader after its writer fails."""
    want = _jax_unscheduled()
    got = drive_run_batch(PORT, _knobs("flat", commit_batch_scheduling=False),
                          2)
    assert got[:2] == want[:2]
    for a, b in zip(got[2], want[2]):
        assert np.array_equal(a, b)
    assert all(got[0][i] == ("err", 1020) for i in range(1, 40, 8))


# ── manual mode and commit_async, on both packages ──

def _manual_script(side):
    """Manual mode: submissions wait for ``pump`` until ``flush_after``
    steps pass (or the batch fills); a synchronous ``commit`` flushes at
    once with every pending submission riding along."""
    knobs = _knobs("flat")
    c = side.cluster(commit_pipeline="manual", commit_batch_max=4,
                     commit_flush_after=2, commit_pipeline_depth=8, **knobs)
    try:
        bp = c.commit_proxy
        assert bp.pipeline_depth == 1 and bp._apply_thread is None
        rv = c.grv_proxy.get_read_version()
        S, O = side.mutation, side.op

        def req(k, reads=()):
            return _request(side, knobs, rv, [S(O.SET, k, b"m")],
                            list(reads), [_pt(k)])

        log = []
        futs = [bp.submit(req(b"a%d" % i)) for i in range(3)]
        for step in range(3):  # due at step 2: flush_after steps passed
            bp.pump(step)
            log.append([f.done() for f in futs])
        log.append([_outcome(side, f.result(timeout=0)) for f in futs])
        futs = [bp.submit(req(b"b%d" % i)) for i in range(2)]
        log.append([f.done() for f in futs])
        log.append(_outcome(side, bp.commit(req(b"a0"))))
        log.append([_outcome(side, f.result(timeout=0)) for f in futs])
        # reads of a1 at the stale rv: a1 committed after it, 1020
        futs = [bp.submit(req(b"c%d" % i, [_pt(b"a1")] if i % 2 else ()))
                for i in range(5)]
        bp.pump(10)  # 5 pending >= max_batch 4: due at once
        log.append([_outcome(side, f.result(timeout=0)) for f in futs])
        log.append((bp.batches_committed, bp.txns_batched, bp.max_batch_seen))
        return log, c.database().get_range(b"", b"\xff"), side.state(c)
    finally:
        c.close()


def test_manual_mode_pump_and_riding_commit_match_jax():
    got, want = _manual_script(PORT), _manual_script(JAX)
    assert got[0] == want[0] and got[1] == want[1]
    for a, b in zip(got[2], want[2]):
        assert np.array_equal(a, b)
    log = got[0]
    assert log[0] == [False] * 3 and log[2] == [True] * 3
    assert len({o for o in log[3]}) == 1  # one shared version
    assert log[4] == [False, False]
    # the riding commit and both pending submissions share a batch
    assert log[5][0] == "v" and set(log[6]) == {log[5]}
    assert {o[0] for o in log[7]} == {"v", "err"}


def _async_script(side):
    c = side.cluster(commit_pipeline="manual", **_knobs("flat"))
    try:
        db = c.database()
        db[b"a"] = b"0"
        out = []
        t1 = db.create_transaction()
        t1.get(b"a")
        t1.set(b"a", b"1")
        f1 = t1.commit_async()
        with pytest.raises(side.error) as ei:
            t1.set(b"x", b"y")  # in flight: used_during_commit
        out.append(ei.value.code)
        with pytest.raises(side.error):
            t1.commit_async()
        t2 = db.create_transaction()
        t2.set(b"blind", b"w")
        f2 = t2.commit_async()
        t3 = db.create_transaction()
        out.append(t3.get(b"a"))
        f3 = t3.commit_async()  # read-only: settled at once, standalone
        out.append((f3.done(), f3.result(), f3._proxy is None))
        t3.commit_finish(f3)
        t4 = db.create_transaction()
        t4.get(b"a")
        t4.set(b"a", b"4")
        f4 = t4.commit_async()
        out.append([f.done() for f in (f1, f2, f4)])
        c.commit_proxy.flush()
        for tr, f in ((t1, f1), (t2, f2), (t4, f4)):
            try:
                tr.commit_finish(f)
                out.append(("v", tr.get_committed_version()))
            except side.error as e:
                out.append(("err", e.code))
        out.append(db[b"a"])
        return out
    finally:
        c.close()


def test_commit_async_and_finish_match_jax():
    got, want = _async_script(PORT), _async_script(JAX)
    assert got == want
    assert got[0] == 2017 and got[2] == (True, None, True)
    assert got[3] == [False, False, False]
    assert got[4][0] == "v" and got[4] == got[5] and got[6] == ("err", 1020)


# ── faults (the JAX package's tests/test_commit_pipeline.py) ──

def _gated_pipelined_cluster(side, log_gate_start_delta=0):
    """A one-proxy pipelined cluster with version gates attached, so owed
    turns are observable; ``log_gate_start_delta=-1`` wedges the log
    gate (a turn no one will take: a dead peer)."""
    c = side.cluster(commit_pipeline="thread", commit_batch_max=1,
                     commit_pipeline_depth=2, **_knobs("flat"))
    c.database()[b"seed"] = b"0"
    inner = c.commit_proxy.inner
    start = c.sequencer.committed_version
    inner.resolve_gate = side.proxy.VersionGate(start, timeout=2.0)
    inner.log_gate = side.proxy.VersionGate(start + log_gate_start_delta,
                                            timeout=0.5)
    return c


def _blind(side, c, prefix, n):
    rv = c.grv_proxy.get_read_version()
    knobs = _knobs("flat")
    return [_request(side, knobs, rv,
                     [side.mutation(side.op.SET, b"%s%02d" % (prefix, i), b"v")],
                     [], [_pt(b"%s%02d" % (prefix, i))]) for i in range(n)]


def _resolver_down_script(side):
    c = _gated_pipelined_cluster(side)
    try:
        bp = c.commit_proxy
        inner = bp.inner
        res = c.resolvers[0]
        orig = res.resolve_many
        calls = {"n": 0}

        def flaky(batches, lazy=False):
            calls["n"] += 1
            if calls["n"] == 2:  # the second in-flight group's dispatch
                raise side.resolver_down()
            return orig(batches, lazy=lazy)

        res.resolve_many = flaky
        bp._backlog_target = 2
        pairs = [(r, side.batcher.CommitFuture(bp))
                 for r in _blind(side, c, b"f", 6)]
        bp._run_batch(pairs)  # groups of 2: ok, ResolverDown, ok
        bp.drain_pipeline()
        results = [f.result(timeout=WAIT_S) for _, f in pairs]
        out = [_outcome(side, r) for r in results]
        last_cv = max(r for r in results if not isinstance(r, side.error))
        assert inner.log_gate._v >= last_cv
        assert inner.resolve_gate._v >= last_cv
        assert inner.alive
        return out, c.database().get_range(b"", b"\xff")
    finally:
        c.close()


def test_resolver_down_mid_pipeline_settles_all_and_consumes_turns():
    got, want = _resolver_down_script(PORT), _resolver_down_script(JAX)
    assert got == want
    out = got[0]
    assert all(o[0] == "v" for o in out[:2])
    assert out[2:4] == [("err", 1020)] * 2
    # the failed group's owed log turn was consumed: the last group
    # still committed (it would answer 1021 from a stuck gate otherwise)
    assert all(o[0] == "v" for o in out[4:])


def _wedged_gate_script(side):
    c = _gated_pipelined_cluster(side, log_gate_start_delta=-1)
    try:
        bp = c.commit_proxy
        bp._backlog_target = 2
        pairs = [(r, side.batcher.CommitFuture(bp))
                 for r in _blind(side, c, b"w", 4)]
        t0 = time.monotonic()
        bp._run_batch(pairs)
        bp.drain_pipeline()
        out = [_outcome(side, f.result(timeout=WAIT_S)) for _, f in pairs]
        assert time.monotonic() - t0 < 20  # answers, does not hang
        return out, bp.inner.alive
    finally:
        c.close()


def test_wedged_gate_mid_pipeline_answers_1021_not_hangs():
    got, want = _wedged_gate_script(PORT), _wedged_gate_script(JAX)
    assert got == want
    assert got == ([("err", 1021)] * 4, False)  # the proxy marked itself dead


def test_manual_mode_forces_depth_one():
    for side in (PORT, JAX):
        c = side.cluster(commit_pipeline="manual", commit_pipeline_depth=8,
                         **TEST_KNOBS)
        try:
            assert c.commit_proxy.pipeline_depth == 1
            assert c.commit_proxy._apply_thread is None
        finally:
            c.close()


def test_batcher_exception_settles_1021_and_is_not_retried():
    """A failure inside the inner proxy settles the whole batch as 1021
    (the outcome is unknown), is kept in ``last_batch_error``, runs no
    resolve on another device, and the batcher commits afterwards."""
    c = TCluster(device="cpu", commit_pipeline="thread", **TEST_KNOBS)
    try:
        db = c.database()
        db[b"a"] = b"1"
        inner = c.commit_proxy.inner
        before = dict(c.resolvers[0].counters)
        boom = RuntimeError("injected")

        def fail(*a, **kw):
            raise boom

        for name in ("commit_batch", "commit_batches", "commit_batches_begin"):
            setattr(inner, name, fail)
        tr = db.create_transaction()
        tr[b"a"] = b"2"
        with pytest.raises(TError) as ei:
            tr.commit()
        assert ei.value.code == 1021 and ei.value.is_retryable
        assert c.commit_proxy.last_batch_error is boom
        assert c.resolvers[0].counters == before  # nothing was resolved
        assert c.resolvers[0].device == torch.device("cpu")
        for name in ("commit_batch", "commit_batches", "commit_batches_begin"):
            delattr(inner, name)
        db[b"a"] = b"3"
        assert db[b"a"] == b"3"
    finally:
        c.close()


def test_thread_pipeline_without_a_card_raises():
    """No fallback: with no card visible, a thread-mode Cluster and
    open(commit_pipeline="thread") raise; only device="cpu" runs on the
    CPU. In a subprocess with CUDA_VISIBLE_DEVICES="", so it holds on
    any machine."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import threading\n"
        "import foundationdb_tpu_torch as fdb\n"
        "from foundationdb_tpu_torch.server.cluster import Cluster\n"
        "for f in (lambda: Cluster(commit_pipeline='thread'),\n"
        "          lambda: fdb.open(commit_pipeline='thread'),\n"
        "          lambda: Cluster(commit_pipeline='thread',\n"
        "                          n_commit_proxies=3)):\n"
        "    try:\n"
        "        f()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no error without a card')\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "db = fdb.open(device='cpu', commit_pipeline='thread',\n"
        "              batch_txn_capacity=8, hash_table_bits=10,\n"
        "              range_ring_capacity=16, coarse_buckets_bits=6)\n"
        "db[b'k'] = b'v'\n"
        "assert db[b'k'] == b'v'\n"
        "db._cluster.close()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ── GRV batching rounds, driven without threads ──

def _grv_rounds(side, seed):
    """A seeded schedule of enqueues, commits, admission switches and
    grant rounds on a threadless batching GRV proxy. Both packages'
    proxies take the same switch as their ratekeeper. Returns each
    round's view of every request."""
    rng = random.Random(seed)
    seq = side.sequencer()
    seq.report_committed(seq.next_commit_versions(1)[0][1])
    allow = {"on": True}

    class Gate:  # a ratekeeper that only admits
        def admit(self, priority):
            return allow["on"]

    bp = side.grv.BatchingGrvProxy(side.grv.GrvProxy(seq, Gate()),
                                   start_thread=False)
    now, futs, log = 100.0, [], []
    for _ in range(60):
        if rng.random() < 0.6:
            fut = bp._make_future(rng.choice(["default", "batch"]), born=now)
            with bp._lock:
                bp._queues["batch" if fut["priority"] == "batch"
                           else "default"].append(fut)
                bp._pending += 1
            futs.append(fut)
        if rng.random() < 0.3:
            seq.report_committed(seq.next_commit_versions(1)[0][1])
        if rng.random() < 0.25:
            allow["on"] = not allow["on"]
        if rng.random() < 0.5:
            now += rng.choice([0.1, 0.4, 1.1, 2.5])
            granted = bp._grant_round(now=now)
            log.append((granted, tuple(
                (f["event"].is_set(), f["value"],
                 f["error"].code if f["error"] else None, f["waited"])
                for f in futs)))
    allow["on"] = True
    bp._grant_round(now=now)
    log.append((bp.batches_granted, bp.delayed_count, bp.max_round,
                bp.grv_count, bp._pending,
                [(f["value"], f["error"] and f["error"].code) for f in futs]))
    return log


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_grv_grant_rounds_match_jax(seed):
    got, want = _grv_rounds(PORT, seed), _grv_rounds(JAX, seed)
    assert got == want
    final = got[-1]
    assert final[4] == 0  # nothing left queued
    codes = {e for _, e in final[5]}
    assert None in codes and 1037 in codes  # granted, and aged out
    assert final[1] > 0  # some waited a round and were granted later
    assert _grv_rounds(PORT, seed) == got  # the schedule replays exactly


def test_grv_round_grants_fifo_default_first_one_version():
    seq = TSequencer()
    seq.report_committed(seq.next_commit_versions(1)[0][1])
    bp = tgrv.BatchingGrvProxy(tgrv.GrvProxy(seq), start_thread=False)
    order = []
    futs = []
    for i, prio in enumerate(["batch", "default", "batch", "default"]):
        fut = bp._make_future(prio, born=0.0)
        fut["event"] = _Recorder(order, i)
        with bp._lock:
            bp._queues[prio].append(fut)
            bp._pending += 1
        futs.append(fut)
    assert bp._grant_round(now=0.0)
    assert order == [1, 3, 0, 2]  # default queue first, FIFO in each
    assert {f["value"] for f in futs} == {seq.committed_version}
    assert bp.batches_granted == 1 and bp.max_round == 4 and bp._pending == 0


class _Recorder:
    """An Event stand-in recording the order requests are released."""

    def __init__(self, order, i):
        self._order, self._i = order, i

    def set(self):
        self._order.append(self._i)

    def is_set(self):
        return self._i in self._order


# ── sequencer chaining and the fleet's version gates ──

def test_chained_grants_form_one_serial_order_under_threads():
    s = TSequencer()
    out, mu = [], threading.Lock()

    def grab():
        for _ in range(50):
            got = s.next_commit_versions(2)
            with mu:
                out.extend(got)

    ts = [threading.Thread(target=grab, daemon=True) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT_S)
    out.sort(key=lambda pv: pv[1])
    assert len(out) == 800
    for (_, v0), (p1, v1) in zip(out, out[1:]):
        assert p1 == v0 and v1 > v0  # one global chain, no overlap
    s.kill()
    with pytest.raises(tproxy.SequencerDown):
        s.next_commit_versions(1)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_version_gate_orders_adversarial_schedules(seed):
    """Threads holding shuffled (prev, v) grants pass the gate in
    version order whatever the arrival schedule."""
    rng = random.Random(seed)
    grants = TSequencer().next_commit_versions(16)
    gate = tproxy.VersionGate(0, timeout=10.0)
    order, mu = [], threading.Lock()
    shuffled = grants[:]
    rng.shuffle(shuffled)

    def worker(prev, v, delay):
        time.sleep(delay)
        gate.enter(prev)
        with mu:
            order.append(v)
        gate.advance(v)

    ts = [threading.Thread(target=worker, args=(p, v, rng.random() * 0.02),
                           daemon=True) for p, v in shuffled]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT_S)
    assert order == [v for _, v in grants]
    with pytest.raises(tproxy.GateTimeout):
        tproxy.VersionGate(0, timeout=0.05).enter(5)


def _fleet_script(side):
    """Commits through specific members of a 3-proxy sync fleet, in a
    fixed order: the chained versions, outcomes and rows."""
    c = side.cluster(n_commit_proxies=3, gate_timeout_s=2.0, **_knobs("flat"))
    try:
        cp = c.commit_proxy
        assert len(cp) == 3 and cp.inner is cp
        out = []
        for i in range(9):
            reqs = _blind(side, c, b"m%d" % i, 2)
            out.append([_outcome(side, r) for r in
                        cp.inners[i % 3].commit_batch(reqs)])
        out.append([[_outcome(side, r) for r in res] for res in
                    cp.commit_batches([_blind(side, c, b"z", 2)] * 3)])
        out.append((cp.commit_count, cp.conflict_count))
        return out, c.database().get_range(b"", b"\xff"), side.state(c)
    finally:
        c.close()


def test_fleet_members_share_one_version_order_matching_jax():
    got, want = _fleet_script(PORT), _fleet_script(JAX)
    assert got[0] == want[0] and got[1] == want[1]
    for a, b in zip(got[2], want[2]):
        assert np.array_equal(a, b)


# ── thread mode under concurrent clients (no interleaving to compare) ──

def _run_threads(fn, n):
    """``fn(i)`` on ``n`` threads with a short switch interval, so lost
    updates between threads would show; every join is bounded."""
    errors = []

    def body(i):
        try:
            fn(i)
        except BaseException as e:  # surfaced below
            errors.append(e)

    ts = [threading.Thread(target=body, args=(i,), daemon=True)
          for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts), "a client thread hung"
    assert not errors, errors[0]


def test_thread_mode_concurrent_range_reads_stay_consistent():
    """Writers move amounts between accounts (the sum stays 1000) while
    readers scan every account: each scan sees a consistent snapshot."""
    c = TCluster(device="cpu", commit_pipeline="thread", **TEST_KNOBS)
    try:
        db = c.database()
        accts = [b"acct%02d" % i for i in range(10)]
        db.run(lambda tr: [tr.set(k, b"100") for k in accts])
        sums = []

        def writer(i):
            rng = random.Random(i)
            for _ in range(15):
                a, b = rng.sample(accts, 2)

                def move(tr):
                    x, y = int(tr[a]), int(tr[b])
                    tr[a], tr[b] = b"%d" % (x - 1), b"%d" % (y + 1)

                db.run(move)

        def reader(i):
            for _ in range(15):
                rows = db.get_range(b"acct", b"acct\xff")
                sums.append((len(rows), sum(int(v) for _, v in rows)))

        _run_threads(lambda i: (writer if i < 4 else reader)(i), 8)
        assert sums and set(sums) == {(10, 1000)}
        assert sum(int(db[k]) for k in accts) == 1000
        assert c.commit_proxy.batches_committed > 0
    finally:
        c.close()


def test_thread_mode_fleet_rmw_increments_are_exact():
    c = TCluster(device="cpu", commit_pipeline="thread", n_commit_proxies=3,
                 gate_timeout_s=10.0, **TEST_KNOBS)
    try:
        db = c.database()
        keys = [b"ctr%d" % i for i in range(4)]

        def client(i):
            for j in range(15):
                k = keys[(i + j) % 4]

                def inc(tr):
                    v = tr[k]
                    tr[k] = b"%d" % ((int(v) if v is not None else 0) + 1)

                db.run(inc)

        _run_threads(client, 8)
        assert sum(int(db[k]) for k in keys) == 8 * 15
        cp = c.commit_proxy
        assert all(p.commit_count > 0 for p in cp.inners)
        assert cp.commit_count >= 8 * 15
        st = c.status()["cluster"]
        assert st["commit_pipeline"] == "thread"
        assert st["processes"]["commit_proxy"]["count"] == 3
        assert st["processes"]["grv_proxy"]["count"] == 3
    finally:
        c.close()
    assert not any(t.name in ("commit-batcher", "commit-apply", "grv-batcher")
                   and t.is_alive() for t in threading.enumerate())
