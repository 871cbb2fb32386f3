"""The port's ratekeeper and the admission it gates against the JAX
package's: the same seeded sequences of admissions, tag gates, commit
observations, control rounds under storage lag, quotas and clock
advances under one injected clock give the same answers, budgets, tag
limits and status fields; the GRV proxies raise the same 1037
(process_behind) and 1213 (tag_throttled), the commit proxy admits
read-free requests alike under a constrained budget, and a busy tag is
throttled alike (tolerance 0).
"""

import numpy as np
import pytest

from tests.conftest import TEST_KNOBS
from tests.torch_sides import JAX, PORT, outcome, request, results

TAGS = ("hog", "web", "batch-job")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _rk_fields(rk):
    return (rk.target_tps, rk.max_tps, rk.throttled_count,
            rk.tag_throttled_count, dict(rk.tag_limits),
            dict(rk.tag_quotas), rk.throttled_tags(), dict(rk.tag_busyness),
            rk._tokens)


def _status(rk):
    doc = rk.status()
    m = doc["metrics"]
    return m["counters"], m["gauges"], doc.get("tag_busyness")


def _admissions(side, seed):
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    rk = side.ratekeeper(target_tps=float(rng.choice([50, 400, 1e9])),
                         clock=clock,
                         tag_busy_threshold=float(rng.choice([1.0, 0.4])))
    soft, hard = rk.LAG_SOFT, rk.LAG_HARD
    out = []
    for _ in range(600):
        clock.advance(float(rng.choice([0.0, 0.001, 0.01, 0.2])))
        op = rng.integers(20)
        tags = tuple(sorted({TAGS[i] for i in rng.integers(3, size=int(
            rng.integers(0, 3)))}))
        prio = str(rng.choice(["default", "default", "batch", "immediate"]))
        if op < 10:
            out.append(rk.admit_with_reason(prio, tags))
        elif op < 12:
            out.append(rk.tag_gate(tags))
        elif op == 12:
            rk.note_untagged_admissions(int(rng.integers(1, 20)))
        elif op == 13:
            n = int(rng.integers(1, 200))
            rk.observe_commit(n, int(rng.integers(0, n + 1)))
        elif op == 14:
            lag = int(rng.choice([0, soft, (soft + hard) // 2, hard]))
            out.append(rk.update(storage_lag_versions=lag))
        elif op == 15:
            tps = rng.choice([None, 1.0, 20.0])
            rk.set_tag_quota(TAGS[rng.integers(3)],
                             None if tps is None else float(tps))
        elif op == 16 and rng.random() < 0.2:
            rk.set_target_tps(float(rng.choice([30, 300, 1e9])))
        else:
            out.append(rk.admit(prio, tags))
        if op in (13, 14, 15):
            out.append(_rk_fields(rk))
    out.append(_status(rk))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_admission_sequences_match_jax(seed):
    want, got = _admissions(JAX, seed), _admissions(PORT, seed)
    assert got == want
    answers = [a for a in got if isinstance(a, tuple) and len(a) == 2]
    assert (True, None) in answers


def _grv(side):
    """GrvProxy: 1037 for the budget, 1213 for a tag, immediate passes;
    BatchingGrvProxy: the tag gate on entry, the fast path, and grant
    rounds that hold a denied head, then age it out."""
    clock = FakeClock()
    seq = side.sequencer()
    seq.report_committed(seq.next_commit_versions(1)[0][1])
    rk = side.ratekeeper(target_tps=4.0, clock=clock)
    rk.set_tag_quota("hot", 2.0)
    grv = side.grv.GrvProxy(seq, rk)
    out = []
    for i in range(16):
        clock.advance(0.05)
        tags = ("hot",) if i % 3 == 0 else ()
        prio = "immediate" if i == 7 else "default"
        out.append(outcome(side, lambda: grv.get_read_version(prio, tags)))
    out.append(grv.grv_count)
    clock.advance(5.0)
    bp = side.grv.BatchingGrvProxy(side.grv.GrvProxy(seq, rk),
                                   start_thread=False)
    out.append(outcome(side, lambda: bp.get_read_version()))  # fast path
    for _ in range(3):
        out.append(outcome(side, lambda: bp.get_read_version(tags=("hot",))))
    futs = [bp._make_future("default", born=100.0) for _ in range(14)]
    with bp._lock:
        bp._queues["default"].extend(futs)
        bp._pending += len(futs)
    for now in (100.1, 101.0, 103.0):
        clock.advance(0.3)
        out.append((bp._grant_round(now=now), [
            (f["event"].is_set(), f["value"],
             f["error"].code if f["error"] else None, f["waited"])
            for f in futs]))
    out.append((bp.delayed_count, bp._pending, bp.inner.grv_count,
                rk.throttled_count, rk.tag_throttled_count))
    return out


def test_grv_proxies_raise_1037_and_1213_like_jax():
    want, got = _grv(JAX), _grv(PORT)
    assert got == want
    codes = [o[1] for o in got[:16] if o[0] == "err"]
    assert 1037 in codes and 1213 in codes
    # the batching proxy's tag gate: the refilled quota, then 1213
    assert got[18:21] == [got[18], got[19], ("err", 1213)]
    assert got[18][0] == "ok"


def _lazy_rv(side):
    """Read-free requests skip the GRV: under a constrained budget the
    commit proxy admits them (1037 when the bucket is empty), on the
    per-batch and the backlog route; a request with a read version
    passes."""
    clock = FakeClock()
    c = side.cluster(**dict(TEST_KNOBS, resolver_backend="cpu",
                            target_tps=5.0, rk_clock=clock))
    out = []
    for step in range(3):
        reqs = [request(side, None, sets=[(b"k%02d" % i, b"v%d" % step)])
                for i in range(8)]
        reqs.append(request(side, c.sequencer.committed_version,
                            sets=[(b"pinned", b"%d" % step)]))
        out.append(results(c.commit_proxy.commit_batch(reqs)))
        clock.advance(0.5)
        backlog = [[request(side, None, sets=[(b"b%d%d" % (step, j), b"x")])
                    for j in range(3)] for _ in range(3)]
        out.append([results(r) for r in
                    c._commit_target().commit_batches(backlog)])
        clock.advance(0.7)
    out.append(c.database().get_range(b"", b"\xff"))
    out.append((c.ratekeeper.throttled_count, c.ratekeeper._recent_admits))
    c.close()
    return out


def test_lazy_read_version_admission_matches_jax():
    want, got = _lazy_rv(JAX), _lazy_rv(PORT)
    assert got == want
    assert ("err", 1037) in got[0] and isinstance(got[0][-1], int)


def _lag(side):
    """The durability pump feeds the ratekeeper the lag it found before
    flushing; the budget squeezes under lag and trims under a conflict
    storm, then recovers."""
    c = side.cluster(**dict(TEST_KNOBS, resolver_backend="cpu",
                            target_tps=1000.0,
                            max_read_transaction_life_versions=5))
    rk = c.ratekeeper
    rk.LAG_SOFT, rk.LAG_HARD = 2000, 30_000
    proxy = c._commit_target()
    proxy.pump_interval = 10**9  # pumped by hand below
    out = []
    for rnd in range(6):
        rv = c.sequencer.committed_version
        reqs = [request(side, rv, sets=[(b"k%02d" % i, b"v")],
                        reads=[b"k%02d" % ((i + rnd) % 4)])
                for i in range(6)]
        for _ in range(3 if rnd < 3 else 1):
            out.append(results(c.commit_proxy.commit_batch(reqs)))
        window = max(0, c.sequencer.committed_version - 5)
        proxy._pump_durability(window if rnd % 2 else window // 2)
        out.append((rk.target_tps, [s.durable_version for s in c.storages]))
    out.append(_status(rk))
    c.close()
    return out


def test_update_under_storage_lag_matches_jax():
    want, got = _lag(JAX), _lag(PORT)
    assert got == want
    targets = [x[0] for x in got if isinstance(x, tuple)
               and isinstance(x[0], float)]
    assert min(targets) < 1000.0


def _busy_tag(side):
    """Clients of one busy tag among untagged ones, the standalone
    busy-tag policy on (tag_throttle_busyness=0.5): after a control
    round the tag has its own limit, its GRVs answer 1213 and the
    untagged ones do not."""
    clock = FakeClock()
    c = side.cluster(**dict(TEST_KNOBS, resolver_backend="cpu",
                            rk_clock=clock, tag_throttle_busyness=0.5))
    # the control round below is the only one (the durability pump runs
    # one every pump_interval batches, which would cut the window)
    c._commit_target().pump_interval = 10**9
    db = c.database()
    out = []

    def txn(i, tag):
        tr = db.create_transaction()
        if tag:
            tr.options.set_tag(tag)
        def body():
            tr.get(b"c%d" % (i % 5))
            tr.set(b"c%d" % (i % 5), b"%d" % i)
            tr.commit()
            return tr.get_committed_version()
        return outcome(side, body)

    for i in range(100):
        clock.advance(0.01)
        out.append(txn(i, "hog" if i % 5 else None))
    c.ratekeeper.update()
    out.append(_status(c.ratekeeper))
    for i in range(160):
        clock.advance(0.0002)
        out.append(txn(i, "hog" if i % 2 else None))
    out.append(c.status()["cluster"]["qos"])
    out.append(c.status()["cluster"]["processes"]["ratekeeper"])
    c.close()
    return out


def test_tag_auto_throttling_matches_jax():
    want, got = _busy_tag(JAX), _busy_tag(PORT)
    # the ratekeeper's status documents carry each package's own
    # registry fields beside the compared counters and gauges
    assert got[:-1] == want[:-1]
    for doc in (got[-1], want[-1]):
        doc["metrics"] = {k: doc["metrics"][k] for k in ("counters", "gauges")}
    assert got[-1] == want[-1]
    late = got[101:261]
    assert ("err", 1213) in late[1::2]  # the busy tag
    assert all(o[0] == "ok" for o in late[0::2])  # untagged traffic


def _tag_options(side):
    c = side.cluster(**dict(TEST_KNOBS, resolver_backend="cpu"))
    tr = c.database().create_transaction()
    out = [outcome(side, lambda: tr.options.set_tag("x" * 17)),
           outcome(side, lambda: tr.options.set_tag(b"\xfe\x01"))]
    for t in ("a", "b", "c", "d", "a"):
        out.append(outcome(side, lambda t=t: tr.options.set_tag(t)))
    out.append(outcome(side, lambda: tr.options.set_auto_throttle_tag("e")))
    out.append(list(tr._tags))
    out.append(outcome(side, tr.get_read_version))
    c.close()
    return out


def test_tag_options_match_jax():
    want, got = _tag_options(JAX), _tag_options(PORT)
    assert got == want
    assert got[0] == ("err", 2006) and got[7] == ("err", 2006)


def test_priority_options_reach_the_grv():
    """The port's GRV priorities (ref: PRIORITY_BATCH,
    PRIORITY_SYSTEM_IMMEDIATE): with the budget closed, an immediate
    transaction still gets a read version; a default one 1037s."""
    clock = FakeClock()
    c = PORT.cluster(**dict(TEST_KNOBS, resolver_backend="cpu",
                            target_tps=2.0, rk_clock=clock))
    db = c.database()
    got = []
    for prio in ("batch", "default", "default", "default", "immediate"):
        tr = db.create_transaction()
        if prio == "batch":
            tr.options.set_priority_batch()
        elif prio == "immediate":
            tr.options.set_priority_system_immediate()
        got.append(outcome(PORT, tr.get_read_version))
    c.close()
    # the batch request costs 1/0.5 = 2 tokens: the bucket's 2
    assert [o[0] for o in got] == ["ok", "err", "err", "err", "ok"]
    assert got[1] == ("err", 1037)
