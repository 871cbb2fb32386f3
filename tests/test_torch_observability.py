"""The port's observability modules against the JAX package's, at
tolerance 0: metric registries and latency bands, spans, heatmaps, the
device profile (with its route names mapped) and the metrics history.

Both sides run under one ``deterministic.seed`` and a clock that moves
only when the test ticks it (tests/torch_sides.py ``seeded``): the
reservoirs, the span ids and the sampling draw from the same named
streams, and every stamp is the same.
"""

import random

import pytest

from tests.conftest import TEST_KNOBS
from tests.test_torch_status import ROUTES, single_step_compiles
from tests.torch_sides import JAX, PORT, doc_diff, seeded

SIDES = (JAX, PORT)


# ── metric registries ────────────────────────────────────────────────

def _registry_script(side, n_samples, reservoir):
    m = side.metrics
    with seeded(side) as clock:
        reg = m.MetricsRegistry("commit_proxy", index=2)
        other = m.MetricsRegistry("commit_proxy", index=3)
        rng = random.Random(n_samples)
        for i in range(n_samples):
            reg.counter("txn_committed").inc(rng.randrange(1, 4))
            reg.latency("commit_e2e", reservoir=reservoir).record(
                rng.random() / 100)
            other.latency("commit_e2e", reservoir=reservoir).record(
                rng.random() / 50)
            if i % 7 == 0:
                reg.gauge("depth").set(i)
                other.counter("abort_not_committed").inc()
        clock.tick(2.5)
        before = reg.snapshot()
        merged = m.merged_bands_ms([reg.get_latency("commit_e2e"),
                                    other.get_latency("commit_e2e"), None])
        reg.absorb(other)
        m.set_enabled(False)
        reg.counter("txn_committed").inc(100)  # the kill switch holds it
        reg.latency("commit_e2e").record(9.0)
        m.set_enabled(True)
        return [before, merged, reg.snapshot(),
                m.merged_bands_ms([]), other.snapshot()]


@pytest.mark.parametrize("n_samples,reservoir",
                         [(10, 512), (700, 512), (300, 16)])
def test_registry_bands_and_merges_match_jax(n_samples, reservoir):
    """Counters, gauges, the reservoir's eviction draws (the
    "metrics-reservoir" stream), the bands, ``absorb``, the merged bands
    and the kill switch."""
    want = _registry_script(JAX, n_samples, reservoir)
    got = _registry_script(PORT, n_samples, reservoir)
    assert got == want
    bands = got[2]["latency_ms"]["commit_e2e"]
    assert bands["p50_ms"] <= bands["p90_ms"] <= bands["p99_ms"] \
        <= bands["max_ms"]
    assert bands["count"] == 2 * n_samples


# ── spans ────────────────────────────────────────────────────────────

class _Req:
    def __init__(self, ctx):
        self.span_context = ctx


def _span_script(side, rate):
    s = side.span
    with seeded(side) as clock:
        log = side.trace.TraceLog(clock=clock)
        roots = []
        for i in range(40):
            root = s.transaction_span(rate, forced=(i == 3), log=log)
            roots.append(root.sampled)
            if root:
                child = root.child("txn.commit", mutations=i)
                clock.tick(0.001)
                child.finish(status="committed")
                reqs = [_Req(None), _Req(child.context()), _Req(None)]
                bsp = s.batch_span(reqs, log=log)
                prior = s.set_current(bsp.context())
                s.emit_span("grv.grant", s.current(), version=i)
                s.set_current(prior)
                bsp.finish(version=i)
                root.finish(retries=0)
        s.promote_lite(5.0, 6.0, commit_begin=5.5, error_code=1020,
                       retries=2, log=log)
        s.slow_window_span(7.0, 7.5, txns=12, log=log)
        draws = [s.should_sample(rate) for _ in range(20)]
        assert s.from_context("x", None) is s.NULL
        return roots, draws, log.events("Span")


@pytest.mark.parametrize("rate", [0.0, 0.25, 1.0])
def test_span_sampling_and_ids_match_jax(rate):
    """Sampling draws ("span-sample"), span and trace ids ("span-id"),
    parents, links, stamps and attributes of every emitted span."""
    want = _span_script(JAX, rate)
    got = _span_script(PORT, rate)
    assert got == want
    roots, _, events = got
    assert roots[3] is True  # forced
    assert {e["span"] for e in events} >= {"transaction", "commit.window"}


def test_transaction_tracing_matches_jax():
    """A sampled transaction's spans through the whole cluster: the
    client's grv, read and commit spans, the GRV grant, the proxy's
    batch span with its links, the resolver's scan, the log push and the
    storage apply; an unsampled abort is promoted."""
    out = {}
    for side in SIDES:
        with seeded(side) as clock:
            c = side.cluster(**TEST_KNOBS, tracing_sample_rate=0.5)
            try:
                db = c.database()
                for i in range(8):
                    clock.tick(0.01)
                    db.run(lambda tr, i=i: (tr.get(b"a"),
                                            tr.get_range(b"a", b"b"),
                                            tr.set(b"k%d" % i, b"v")))
                t1 = db.create_transaction()
                t1.get(b"ctr")
                db.run(lambda tr: tr.set(b"ctr", b"x"))
                t1.set(b"ctr", b"y")
                try:
                    t1.commit()
                except side.error:
                    pass
                cfg = (c.tracing_config(), c.set_tracing(enabled=False),
                       c.set_tracing(sample_rate=0.2))
                events = [(e["span"], e["trace"], e["sid"], e["parent"],
                           e.get("links"), e["dur_ms"])
                          for e in side.trace.global_trace_log().events("Span")]
                out[side.name] = cfg, events
            finally:
                c.close()
    assert out["port"] == out["jax"]
    names = {e[0] for e in out["port"][1]}
    assert {"txn.grv", "txn.read", "txn.read_range", "txn.commit",
            "grv.grant", "proxy.batch", "resolver.scan", "tlog.push",
            "storage.apply", "transaction"} <= names


# ── heatmaps ─────────────────────────────────────────────────────────

def _heat_script(side, half_life, decode):
    h = side.heatmap
    with seeded(side) as clock:
        hms = [h.KeyRangeHeatmap(f"storage_read:{i}", max_buckets=8,
                                 half_life_s=half_life,
                                 decode=h.entry_key if decode else None)
               for i in range(3)]
        rng = random.Random(11)
        for step in range(400):
            key = b"user%04d" % min(999, int(rng.paretovariate(1.2) * 10))
            if decode:
                key = key + b"\x00" * 4 + bytes([len(key), 0, 0, 0])
            hms[step % 3].charge(key, rng.choice((1.0, 0.5, 16.0)))
            if step % 50 == 0:
                clock.tick(5.0)
        snaps = [hm.snapshot(top=4) for hm in hms]
        merged = h.merged(hms, name="read", max_buckets=8,
                          half_life_s=half_life,
                          decode=h.entry_key if decode else None)
        hms[0].absorb(hms[1])
        return (snaps, merged.snapshot(), merged.snapshot(top=2),
                round(merged.total_heat(), 6), merged.charges,
                hms[0].snapshot())


@pytest.mark.parametrize("half_life", [0.0, 30.0])
@pytest.mark.parametrize("decode", [False, True])
def test_heatmap_snapshots_match_jax(half_life, decode):
    """The same charges give the same buckets, coalescing, decay,
    merges, ``top`` cuts and absorbs."""
    want = _heat_script(JAX, half_life, decode)
    got = _heat_script(PORT, half_life, decode)
    assert got == want
    rows = got[1]
    assert rows and rows[-1]["end"] is None
    assert all(a["end"] == b["begin"] for a, b in zip(rows, rows[1:]))


def test_storage_sampling_skips_system_keys_matches_jax():
    """A cluster's read and write heat after the same traffic, with
    every access sampled; a status poll adds no heat."""
    out = {}
    for side in SIDES:
        with seeded(side):
            c = side.cluster(**TEST_KNOBS, storage_sample_every=1,
                             heatmap_half_life_s=0)
            try:
                db = c.database()
                for i in range(30):
                    db.run(lambda tr, i=i: (tr.get(b"u%d" % (i % 5)),
                                            tr.set(b"u%d" % (i % 7), b"v")))
                c.persist_shard_map()  # system keys: never charged
                first = c.hot_ranges_status()
                again = c.hot_ranges_status()
                out[side.name] = first, again
            finally:
                c.close()
    assert out["port"] == out["jax"]
    first, again = out["port"]
    assert first["totals"] == again["totals"]
    assert first["totals"]["read"]["charges"] > 0
    assert all(r["begin"] < "\xff" for dim in ("read", "write")
               for r in first["hot_ranges"][dim] if r["heat"])


# ── device profile ───────────────────────────────────────────────────

ROUTE_KNOBS = {
    # port knobs, JAX knobs, drive backlogs
    "plain": (dict(accept_kernel="off", ring_kernel="off"),
              dict(pallas_scan="off", pallas_ring="off"), True),
    "fused_accept": (dict(accept_kernel="on"), dict(pallas_scan="on"), True),
    # the reference's backlog scans strip its ring kernel, the port's
    # keep it: single batches only, where both serve the ring route
    "ring_hits": (dict(accept_kernel="off", ring_kernel="on"),
                  dict(pallas_scan="off", pallas_ring="on"), False),
}


def _profile_script(side, route):
    port_kw, jax_kw, backlogs = ROUTE_KNOBS[route]
    with seeded(side):
        c = side.cluster(**TEST_KNOBS,
                         **(jax_kw if side is JAX else port_kw))
        try:
            db = c.database()
            for i in range(6):
                db.run(lambda tr, i=i: (tr.get_range(b"a", b"c"),
                                        tr.set(b"b%d" % i, b"v"),
                                        tr.clear_range(b"x", b"y")))
            from tests.torch_sides import request
            rv = c.sequencer.committed_version
            if backlogs:
                c.commit_proxy.commit_batches([
                    [request(side, rv, sets=[(b"k%d%d" % (j, i), b"v")],
                             clears=[(b"q", b"r")]) for i in range(3)]
                    for j in range(5)])
            c.commit_proxy.commit_batch([
                request(side, rv, sets=[(b"m%d" % i, b"v")],
                        reads=[b"b1"]) for i in range(20)])
            return c.device_profile_status()
        finally:
            c.close()


@pytest.mark.parametrize("route", sorted(ROUTE_KNOBS))
def test_device_profile_matches_jax(route):
    """The device-profile document after the same cluster script, its
    route names mapped (jit→plain, pallas_scan→fused_accept,
    pallas_ring→ring_hits) and the port's single-step captures taken out
    of its compiles; the staging counts are the port's own (one staging
    set per shape against the reference's ring)."""
    want = _profile_script(JAX, route)
    got = _profile_script(PORT, route)
    for prof in want["resolvers"] + [want["aggregate"]]:
        prof["kernel_routes"] = {ROUTES[k]: v
                                 for k, v in prof["kernel_routes"].items()}
    got = single_step_compiles({"device": got})["device"]
    bad = [d for d in doc_diff(want, got) if "staging_reuse" not in d[0]]
    assert not bad, bad
    agg = got["aggregate"]
    assert agg["kernel_routes"].get(route, 0) > 0
    assert set(agg["kernel_routes"]) <= {"plain", route}
    assert agg["fallback_causes"]["pallas_to_jit"] == 0
    assert agg["dispatch_wall_ms"] == 0.0  # the clock stood still


# ── history ──────────────────────────────────────────────────────────

def _history_script(side):
    with seeded(side) as clock:
        c = side.cluster(**TEST_KNOBS, history_cadence_s=1.0,
                         history_windows=4, health_probe_interval_s=1.0)
        try:
            db = c.database()
            for i in range(12):
                clock.tick(0.5)
                db.run(lambda tr, i=i: (tr.get(b"a"),
                                        tr.set(b"k%d" % (i % 3), b"v")))
                c.prober.maybe_probe()
                c.history.maybe_collect()
            c.sequencer.kill()
            c.detect_and_recruit()
            clock.tick(1.5)
            c.history.collect_now()
            doc = c.history_status()
            flight = c.flight_status()
            # the flight artifact's trace tail holds each package's own
            # trace events: compared by type count only
            tails = [len(a["trace_tail"])
                     for a in c.history.recorder.artifacts]
            for a in c.history.recorder.artifacts:
                a.pop("trace_tail")
            return doc, flight, tails
        finally:
            c.close()


def test_history_windows_match_jax():
    """Windows cut at the same cadence (the "history-cadence" stream),
    counter rates, gauges, p99 trajectories, heat rows, the verdict
    timeline and the flight recorder's recovery dump."""
    want = _history_script(JAX)
    got = _history_script(PORT)
    assert doc_diff(want[:2], got[:2]) == []
    doc = got[0]
    assert doc["windows"] >= 4
    assert got[1]["last_triggers"] == ["recovery:sequencer_failed"]
