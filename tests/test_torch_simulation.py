"""The port's simulator against the JAX package's, at tolerance 0.

Each case of the reference's ``tests/test_simulation.py``,
``test_machine_sim.py`` and ``test_network_sim.py`` runs one script on
both packages under one seed (tests/torch_sides.py). Both sides resolve
on the host oracle (``resolver_backend="cpu"``), except the device-step
case, where the port's cluster runs the plain version of the accept
kernel on ``device="cpu"`` and the reference its Pallas kernel in
interpret mode. A run's summary must be equal: the scheduling steps and
``schedule_hash``, the recoveries, the activated BUGGIFY sites, every
trace event the run logged (``SimBuggifySites`` among them), the
workload's own statistics and every row of the final database.

The machine-reboot headline of the reference also ticks a continuous
backup agent; ``tools/backup.py`` is not ported, so its case here runs
the same reboots without the agent.
"""

import json
import random
import time

import pytest

from tests.conftest import TEST_KNOBS
from tests.torch_sides import JAX, PORT, SIDES


@pytest.fixture(autouse=True)
def _restore_process_state():
    """A simulation seeds the process's streams and points the trace
    clock at its steps; put both back after each case, on both sides."""
    clocks = [side.trace.global_trace_log().clock for side in SIDES]
    yield
    for side, clock in zip(SIDES, clocks):
        side.deterministic.unseed()
        side.deterministic.registry().reset_clock()
        side.trace.global_trace_log().clock = clock
        side.faultcov.disable()
        side.faultcov.reset()


def _sim(side, seed, path, **kw):
    kw.setdefault("resolver_backend", "cpu")
    side.trace.global_trace_log().clear()
    return side.simulation.Simulation(seed=seed, datadir=str(path), **kw)


def _summary(side, sim, **extra):
    """What a run must reproduce on the other package."""
    return dict(
        steps=sim.steps,
        schedule_hash=sim.schedule_hash,
        recoveries=sim.recoveries,
        generation=sim.cluster.generation,
        sites=sim.buggify.activated_sites(),
        role_kills=getattr(sim, "role_kills", 0),
        tlog_kills=getattr(sim, "tlog_kills", 0),
        machine_reboots=sim.machine_reboots,
        net=(sim.net.delivered, sim.net.reordered, sim.net.dropped,
             sim.net.partitions),
        events=side.trace.global_trace_log().events(),
        rows=sim.db.get_range(b"", b"\xff"),
        **extra,
    )


def _both(script, *args, **kw):
    """``script(side, *args)`` on the reference and on the port."""
    want = script(JAX, *args, **kw)
    got = script(PORT, *args, **kw)
    return want, got


def _assert_equal(want, got):
    for field in want:
        assert got[field] == want[field], field


# ───────────────────────────── cycle ────────────────────────────────────
def _cycle(side, seed, path, crash_p=0.004, **kw):
    sim = _sim(side, seed, path / side.name, crash_p=crash_p, **kw)
    W = side.workloads
    n_nodes = 20
    W.cycle_setup(sim.db, n_nodes)
    for a in range(4):
        rng = random.Random(seed * 1000 + a)
        sim.add_workload(f"cycle{a}", W.cycle_workload(sim.db, n_nodes, 30,
                                                       rng))
        sim.add_workload(f"slow{a}", W.slow_cycle_workload(sim.db, n_nodes,
                                                           15, rng))
    sim.run()
    sim.quiesce()
    W.cycle_check(sim.db, n_nodes)
    out = _summary(side, sim,
                   versioned=sim.cluster.storages[0].versioned_engine)
    sim.close()
    return out


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_cycle_sims_match_jax(seed, tmp_path):
    want, got = _both(_cycle, seed, tmp_path)
    _assert_equal(want, got)


def test_cycle_sims_inject_faults(tmp_path):
    """Across the reference test's seeds the port's sites fire and its
    cluster crashes and recovers, as the reference's do."""
    sites, recoveries = set(), 0
    for seed in (1, 2, 3, 4, 5):
        out = _cycle(PORT, seed, tmp_path / str(seed))
        sites.update(out["sites"])
        recoveries += out["recoveries"]
    assert sites and recoveries > 0


@pytest.mark.parametrize("engine,seed", [("versioned", 3), ("versioned", 4),
                                         ("redwood", 5), ("redwood", 6)])
def test_cycle_on_versioned_engines_match_jax(engine, seed, tmp_path):
    want, got = _both(_cycle, seed, tmp_path, crash_p=0.01, engine=engine)
    _assert_equal(want, got)
    assert got["versioned"]


# ─────────────────────── the other workloads ───────────────────────────
def _serializability(side, seed, path):
    sim = _sim(side, seed, path / side.name)
    W = side.workloads
    log = W.SerializabilityLog()
    n_keys = 8
    for a in range(4):
        rng = random.Random(seed * 77 + a)
        sim.add_workload(f"ser{a}", W.serializability_workload(
            sim.db, log, a, 25, n_keys, rng))
    sim.run()
    W.serializability_check(sim.db, log, n_keys)
    out = _summary(side, sim, log=sorted(log.entries, key=repr))
    sim.close()
    return out


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_strict_serializability_matches_jax(seed, tmp_path):
    want, got = _both(_serializability, seed, tmp_path)
    _assert_equal(want, got)
    assert len(got["log"]) >= 40


def _atomic_counters(side, path):
    sim = _sim(side, 42, path / side.name)
    W = side.workloads
    totals = {}
    for a in range(3):
        sim.add_workload(f"ctr{a}", W.atomic_counter_workload(
            sim.db, a, 40, random.Random(a), totals))
    sim.run()
    W.atomic_counter_check(sim.db, totals)
    out = _summary(side, sim, totals=totals)
    sim.close()
    return out


def test_atomic_counters_match_jax(tmp_path):
    want, got = _both(_atomic_counters, tmp_path)
    _assert_equal(want, got)


def _api_correctness(side, seed, path):
    sim = _sim(side, seed, path / side.name, crash_p=0.003)
    W = side.workloads
    models = []
    for a in range(3):
        model = W.ApiModel()
        models.append(model)
        sim.add_workload(f"api{a}", W.api_correctness_workload(
            sim.db, model, n_txns=25, n_keys=24,
            rng=random.Random(seed * 77 + a), prefix=b"api/%d/" % a))
    sim.run()
    sim.quiesce()
    for a, model in enumerate(models):
        W.api_correctness_check(sim.db, model, prefix=b"api/%d/" % a)
    out = _summary(side, sim, models=[m.data for m in models])
    sim.close()
    return out


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_api_correctness_matches_jax(seed, tmp_path):
    want, got = _both(_api_correctness, seed, tmp_path)
    _assert_equal(want, got)


def _mako(side, path):
    sim = _sim(side, 31, path / side.name, crash_p=0.002)
    W = side.workloads
    n_rows = 40
    sim.db.run(lambda tr: [tr.set(b"mako/r%06d" % i, b"seed")
                           for i in range(n_rows)])
    stats = {}
    for a in range(3):
        sim.add_workload(f"mako{a}", W.mako_workload(
            sim.db, 25, n_rows, random.Random(31 * 13 + a), stats))
    sim.run()
    sim.quiesce()
    W.mako_check(sim.db, n_rows)
    out = _summary(side, sim, stats=stats)
    sim.close()
    return out


def test_mako_load_mix_matches_jax(tmp_path):
    want, got = _both(_mako, tmp_path)
    _assert_equal(want, got)
    assert got["stats"]["txns"] == 75
    assert {"get", "set", "getrange", "update", "clearrange"} \
        <= set(got["stats"])


def _ratekeeper(side, path):
    sim = _sim(side, 77, path / side.name, buggify=False, crash_p=0.0,
               target_tps=25)
    W = side.workloads
    n_nodes = 10
    W.cycle_setup(sim.db, n_nodes)
    for a in range(3):
        sim.add_workload(f"c{a}", W.cycle_workload(sim.db, n_nodes, 15,
                                                   random.Random(a)))
    sim.run()
    rk = sim.cluster.ratekeeper
    throttled = rk.throttled_count
    # the sim clock stops with the scheduler: open the gate so the final
    # reads cannot starve on a frozen bucket
    rk.set_target_tps(1e9)
    rk._tokens = 1e9
    sim.quiesce()
    W.cycle_check(sim.db, n_nodes)
    out = _summary(side, sim, throttled=throttled)
    sim.close()
    return out


def test_ratekeeper_throttles_like_jax(tmp_path):
    want, got = _both(_ratekeeper, tmp_path)
    _assert_equal(want, got)
    assert got["throttled"] > 0


def _short_cycle(side, seed, path, actors=3, n_nodes=12, ops=20):
    sim = _sim(side, seed, path)
    W = side.workloads
    W.cycle_setup(sim.db, n_nodes)
    for a in range(actors):
        sim.add_workload(f"c{a}", W.cycle_workload(sim.db, n_nodes, ops,
                                                   random.Random(a)))
    sim.run()
    out = _summary(side, sim, seeded=side.deterministic.registry().seeded)
    sim.close()
    # close puts the wall clock back (the step clock would freeze every
    # later cluster's spans)
    out["wall_clock"] = abs(side.deterministic.now() - time.time()) < 60
    return out


def test_short_cycle_and_registry_match_jax(tmp_path):
    want, got = _both(lambda side: _short_cycle(side, 99,
                                                tmp_path / side.name))
    _assert_equal(want, got)
    assert got["seeded"] and got["wall_clock"]


def test_port_simulation_is_deterministic(tmp_path):
    """Same seed, same schedule, faults and state, within the port."""
    runs = [_short_cycle(PORT, 99, tmp_path / f"d{i}") for i in (0, 1)]
    _assert_equal(*runs)


def test_port_seeds_steer_the_schedule(tmp_path):
    hashes = {_short_cycle(PORT, seed, tmp_path / str(seed), actors=2,
                           n_nodes=10, ops=10)["schedule_hash"]
              for seed in (1, 2, 3, 4, 5, 6)}
    assert len(hashes) > 1


# ─────────────────────────── buggify ───────────────────────────────────
def _gating(side):
    B = side.buggify.Buggify
    bg = B(seed=7, enabled=True, site_activated_p=1.0, fire_p=1.0)
    off = B(seed=7, enabled=False)
    b1, b2 = B(seed=3, site_activated_p=0.5), B(seed=3, site_activated_p=0.5)
    sites = [f"site{i}" for i in range(20)]
    fires = [b1(s) for s in sites] + [b2(s) for s in reversed(sites)]
    return [bg("always-on"), off("anything"), fires, dict(b1._sites),
            dict(b2._sites), side.buggify.BUGGIFY.enabled,
            side.buggify.BUGGIFY.fire_p]


def test_buggify_gating_matches_jax():
    want, got = _both(_gating)
    assert got == want
    assert got[0] and not got[1] and got[3] == got[4]


def _activated(side, seed):
    bg = side.buggify.Buggify(seed=seed, site_activated_p=0.5, fire_p=0.0)
    for i in range(40):
        bg(f"chaos.site{i}")
    return bg.activated_sites()


def test_buggify_activation_list_matches_jax():
    for seed in (11, 12):
        want, got = _both(_activated, seed)
        assert got == want
    assert _activated(PORT, 11) != _activated(PORT, 12)


# ───────────────────────── fault coverage ──────────────────────────────
# port function -> its reference counterpart, where the qualnames differ
# (none differ on the sim's paths today)
QUALNAMES = {}


def _witness(side, seed, path):
    side.faultcov.reset()
    side.faultcov.enable()
    try:
        _cycle(side, seed, path, crash_p=0.01, engine="versioned")
    finally:
        side.faultcov.disable()
    return json.loads(side.faultcov.witness_doc())["fired"]


def _mapped(fired):
    """The reference's site ids under the port's package path."""
    out = {}
    for site, count in fired.items():
        site = f"{PORT.faultcov.PACKAGE}.{site}"
        module, qualname, code = site.split(":")
        out[":".join((module, QUALNAMES.get(qualname, qualname), code))] = \
            count
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_faultcov_witness_matches_jax(seed, tmp_path):
    want, got = _both(_witness, seed, tmp_path)
    assert got == _mapped(want)
    assert got, "the sim fired no error site"
    assert all(s.startswith("foundationdb_tpu_torch.") for s in got)
    # a fabrication site under core/errors.py is plumbing, never counted
    assert not any(s.startswith("foundationdb_tpu_torch.core.errors:")
                   for s in got)


def test_faultcov_off_records_nothing(tmp_path):
    PORT.faultcov.reset()
    _cycle(PORT, 3, tmp_path, crash_p=0.01)
    assert PORT.faultcov.fired() == frozenset()


# ─────────────────────── the device step ───────────────────────────────
DEVICE_KNOBS = dict(
    batch_txn_capacity=8, point_reads_per_txn=2, point_writes_per_txn=2,
    range_reads_per_txn=1, range_writes_per_txn=1, key_limbs=2,
    hash_table_bits=12, range_ring_capacity=32, coarse_buckets_bits=6)
ROUTES = {"jit": "plain", "pallas_scan": "fused_accept",
          "pallas_ring": "ring_hits"}


def _device_sim(side, seed, path):
    if side is PORT:
        kw = dict(resolver_backend="cuda", device="cpu", accept_kernel="on")
    else:
        kw = dict(resolver_backend="tpu", pallas_scan="on")
    sim = _sim(side, seed, path / side.name, buggify=True, crash_p=0.0,
               **DEVICE_KNOBS, **kw)

    def workload(db, n_ops, rng):
        # point RMW + a range read + an occasional clear_range: every
        # conflict lane of the accept step sees sim traffic
        key = lambda i: b"ps/k%02d" % i  # noqa: E731
        for _ in range(n_ops):
            i = rng.randrange(6)

            def fn(tr, i=i):
                cur = tr.get(key(i)) or b"0"
                tr.get_range(key(0), key(3))
                tr.set(key(i), cur + b"x")
                if i == 0:
                    tr.clear_range(key(6), key(8))

            yield from side.workloads.run_txn(db, fn)

    for a in range(2):
        sim.add_workload(f"w{a}", workload(sim.db, 6,
                                           random.Random(seed * 13 + a)))
    sim.run()
    agg = sim.cluster.status()["cluster"]["device"]["aggregate"]
    out = _summary(side, sim, dispatches=agg["dispatches"],
                   routes={ROUTES.get(k, k): v
                           for k, v in agg["kernel_routes"].items()},
                   state=side.state(sim.cluster))
    sim.close()
    return out


def test_device_step_under_faults_matches_jax(tmp_path):
    """The reference's same-seed sim with its fused kernel forced on
    (tests/test_pallas_scan.py), with the port's accept kernel in its
    plain version: the same schedule, statuses (through the outcome of
    every transaction, hence the rows) and resolver state."""
    want, got = _both(_device_sim, 5150, tmp_path)
    wstate, gstate = want.pop("state"), got.pop("state")
    _assert_equal(want, got)
    for w, g in zip(wstate, gstate):
        assert (w == g).all()
    assert got["dispatches"] > 0 and got["routes"]["fused_accept"] > 0


# ─────────────────────────── machines ──────────────────────────────────
def _machine_sim(side, seed, path, **kw):
    kw.setdefault("machines", 3)
    kw.setdefault("n_storage", 3)
    kw.setdefault("replication", 2)
    kw.setdefault("n_tlogs", 3)
    kw.setdefault("crash_p", 0.0)
    return _sim(side, seed, path / side.name, **{**TEST_KNOBS, **kw})


def _placement(side, path):
    sim = _machine_sim(side, 1, path)
    try:
        return [sim.machine_roles(m) for m in range(3)]
    finally:
        sim.close()


def test_machine_placement_matches_jax(tmp_path):
    want, got = _both(_placement, tmp_path)
    assert got == want
    assert sorted(s for st, _, _, _ in got for s in st) == [0, 1, 2]
    assert [m for m, (_, _, _, txn) in enumerate(got) if txn] == [0]


def _reboot(side, path):
    sim = _machine_sim(side, 2, path)
    c, db = sim.cluster, sim.db
    try:
        for i in range(10):
            db[b"k%d" % i] = b"v%d" % i
        killable = sim._machine_killable(1)
        sim.reboot_machine(1)
        storages, tlogs, _, _ = sim.machine_roles(1)
        down = ([c.storages[s].alive for s in storages],
                [c.tlog.logs[t].alive for t in tlogs])
        db[b"during"] = b"x"
        events = c.detect_and_recruit()
        return dict(killable=killable, down=down, events=events,
                    rows=db.get_range(b"", b"\xff"),
                    consistent=c.consistency_check())
    finally:
        sim.close()


def test_machine_reboot_matches_jax(tmp_path):
    want, got = _both(_reboot, tmp_path)
    assert got == want
    assert got["killable"] and got["consistent"] == []
    assert not any(got["down"][0] + got["down"][1])


def _reboot_txn_machine(side, path):
    sim = _machine_sim(side, 3, path)
    c, db = sim.cluster, sim.db
    try:
        db[b"pre"] = b"1"
        gen0 = c.generation
        sim.reboot_machine(0)
        tr = db.create_transaction()
        tr[b"during"] = b"x"
        try:
            tr.commit()
            code = None
        except side.error as e:
            code = e.code
        events = c.detect_and_recruit()
        db[b"post"] = b"2"
        return dict(code=code, events=events, gens=(gen0, c.generation),
                    rows=db.get_range(b"", b"\xff"))
    finally:
        sim.close()


def test_machine0_reboot_recovers_like_jax(tmp_path):
    want, got = _both(_reboot_txn_machine, tmp_path)
    assert got == want
    assert got["code"] in (1021, 1037)
    assert ("txn-system", 0) in got["events"]


def _protected(side, path):
    sim = _machine_sim(side, 4, path)
    c = sim.cluster
    try:
        for t in sim.machine_roles(1)[1]:
            c.tlog.kill(t)
        killable = [sim._machine_killable(m) for m in range(3)]
        sim.buggify._sites["machine_reboot"] = True
        orig = sim.buggify
        sim.buggify = lambda name, fire_p=None: orig(
            name, fire_p=1.0 if name == "machine_reboot" else fire_p)
        live = []
        for _ in range(50):
            sim._maybe_reboot_machine()
            live.append(sum(1 for log in c.tlog.logs if log.alive))
        return dict(killable=killable, live=live, quorum=c.tlog.quorum,
                    reboots=sim.machine_reboots)
    finally:
        sim.close()


def test_unkillable_machine_protected_like_jax(tmp_path):
    want, got = _both(_protected, tmp_path)
    assert got == want
    assert min(got["live"]) >= got["quorum"]


def _reboots_mid_workload(side, path, engine):
    sim = _machine_sim(side, 7, path, engine=engine)
    W = side.workloads
    n_nodes = 12
    gen0 = sim.cluster.generation
    W.cycle_setup(sim.db, n_nodes)
    sim.buggify._sites["machine_reboot"] = True
    orig = sim.buggify
    sim.buggify = lambda name, fire_p=None: orig(
        name, fire_p=0.02 if name == "machine_reboot" else fire_p)

    def chaos_actor():
        for _ in range(40):
            yield
        sim.reboot_machine(0)
        yield

    for a in range(3):
        sim.add_workload(f"cycle{a}", W.cycle_workload(
            sim.db, n_nodes, 25, random.Random(700 + a)))
    sim.add_workload("chaos", chaos_actor())
    sim.run()
    sim.quiesce()
    W.cycle_check(sim.db, n_nodes)
    out = dict(steps=sim.steps, schedule_hash=sim.schedule_hash,
               reboots=sim.machine_reboots,
               gens=(gen0, sim.cluster.generation),
               events=side.trace.global_trace_log().events(),
               rows=sim.db.get_range(b"", b"\xff"))
    sim.close()
    return out


@pytest.mark.parametrize("engine", ["memory", "redwood"])
def test_machine_reboots_mid_workload_match_jax(engine, tmp_path):
    want, got = _both(_reboots_mid_workload, tmp_path, engine)
    _assert_equal(want, got)
    assert got["reboots"] > 0 and got["gens"][1] > got["gens"][0]


# ─────────────────────────── network ───────────────────────────────────
def _net(side, drop_p=0.0, **kw):
    clock = {"t": 0}
    net = side.network.SimNetwork(
        random.Random(7), side.buggify.Buggify(seed=7, enabled=drop_p > 0),
        clock=lambda: clock["t"], drop_p=drop_p, **kw)
    return net, clock


def _net_stats(net):
    return (net.delivered, net.reordered, net.dropped, net.partitions,
            net.pending)


def _delivery_order(side):
    net, clock = _net(side, min_latency=1, max_latency=10)
    order = []
    for i in range(30):
        net.call(lambda i=i: order.append(i))
    for t in range(1, 12):
        clock["t"] = t
        net.deliver_due(t)
    return order, _net_stats(net)


def _partition_burst(side):
    net, clock = _net(side, min_latency=1, max_latency=2)
    got = []
    net.call(lambda: got.append("a"))
    net.partition(10)
    net.call(lambda: got.append("b"))
    clock["t"] = 5
    net.deliver_due(5)
    stalled = list(got)
    clock["t"] = 10 + net.max_latency
    net.deliver_due(clock["t"])
    return stalled, got, _net_stats(net)


def _heal_reorders(side):
    net, clock = _net(side, min_latency=1, max_latency=10)
    order = []
    for i in range(20):
        net.call(lambda i=i: order.append(i))
    net.partition(15)
    clock["t"] = 15 + net.max_latency
    net.deliver_due(clock["t"])
    return order, _net_stats(net)


def _thunk_error(side):
    net, clock = _net(side)

    def boom():
        raise ValueError("x")

    fut = net.call(boom)
    clock["t"] = 20
    net.deliver_due(20)
    try:
        fut.result()
    except ValueError as e:
        return fut.done, str(e)
    return fut.done, None


def _drops(side):
    net, clock = _net(side, drop_p=1.0)
    net.buggify._sites["net_drop"] = True
    futs = [net.call(lambda: 1, kind=k) for k in ("commit", "call")]
    clock["t"] = 100
    net.deliver_due(100)
    codes = []
    for f in futs:
        try:
            f.result()
        except side.error as e:
            codes.append(e.code)
    return codes, _net_stats(net)


@pytest.mark.parametrize("script", [_delivery_order, _partition_burst,
                                    _heal_reorders, _thunk_error, _drops])
def test_sim_network_matches_jax(script):
    want, got = _both(script)
    assert got == want


def test_sim_network_reorders_and_stalls():
    order, stats = _delivery_order(PORT)
    assert sorted(order) == list(range(30)) and order != list(range(30))
    assert stats[1] > 0
    stalled, got, _ = _partition_burst(PORT)
    assert stalled == [] and sorted(got) == ["a", "b"]
    order, _ = _heal_reorders(PORT)
    assert order != list(range(20))
    assert _drops(PORT)[0] == [1021, 1037]


def _net_sim(side, seed, path, n_nodes=12):
    sim = _sim(side, seed, path / side.name, crash_p=0.002)
    W = side.workloads
    W.cycle_setup(sim.db, n_nodes)
    log = W.SerializabilityLog()
    for a in range(3):
        rng = random.Random(seed * 57 + a)
        sim.add_workload(f"nc{a}", W.net_cycle_workload(
            sim.db, sim.net, n_nodes, 15, rng))
        sim.add_workload(f"ns{a}", W.net_serializability_workload(
            sim.db, sim.net, log, a, 10, 6, rng))
    sim.run()
    sim.quiesce()
    W.cycle_check(sim.db, n_nodes)
    W.serializability_check(sim.db, log, 6)
    out = _summary(side, sim, log=sorted(log.entries, key=repr))
    sim.close()
    return out


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 31])
def test_network_sims_match_jax(seed, tmp_path):
    want, got = _both(_net_sim, seed, tmp_path)
    _assert_equal(want, got)


def test_network_sims_reorder_drop_and_partition(tmp_path):
    totals = [0, 0, 0]
    for seed in (1, 2, 3, 4):
        _, reordered, dropped, partitions = _net_sim(
            PORT, seed, tmp_path / str(seed))["net"]
        totals = [totals[0] + reordered, totals[1] + dropped,
                  totals[2] + partitions]
    assert totals[0] > 0 and totals[1] + totals[2] > 0
