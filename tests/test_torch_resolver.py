"""The whole slice: the port's Resolver against the JAX package's.

Both resolvers take the same stream of ``TxnRequest`` batches, through
``resolve`` and through ``resolve_many`` backlogs of depth 2, 3, 7 and 12,
on each pair of routes (the accept kernel on both sides, the plain lanes on
both, the ring kernel on both). Statuses and the final state must be
identical (tolerance 0). The port runs with ``device="cpu"``, where every
kernel wrapper takes its plain version; the JAX package runs its Pallas
kernels in interpret mode.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from foundationdb_tpu.core.options import Knobs as JKnobs
from foundationdb_tpu.ops.conflict import ResolverParams as JParams
from foundationdb_tpu.resolver.packing import BatchPacker as JPacker
from foundationdb_tpu.resolver.resolver import Resolver as JResolver
from foundationdb_tpu.resolver.skiplist import TxnRequest as JTxn
from foundationdb_tpu_torch import workloads
from foundationdb_tpu_torch.convert import state_to_numpy
from foundationdb_tpu_torch.core.options import Knobs
from foundationdb_tpu_torch.core.status import COMMITTED, CONFLICT, TOO_OLD
from foundationdb_tpu_torch.ops.conflict import ResolverParams
from foundationdb_tpu_torch.resolver.packing import BatchPacker
from foundationdb_tpu_torch.resolver.resolver import Resolver, ResolverDown
from foundationdb_tpu_torch.resolver.skiplist import TxnRequest

# one intra-op thread per test process: the suite runs under pytest-xdist,
# where torch's default of a thread per core in every worker oversubscribes
# the CPU and slows the timed tests of the other workers
torch.set_num_threads(1)

SHAPE_KW = dict(
    batch_txn_capacity=8, point_reads_per_txn=2, point_writes_per_txn=2,
    range_reads_per_txn=1, range_writes_per_txn=1, key_limbs=2,
    hash_table_bits=12, range_ring_capacity=32, coarse_buckets_bits=6,
)

# port kernel knobs ↔ JAX Pallas knobs
ROUTES = {
    "accept_kernel": (dict(accept_kernel="on", ring_kernel="off"),
                      dict(pallas_scan="on", pallas_ring="off")),
    "plain": (dict(accept_kernel="off", ring_kernel="off"),
              dict(pallas_scan="off", pallas_ring="off")),
    "ring_kernel": (dict(accept_kernel="off", ring_kernel="on"),
                    dict(pallas_scan="off", pallas_ring="on")),
}


def _key(rng, nk=40):
    return b"k%04d" % rng.randrange(nk)


def _span(rng, nk=40):
    a, b = sorted((_key(rng, nk), _key(rng, nk)))
    return (a, b + b"\xff")


def _txn(rng, v, kind, cls):
    pt = kind in ("point", "mixed")
    rg = kind in ("range", "mixed")
    return cls(
        read_version=v - rng.randrange(0, 15),
        point_reads=[_key(rng) for _ in range(rng.randrange(3))] if pt else [],
        point_writes=[_key(rng) for _ in range(rng.randrange(3))] if pt else [],
        range_reads=[_span(rng) for _ in range(rng.randrange(2))] if rg else [],
        range_writes=[_span(rng) for _ in range(rng.randrange(2))] if rg else [],
    )


def _drive(r, seed, cls):
    """One resolver life: sequential point / range / mixed / empty and
    zero-txn batches, backlogs of depth 2, 3, 7 and 12, and one full
    batch that probes the history left behind (the stream of the JAX
    package's fused-kernel tests)."""
    rng = random.Random(seed)
    T = SHAPE_KW["batch_txn_capacity"]
    out = []
    v = 100

    def batch(kind, n):
        nonlocal v
        txns = [_txn(rng, v, kind, cls) for _ in range(n)]
        v += rng.randrange(1, 5)
        return (txns, v, max(0, v - 60))

    for kind in ("point", "range", "mixed", "empty"):
        for _ in range(3):
            out.append(r.resolve(*batch(kind, rng.randrange(1, T + 1))))
    out.append(r.resolve(*batch("mixed", 0)))
    for depth in (2, 3, 7, 12):
        bs = [batch("mixed", rng.randrange(1, T + 1)) for _ in range(depth)]
        out.extend(r.resolve_many(bs))
    out.append(r.resolve(*batch("mixed", T)))
    return out


def _assert_same_final_state(jr, tr):
    assert jr.base_version == tr.base_version
    for name, j, t in zip(tr.state._fields, jr.state, state_to_numpy(tr.state)):
        j = np.asarray(j)
        assert j.dtype == t.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("seed", [3, 11])
def test_resolver_matches_jax_on_every_route(route, seed):
    tk, jk = ROUTES[route]
    jr = JResolver(JKnobs(resolver_backend="tpu", **SHAPE_KW, **jk))
    tr = Resolver(Knobs(**SHAPE_KW, **tk), device="cpu")
    assert tr.params.use_accept_kernel == jr.params.use_pallas_scan
    assert tr.params.use_ring_kernel == jr.params.use_pallas
    got = _drive(tr, seed, TxnRequest)
    want = _drive(jr, seed, JTxn)
    assert got == want
    flat = [s for b in got for s in b]
    assert COMMITTED in flat and CONFLICT in flat
    _assert_same_final_state(jr, tr)


def test_auto_knobs_are_off_on_the_cpu_and_on_for_cuda():
    r = Resolver(Knobs(**SHAPE_KW), device="cpu")
    assert not r.params.use_accept_kernel and not r.params.use_ring_kernel
    r = Resolver(Knobs(**SHAPE_KW, accept_kernel="on", ring_kernel="on"),
                 device="cpu")
    assert r.params.use_accept_kernel and not r.params.use_ring_kernel
    with pytest.raises(ValueError):
        Resolver(Knobs(**SHAPE_KW, accept_kernel="maybe"), device="cpu")


def test_resolver_without_device_raises_when_there_is_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Resolver(Knobs(**SHAPE_KW))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Resolver(Knobs(**SHAPE_KW), device="cuda:0")


def test_cpu_backend_matches_jax_cpu_backend():
    jr = JResolver(JKnobs(**dict(SHAPE_KW, resolver_backend="cpu")))
    tr = Resolver(Knobs(**dict(SHAPE_KW, resolver_backend="cpu")))
    assert _drive(tr, 5, TxnRequest) == _drive(jr, 5, JTxn)
    assert tr.window_start() == jr.window_start()


def test_rebase_across_the_threshold_matches_jax():
    """Commit versions run past 2^30 versions above the base: both
    resolvers rebase by the window start and keep agreeing."""
    def run(r, cls):
        out = []
        v = 100
        rng = random.Random(4)
        for step in range(8):
            if step == 4:
                v += 1 << 30  # the next batch crosses REBASE_THRESHOLD
            txns = [_txn(rng, v, "mixed", cls) for _ in range(6)]
            if step > 4:  # a read from before the jump: below the base
                txns.append(cls(read_version=100, point_reads=[b"k0001"]))
            v += 3
            out.append(r.resolve(txns, v, max(0, v - 20)))
        return out, r.base_version, r.window_start()

    jr = JResolver(JKnobs(resolver_backend="tpu", **SHAPE_KW,
                          pallas_scan="off"))
    tr = Resolver(Knobs(**SHAPE_KW), device="cpu")
    got, want = run(tr, TxnRequest), run(jr, JTxn)
    assert got == want
    assert got[1] > 0  # it did rebase
    assert TOO_OLD in [s for b in got[0] for s in b]
    _assert_same_final_state(jr, tr)


def test_kill_respawn_and_status():
    r = Resolver(Knobs(**SHAPE_KW), device="cpu")
    r.resolve([TxnRequest(read_version=0, point_writes=[b"a"])], 5, 0)
    r.resolve_many([([TxnRequest(read_version=5)], 6, 0),
                    ([TxnRequest(read_version=5)], 7, 0)])
    st = r.status()
    assert st["alive"] and st["backend"] == "cuda" and st["device"] == "cpu"
    assert st["metrics"]["counters"]["resolve_batches"] == 3
    assert st["metrics"]["counters"]["backlog_dispatches"] == 1
    r.kill()
    with pytest.raises(ResolverDown):
        r.resolve([], 8, 0)
    new = r.respawn(base_version=8)
    assert new.status()["metrics"]["counters"]["respawns"] == 1
    # the replacement fences read versions from before its start
    assert new.resolve([TxnRequest(read_version=7, point_reads=[b"a"]),
                        TxnRequest(read_version=8, point_reads=[b"a"])],
                       9, 8) == [TOO_OLD, COMMITTED]


def test_lazy_resolve_many_handle():
    r = Resolver(Knobs(**SHAPE_KW), device="cpu")
    bs = [([TxnRequest(read_version=0, range_writes=[(b"a", b"c")])], 1, 0),
          ([TxnRequest(read_version=0, range_reads=[(b"b", b"d")])], 2, 0)]
    h = r.resolve_many(bs, lazy=True)
    assert h.wait() == [[COMMITTED], [CONFLICT]]
    assert h.wait() == [[COMMITTED], [CONFLICT]]


PACK_TXNS = [
    TxnRequest(read_version=50, point_reads=[b"a", b"b", b"c"],
               point_writes=[b"x" * 12, b"y", b"z", b"w"],
               range_reads=[(b"a", b"b"), (b"c", b"d")],
               range_writes=[(b"q", b"r")]),
    TxnRequest(read_version=7, point_reads=[b"long-key-" * 5],
               range_reads=[(b"k" * 40, b"k" * 41)],
               range_writes=[(b"\xff" * 9, b"\xff" * 12)]),
    TxnRequest(read_version=60),
    TxnRequest(read_version=61, point_writes=[b"only"]),
]


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("key_limbs", [2, 8])
def test_packer_matches_jax_packer(use_native, key_limbs):
    """Lane spill (more points than lanes), range coalescing and keys
    longer than 4 * key_limbs bytes pack to the same arrays."""
    kw = dict(txns=6, point_reads=2, point_writes=2, range_reads=2,
              range_writes=2, key_width=key_limbs + 1, bucket_bits=6)
    got = BatchPacker(ResolverParams(**kw)).pack(PACK_TXNS, 5, 70, 20)
    jtxns = [JTxn(**vars(t)) for t in PACK_TXNS]
    want = JPacker(JParams(**kw), use_native=use_native).pack(jtxns, 5, 70, 20)
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    empty = BatchPacker(ResolverParams(**kw)).pack_empty(5, 70, 20)
    jempty = JPacker(JParams(**kw), use_native=False).pack_empty(5, 70, 20)
    for name, g, w in zip(empty._fields, empty, jempty):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def test_port_imports_without_jax_or_the_jax_package():
    """The port and every one of its modules import with ``jax`` and
    ``foundationdb_tpu`` blocked: the cluster, the commit pipeline
    (batcher, fleet, GRV batching, stage timers), data distribution, the
    storage router, the ratekeeper, the system keys, the client
    transaction, the observability modules (lock witness, metrics,
    spans, heatmaps, device profile, history, the doctor, the consistency
    scan and check), the simulator, the special keys, the metacluster
    and the fault-coverage witness, and the package's ``open`` by name,
    then every module of the package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['foundationdb_tpu'] = None\n"
        "import foundationdb_tpu_torch as p\n"
        "from foundationdb_tpu_torch import open, transactional\n"
        "import foundationdb_tpu_torch.server.cluster\n"
        "import foundationdb_tpu_torch.server.batcher\n"
        "import foundationdb_tpu_torch.server.fleet\n"
        "import foundationdb_tpu_torch.server.grv\n"
        "import foundationdb_tpu_torch.utils.trace\n"
        "import foundationdb_tpu_torch.server.datadistribution\n"
        "import foundationdb_tpu_torch.server.router\n"
        "import foundationdb_tpu_torch.server.ratekeeper\n"
        "import foundationdb_tpu_torch.core.systemdata\n"
        "import foundationdb_tpu_torch.core.deterministic\n"
        "import foundationdb_tpu_torch.txn.transaction\n"
        "import foundationdb_tpu_torch.utils.lockdep\n"
        "import foundationdb_tpu_torch.utils.metrics\n"
        "import foundationdb_tpu_torch.utils.span\n"
        "import foundationdb_tpu_torch.utils.heatmap\n"
        "import foundationdb_tpu_torch.utils.deviceprofile\n"
        "import foundationdb_tpu_torch.utils.timeseries\n"
        "import foundationdb_tpu_torch.server.health\n"
        "import foundationdb_tpu_torch.server.consistencyscan\n"
        "import foundationdb_tpu_torch.server.consistency\n"
        "import foundationdb_tpu_torch.sim\n"
        "import foundationdb_tpu_torch.sim.buggify\n"
        "import foundationdb_tpu_torch.sim.network\n"
        "import foundationdb_tpu_torch.sim.simulation\n"
        "import foundationdb_tpu_torch.sim.workloads\n"
        "import foundationdb_tpu_torch.txn.specialkeys\n"
        "import foundationdb_tpu_torch.layers.metacluster\n"
        "import foundationdb_tpu_torch.utils.faultcov\n"
        "assert callable(open) and callable(transactional)\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'foundationdb_tpu.'))"
        " for k in sys.modules if sys.modules[k] is not None)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 76


@pytest.mark.parametrize("name", sorted(workloads.STREAMS))
def test_workload_streams_match_jax_resolver(name):
    """Each seeded workload stream, at a narrow width, gets the same
    verdicts from the port and the JAX package; the same seed gives the
    same stream."""
    make = workloads.STREAMS[name]
    stream = make(4, txns=16, seed=9, nkeys=2000)
    again = make(4, txns=16, seed=9, nkeys=2000)
    assert [[vars(t) for t in b] for b, _, _ in stream] == \
        [[vars(t) for t in b] for b, _, _ in again]
    kw = dict(SHAPE_KW, batch_txn_capacity=16, key_limbs=3)
    tr = Resolver(Knobs(**kw, accept_kernel="on"), device="cpu")
    jr = JResolver(JKnobs(resolver_backend="tpu", **kw, pallas_scan="on"))
    got = [tr.resolve(b, cv, ws) for b, cv, ws in stream]
    jstream = [([JTxn(**vars(t)) for t in b], cv, ws) for b, cv, ws in stream]
    assert got == [jr.resolve(b, cv, ws) for b, cv, ws in jstream]
    _assert_same_final_state(jr, tr)
