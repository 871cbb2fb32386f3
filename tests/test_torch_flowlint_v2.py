"""flowlint's whole-program rules on the port (FL006 lock order, FL007
thread escape, FL008 protocol and knob drift, stale suppressions):
every synthetic-source case of the JAX package's
tests/test_flowlint_v2.py through both packages' rules, plus the port's
own tree contracts — its lockorder.txt, its thread sites, and the
runtime lock witness held to its static graph."""

import ast
import json
import os
import random
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

from foundationdb_tpu.analysis import flowlint as jflowlint  # noqa: E402
from foundationdb_tpu.analysis.rules import fl006_lockorder as jfl006  # noqa: E402
from foundationdb_tpu_torch.analysis import flowlint  # noqa: E402
from foundationdb_tpu_torch.analysis.rules import fl006_lockorder  # noqa: E402
from foundationdb_tpu_torch.utils import lockdep  # noqa: E402
from tests import test_flowlint_v2 as ref  # noqa: E402
from tests.torch_flowlint_twin import (  # noqa: E402
    assert_twin, port_tree_model, run_twin, twin_cases)

# the port's own lock: the resolver serializes its history under
# Resolver._mu, which the reference's device resolver does not hold
# (its JAX dispatch is lock-free); the reviewed edges into and out of it
PORT_ONLY_EDGES = {
    ("Cluster._recovery_mu", "Resolver._mu"),
    ("CommitProxy._commit_mu", "Resolver._mu"),
    ("Resolver._mu", "LatencySample._lock"),
}


@pytest.mark.parametrize("case", twin_cases(ref))
def test_rule_case_matches_jax(case, request):
    assert_twin(run_twin(ref, case, request))


@pytest.fixture(scope="module")
def model():
    return port_tree_model()


def _declared(path):
    with open(path, encoding="utf-8") as f:
        return fl006_lockorder.load_lockorder(f.read())[0]


def test_fl006_tree_lockorder_is_declared_and_live(model):
    """The port's lockorder.txt is the graph of the port's tree: every
    computed edge declared, nothing stale, every id Owner._attr."""
    declared = _declared(flowlint.default_lockorder_path())
    assert declared, "lockorder.txt declares no edges"
    for (a, b) in declared:
        assert "." in a and "." in b, f"malformed lock id in {a} -> {b}"
    edges, _ = fl006_lockorder.compute_graph(model)
    assert set(edges) == set(declared)


def test_fl006_lockorder_differs_from_the_reference_by_resolver_mu():
    """Edge for edge the reference's order, plus the three reviewed
    edges through the port's own Resolver._mu: no edge of the reference
    is missing, and no other edge is new."""
    with open(jflowlint.default_lockorder_path(), encoding="utf-8") as f:
        want = set(jfl006.load_lockorder(f.read())[0])
    got = set(_declared(flowlint.default_lockorder_path()))
    assert want - got == set()
    assert got - want == PORT_ONLY_EDGES


def test_fl006_region_replication_edges_declared():
    """The sync commit path's push to the satellite under
    CommitProxy._commit_mu and the streamer's drain of TLog state under
    RegionReplicator._mu are declared, and no reverse of them is."""
    declared = _declared(flowlint.default_lockorder_path())
    for edge in [
        ("CommitProxy._commit_mu", "RegionReplicator._mu"),
        ("RegionReplicator._mu", "TLog._holds_mu"),
        ("RegionReplicator._mu", "TLog._data_cond"),
        ("RegionReplicator._mu", "TLogSystem._data_cond"),
        ("Cluster._recovery_mu", "TLogSystem._data_cond"),
    ] + sorted(PORT_ONLY_EDGES):
        assert edge in declared, f"missing reviewed edge {edge}"
        rev = (edge[1], edge[0])
        assert rev not in declared, f"ABBA: reverse edge {rev} declared"


def _run_witness_sim(seed, tmp_path):
    from foundationdb_tpu_torch.sim.simulation import Simulation
    from foundationdb_tpu_torch.sim.workloads import (
        cycle_check, cycle_setup, cycle_workload)

    lockdep.reset()
    lockdep.enable()
    try:
        sim = Simulation(seed=seed, buggify=True, crash_p=0.004,
                         datadir=str(tmp_path), resolver_backend="cpu")
        n = 12
        cycle_setup(sim.db, n)
        for a in range(2):
            rng = random.Random(seed * 1000 + a)
            sim.add_workload(f"cycle{a}",
                             cycle_workload(sim.db, n, 15, rng))
        sim.run()
        sim.quiesce()
        cycle_check(sim.db, n)
        sim.close()
        return lockdep.witness_doc()
    finally:
        lockdep.reset()
        lockdep.disable()


def test_same_seed_sims_emit_identical_witness_docs(tmp_path):
    a = _run_witness_sim(29, tmp_path / "a")
    b = _run_witness_sim(29, tmp_path / "b")
    assert a == b
    assert json.loads(a)["cycles"] == []


def test_dynamic_edges_are_a_subset_of_the_static_graph(tmp_path, model):
    """Every acquisition order the port's runtime witness observes is an
    edge of the port's static FL006 graph."""
    doc = json.loads(_run_witness_sim(31, tmp_path / "w"))
    assert doc["edges"], "sim exercised no nested acquisition at all"
    static_edges, _funcs = fl006_lockorder.compute_graph(model)
    dynamic = {tuple(e) for e in doc["edges"]}
    assert dynamic <= set(static_edges), sorted(dynamic - set(static_edges))
    assert doc["cycles"] == []


def test_every_thread_site_is_named_and_daemonized():
    """Every ``threading.Thread(`` of the port carries ``name=`` and an
    explicit ``daemon=``, and the port starts the reference's threads."""
    def sites(pkg):
        for path in flowlint.iter_py_files([pkg]):
            if os.sep + "analysis" + os.sep in path:
                continue
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                fn = getattr(node, "func", None)
                if isinstance(node, ast.Call) and isinstance(
                        fn, ast.Attribute) and fn.attr == "Thread" and \
                        isinstance(fn.value, ast.Name) and \
                        fn.value.id == "threading":
                    yield path, node

    def names(pkg):
        out = set()
        for path, node in sites(pkg):
            kw = {k.arg: k.value for k in node.keywords}
            assert "name" in kw, f"{path}:{node.lineno} Thread lacks name="
            assert "daemon" in kw, f"{path}:{node.lineno} lacks daemon="
            if isinstance(kw["name"], ast.Constant):
                out.add(kw["name"].value)
        return out

    got = names(flowlint.package_dir())
    assert len(list(sites(flowlint.package_dir()))) >= 8
    assert names(jflowlint.package_dir()) <= got


def test_batcher_close_joins_its_threads():
    from foundationdb_tpu_torch.core.options import Knobs
    from foundationdb_tpu_torch.server.batcher import BatchingCommitProxy
    from foundationdb_tpu_torch.utils.metrics import MetricsRegistry

    class _Inner:
        knobs = Knobs()
        metrics = MetricsRegistry("test")

        def commit_batch(self, reqs):
            return [("committed", 1, 0)] * len(reqs)

    bp = BatchingCommitProxy(_Inner(), mode="thread")
    threads = [t for t in (bp._thread, bp._apply_thread) if t is not None]
    assert threads, "thread-mode batcher spawned no flusher"
    bp.close()
    for t in threads:
        assert not t.is_alive(), f"{t.name} still alive after close()"


def test_read_batcher_close_joins_its_flusher():
    from foundationdb_tpu_torch.txn.futures import ReadBatcher

    rb = ReadBatcher(send=lambda ops: [b"v"] * len(ops), thread=True)
    t = rb._thread
    assert t is not None and t.is_alive()
    rb.close()
    assert not t.is_alive(), "read-batcher flusher still alive after close()"


def test_rpc_client_close_joins_reader():
    from foundationdb_tpu_torch.rpc.transport import RpcClient, RpcServer

    srv = RpcServer("127.0.0.1", 0, {"ping": lambda: "pong"})
    try:
        cli = RpcClient("127.0.0.1", srv.port)
        assert cli.call("ping") == "pong"
        reader = cli._reader
        assert reader.is_alive()
        cli.close()
        assert not reader.is_alive(), "reader still alive after close()"
    finally:
        srv.close()
