"""The fault-coverage witness and reporter on the port, held to the JAX
package: the runtime witness's cases of tests/test_flowlint_v3.py, the
seeded chaos probe (``tools/faultcov.py``) against the reference's
probe and the port's own faultsites.txt, the reporter's CLI, and the
sites that the port once fired under other names than the reference's
(the commit proxy's 1020 and 1021, ``Transaction.set``'s 2101): each
repro runs on both packages with the witness on, and the port's fired
sites must be the reference's with only the package prefix mapped."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

from foundationdb_tpu.tools import faultcov as jreport  # noqa: E402
from foundationdb_tpu_torch.core.errors import FDBError, err  # noqa: E402
from foundationdb_tpu_torch.tools import faultcov as report  # noqa: E402
from foundationdb_tpu_torch.utils import faultcov  # noqa: E402
from tests.test_torch_cluster import TEST_KNOBS  # noqa: E402
from tests.torch_sides import JAX, PORT, request  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 11
SITE = f"{faultcov.PACKAGE}.core.keys:KeyRange.__init__:2005"


def mapped(fired):
    """The reference's fired sites in the port's id form."""
    return {f"{faultcov.PACKAGE}.{site}": n for site, n in fired.items()}


@pytest.fixture
def witness():
    faultcov.reset()
    faultcov.enable()
    yield faultcov
    faultcov.disable()
    faultcov.reset()


# ─────────────────────── the runtime witness ───────────────────────
def test_faultcov_disabled_is_inert():
    faultcov.reset()
    faultcov.disable()
    FDBError(1037)
    assert faultcov.fired() == frozenset()
    assert faultcov.witness_doc() == '{"fired":{}}'


def test_faultcov_attributes_package_sites(witness):
    """A fabrication inside the package fires its FL011 site id; one
    outside it (this test) fires nothing."""
    from foundationdb_tpu_torch.core.keys import KeyRange

    with pytest.raises(FDBError):
        KeyRange(b"z", b"a")
    FDBError(1037)
    assert witness.fired() == {SITE}
    assert witness.counts()[SITE] == 1
    assert witness.fired_codes() == {2005}
    assert SITE in report.load_table()


def test_faultcov_counts_accumulate_and_reset(witness):
    from foundationdb_tpu_torch.core.keys import KeyRange

    for _ in range(3):
        with pytest.raises(FDBError):
            KeyRange(b"z", b"a")
    assert witness.counts()[SITE] == 3
    witness.reset()
    assert witness.fired() == frozenset()


def test_faultcov_witness_doc_is_canonical(witness):
    from foundationdb_tpu_torch.core.keys import KeyRange

    with pytest.raises(FDBError):
        KeyRange(b"z", b"a")
    doc = witness.witness_doc()
    assert doc == json.dumps(json.loads(doc), sort_keys=True,
                             separators=(",", ":"))
    assert json.loads(doc)["fired"] == {SITE: 1}


def test_faultcov_qualname_index_matches_static_rule():
    import ast

    tree = ast.parse(textwrap.dedent("""
        import functools

        class Outer:
            @functools.lru_cache()
            def cached(self):
                pass

            def plain(self):
                def inner():
                    pass
                return inner
    """))
    idx = faultcov.qualname_index(tree)
    assert idx[5] == "Outer.cached"
    assert idx[6] == "Outer.cached"
    assert idx[9] == "Outer.plain"
    assert idx[10] == "Outer.plain.inner"


def test_err_unknown_name_raises_clear_valueerror():
    with pytest.raises(ValueError, match="proces_behind"):
        err("proces_behind")
    with pytest.raises(ValueError, match="core/errors.py"):
        FDBError.from_name("definitely_not_registered")
    e = err("process_behind", "lagging badly")
    assert e.code == 1037 and "lagging badly" in str(e)


# ─────────────────────── the chaos probe ───────────────────────
@pytest.fixture(scope="module")
def probes():
    """The reference's probe at seed 11 (its host set) and the port's
    twice, on the host set: the snapshots as text."""
    want = jreport.run_probe(seed=SEED)
    got = [report.run_probe(seed=SEED, resolver_backend="cpu")
           for _ in range(2)]
    return want, got


def test_same_seed_probes_emit_identical_witness_docs(probes):
    _, (a, b) = probes
    assert a == b
    assert json.loads(a)["fired"]


def test_probe_fires_the_references_sites(probes):
    """Site for site and count for count the reference's probe, with
    only the package prefix mapped."""
    want, (got, _) = probes
    assert json.loads(got)["fired"] == mapped(json.loads(want)["fired"])


def test_probe_fires_every_chaos_code_within_static_table(probes):
    fired = json.loads(probes[1][0])["fired"]
    codes = {int(s.rsplit(":", 1)[1]) for s in fired}
    assert {1007, 1009, 1020, 1021, 1037} <= codes
    rep = report.coverage_report(fired, report.load_table())
    assert rep["violations"] == []
    assert 0 < rep["sites_fired"] <= rep["sites_total"]
    assert rep["never_fired"]
    assert rep["sites_fired"] + len(rep["never_fired"]) == \
        rep["sites_total"]


def test_probe_report_equals_the_references(probes):
    """The port's report on its table equals the reference's on its own,
    ids mapped, the deliberate absence aside."""
    from tests.test_torch_flowlint_v3 import DELIBERATE_ABSENCES

    want, (got, _) = probes
    jrep = jreport.coverage_report(json.loads(want)["fired"],
                                   jreport.load_table())
    rep = report.coverage_report(json.loads(got)["fired"],
                                 report.load_table())
    assert rep["sites_fired"] == jrep["sites_fired"]
    assert rep["violations"] == jrep["violations"] == []
    assert rep["fired_counts"] == mapped(jrep["fired_counts"])
    gone = {f"{faultcov.PACKAGE}.{s}" for s in DELIBERATE_ABSENCES}
    assert rep["never_fired"] == sorted(
        set(mapped(dict.fromkeys(jrep["never_fired"]))) - gone)


def test_report_tool_cli_roundtrip(tmp_path, capsys, probes):
    snap = tmp_path / "witness.json"
    snap.write_text(probes[1][0])
    rc = report.main(["--snapshot", str(snap)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "fault coverage:" in out
    assert "never fired:" in out

    bogus = tmp_path / "bogus.json"
    bogus.write_text(json.dumps(
        {"fired": {f"{faultcov.PACKAGE}.server.nowhere:ghost:9999": 1}}))
    rc = report.main(["--snapshot", str(bogus), "--json"])
    out = capsys.readouterr().out
    assert rc == 1
    assert json.loads(out)["violations"] == \
        [f"{faultcov.PACKAGE}.server.nowhere:ghost:9999"]


def test_cli_probe_passes_device_and_saves_the_snapshot(tmp_path, capsys,
                                                        monkeypatch, probes):
    """``--probe --device cpu --save FILE --json``: the probe gets the
    device, the snapshot lands in FILE, the report on stdout is the
    snapshot's."""
    seen = {}

    def fake(seed, device=None):
        seen.update(seed=seed, device=device)
        return probes[1][0]

    monkeypatch.setattr(report, "run_probe", fake)
    path = tmp_path / "w.json"
    rc = report.main(["--probe", "--device", "cpu", "--save", str(path),
                      "--json"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0 and seen == {"seed": SEED, "device": "cpu"}
    assert path.read_text() == probes[1][0]
    assert rep == report.coverage_report(
        json.loads(probes[1][0])["fired"], report.load_table())
    with pytest.raises(SystemExit):
        report.main(["--snapshot", str(path), "--save", str(path)])


def test_snapshot_mode_imports_no_torch(tmp_path, probes):
    """``--snapshot`` in a process of its own: the report, and no
    ``torch`` (nor ``jax`` or the JAX package) loaded."""
    snap = tmp_path / "witness.json"
    snap.write_text(probes[1][0])
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['foundationdb_tpu'] = None\n"
        "from foundationdb_tpu_torch.tools import faultcov\n"
        f"rc = faultcov.main(['--snapshot', {str(snap)!r}, '--json'])\n"
        "print('torch' in sys.modules, rc)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    body, last = out.stdout.rsplit("\n", 2)[0], out.stdout.split("\n")[-2]
    assert last == "False 0"
    assert json.loads(body) == report.coverage_report(
        json.loads(probes[1][0])["fired"], report.load_table())


# ─────────────── the sites the port once named otherwise ───────────────
def _results(rs):
    return [getattr(r, "code", r) for r in rs]


def _sequencer_down(side):
    return sys.modules[side.sequencer.__module__].SequencerDown


def _two(side, rv=0):
    return [[request(side, rv, sets=[(b"a", b"1")])],
            [request(side, rv, sets=[(b"b", b"1")])]]


def _proxy_killed(side, c):
    c.commit_proxy.kill()
    return _results(c.commit_proxy.commit_batch(
        [request(side, 0, sets=[(b"a", b"1")])]))


def _resolver_down(side, c):
    c.resolvers[0].kill()
    return _results(c.commit_proxy.commit_batch(
        [request(side, c.sequencer.committed_version,
                 sets=[(b"a", b"1")])]))


def _grant_raced(side, c):
    """The sequencer dies between the entry check and the grant."""
    def down(n):
        raise _sequencer_down(side)()

    c.sequencer.next_commit_versions = down
    return _results(c.commit_proxy.commit_batch(
        [request(side, 0, sets=[(b"a", b"1")])]))


def _backlog_resolver_down(side, c):
    c.resolvers[0].kill()
    rv = c.sequencer.committed_version
    return [_results(r) for r in c.commit_proxy.commit_batches(_two(side, rv))]


def _backlog_grant_raced(side, c):
    def down(n):
        raise _sequencer_down(side)()

    c.sequencer.next_commit_versions = down
    return [_results(r) for r in c.commit_proxy.commit_batches(_two(side))]


def _begin_resolver_down(side, c):
    c.resolvers[0].kill()
    p = c.commit_proxy
    g = p.commit_batches_begin(_two(side, c.sequencer.committed_version))
    return [_results(r) for r in p.commit_batches_finish(g)]


def _begin_sequencer_down(side, c):
    c.sequencer.kill()
    p = c.commit_proxy
    g = p.commit_batches_begin(_two(side))
    return [_results(r) for r in p.commit_batches_finish(g)]


def _finish_step_faults(side, c):
    """The dispatched step faults when its verdicts are read."""
    class Faulted:
        def wait(self):
            raise RuntimeError("injected")

    p = c.commit_proxy
    g = p.commit_batches_begin(_two(side, c.sequencer.committed_version))
    g.handle = Faulted()
    return [_results(r) for r in p.commit_batches_finish(g)]


def _finish_after_kill(side, c):
    p = c.commit_proxy
    g = p.commit_batches_begin(_two(side, c.sequencer.committed_version))
    p.kill()
    return [_results(r) for r in p.commit_batches_finish(g)]


def _too_large(side, c):
    tr = c.database().create_transaction()
    with pytest.raises(side.error) as ei:
        tr.set(b"k", b"v" * 200)
    return ei.value.code


def _fleet_wedged(side, c):
    """A stolen grant strands a turn: the member times out at the gate."""
    p1 = c.commit_proxy.inners[1]
    c.sequencer.next_commit_versions(1)
    return _results(p1.commit_batch(
        [request(side, c.sequencer.committed_version, sets=[(b"a", b"1")])]))


REPROS = {
    # name: (script, cluster arguments, the reference's fired site)
    "proxy_killed": (_proxy_killed, {},
                     "server.proxy:CommitProxy.commit_batch:1021"),
    "resolver_down": (_resolver_down, {},
                      "server.proxy:CommitProxy._commit_batch_admitted:1020"),
    "grant_raced": (_grant_raced, {},
                    "server.proxy:CommitProxy._commit_batch_admitted:1021"),
    "backlog_resolver_down": (
        _backlog_resolver_down, {},
        "server.proxy:CommitProxy._commit_batches_locked:1020"),
    "backlog_grant_raced": (
        _backlog_grant_raced, {},
        "server.proxy:CommitProxy._commit_batches_locked:1021"),
    "begin_resolver_down": (
        _begin_resolver_down, {},
        "server.proxy:CommitProxy.commit_batches_begin:1020"),
    "begin_sequencer_down": (
        _begin_sequencer_down, {},
        "server.proxy:CommitProxy.commit_batches_begin.err_1021:1021"),
    "finish_step_faults": (
        _finish_step_faults, {},
        "server.proxy:CommitProxy.commit_batches_finish:1021"),
    "finish_after_kill": (
        _finish_after_kill, {},
        "server.proxy:CommitProxy.commit_batches_finish:1021"),
    "fleet_wedged": (
        _fleet_wedged, {"n_commit_proxies": 2, "gate_timeout_s": 0.2},
        "server.proxy:CommitProxy._gate_wedged:1021"),
    "transaction_too_large": (
        _too_large, {"transaction_size_limit": 100},
        "txn.transaction:Transaction.set:2101"),
}


def _fired(side, name):
    script, kw, _ = REPROS[name]
    c = side.cluster(**dict(TEST_KNOBS, **kw))
    side.faultcov.reset()
    side.faultcov.enable()
    try:
        out = script(side, c)
    finally:
        side.faultcov.disable()
        c.close()
    fired = side.faultcov.counts()
    side.faultcov.reset()
    return out, fired


@pytest.mark.parametrize("name", sorted(REPROS))
def test_fault_site_matches_jax(name):
    """The same outcome on both packages, and the port's witness fires
    the reference's site ids with only the package prefix mapped."""
    want_out, want = _fired(JAX, name)
    got_out, got = _fired(PORT, name)
    assert got_out == want_out
    assert REPROS[name][2] in want
    assert got == mapped(want)
    assert set(got) <= set(report.load_table())


def test_proxy_has_no_error_helper():
    """Every proxy 1020 and 1021 is built where the reference builds it:
    no helper folds them into one site."""
    from foundationdb_tpu_torch.server import proxy

    assert not hasattr(proxy, "_errors")
