"""The port's tier-1 lint gate: flowlint over ``foundationdb_tpu_torch``
must be clean against the port's own tables, within a wall bound, in a
process that loads no ``torch``. The tree's model is built once for the
file."""

import json
import os
import subprocess
import sys
import tempfile

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

from foundationdb_tpu_torch.analysis import flowlint  # noqa: E402
from foundationdb_tpu_torch.analysis.model import build_model  # noqa: E402
from foundationdb_tpu_torch.analysis.rules import fl011_faultsites  # noqa: E402
from tests.torch_flowlint_twin import port_tree_items  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the rules' wall over the port's tree, all eleven: at least three
# times the worst of three runs under the six-worker test command (the
# measurements are in CHANGES.md)
WALL_BOUND_MS = 30_000


@pytest.fixture(scope="module")
def tree():
    items, abspaths = port_tree_items()
    return items, flowlint.build_tree_model(items, abspaths)


def _fmt(findings):
    return "\n".join(
        f"{f.path}:{f.line}: {f.rule} {f.message}" for f in findings)


def test_package_tree_has_no_new_findings_within_the_wall_bound(tree):
    """Every rule over the port's tree: no finding beyond the baseline
    (which is empty), no stale baseline entry, and the rules' wall under
    its bound with each rule's time reported."""
    _, model = tree
    timings = {}
    findings = flowlint.lint_model(model, timings=timings)
    baseline = flowlint.load_baseline(flowlint.default_baseline_path())
    new, _old, stale = flowlint.split_by_baseline(findings, baseline)
    assert not new, _fmt(new)
    assert not stale, "\n".join(stale)
    assert findings == []
    from foundationdb_tpu_torch.analysis.rules import ALL_RULES

    assert set(timings) == {r.RULE for r in ALL_RULES}
    wall_ms = sum(timings.values()) * 1000.0
    assert wall_ms < WALL_BOUND_MS, (
        f"port lint wall {wall_ms:.0f} ms >= {WALL_BOUND_MS} ms: "
        + ", ".join(f"{r} {s * 1e3:.0f}" for r, s in sorted(timings.items())))


def test_baseline_is_empty_for_hard_rules():
    """Every rule but FL004 carries no grandfathered finding — and the
    port's FL004 carries none either."""
    baseline = flowlint.load_baseline(flowlint.default_baseline_path())
    assert list(baseline) == []


def test_v3_rules_are_registered_program_rules():
    from foundationdb_tpu_torch.analysis.rules import ALL_RULES, BY_ID

    assert sorted(BY_ID) == [f"FL{i:03d}" for i in range(1, 12)]
    for rid in ("FL006", "FL007", "FL008", "FL009", "FL010", "FL011"):
        assert getattr(BY_ID[rid], "PROGRAM", False)
        assert BY_ID[rid] in ALL_RULES


def test_desynced_faultsites_table_is_caught(tree):
    """Dropping a real entry from the port's faultsites.txt surfaces as
    an unenumerated site, a made-up entry as stale."""
    items, _ = tree
    table = os.path.join(flowlint.package_dir(), "analysis",
                         "faultsites.txt")
    with open(table, encoding="utf-8") as f:
        lines = f.read().splitlines(keepends=True)
    sites = [ln for ln in lines if ln.strip()
             and not ln.lstrip().startswith("#")]
    assert sites
    dropped = lines.copy()
    dropped.remove(sites[0])
    dropped_site = sites[0].split()[0]
    ghost = "foundationdb_tpu_torch.server.nowhere:ghost:9999"
    with tempfile.TemporaryDirectory() as td:
        os.mkdir(os.path.join(td, "analysis"))
        with open(os.path.join(td, "analysis", "faultsites.txt"), "w",
                  encoding="utf-8") as f:
            f.writelines(dropped + [ghost + "\n"])
        model = build_model(items, full_tree=True, package_root=td)
        msgs = [f.message for f in fl011_faultsites.check_model(model)]
    assert any(f"unenumerated fault site: {dropped_site}" in m
               for m in msgs), msgs
    assert any(f"stale fault site: {ghost}" in m for m in msgs), msgs


@pytest.mark.parametrize("rewrite", [
    ("rpc/coordination.py",
     'deterministic.rng("proposer-id").getrandbits(64)',
     "random.getrandbits(64)", "FL001"),
    ("rpc/transport.py", "nonce = os.urandom(16)  # flowlint: disable=FL001",
     "nonce = os.urandom(16)", "FL001"),
    ("rpc/transport.py", "sock.sendall(msg)  # flowlint: disable=FL003",
     "sock.sendall(msg)", "FL003"),
], ids=["proposer_id", "auth_nonce", "frame_send"])
def test_reverting_a_migrated_site_is_caught(rewrite):
    """The tree's migrated forms ship; each reverted one is a fresh
    finding no baseline shields: the seeded proposer id, and the two
    suppressions whose inline reasons the port carries as the reference
    does."""
    relpath, shipped, regressed_form, rule = rewrite
    with open(os.path.join(flowlint.package_dir(), relpath),
              encoding="utf-8") as f:
        src = f.read()
    assert shipped in src
    regressed = src.replace(shipped, regressed_form)
    found = [f for f in flowlint.lint_source(relpath, regressed)
             if f.rule == rule]
    assert found
    baseline = flowlint.load_baseline(flowlint.default_baseline_path())
    new, _old, _stale = flowlint.split_by_baseline(found, baseline)
    assert new


def test_cli_is_clean_in_a_process_without_torch():
    """``python -m foundationdb_tpu_torch.analysis.flowlint --json``
    over the port's tree exits 0 with no finding, each rule's time in
    the document, and the process never loads torch (jax and the JAX
    package blocked)."""
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['foundationdb_tpu'] = None\n"
        "sys.argv = ['flowlint', '--json']\n"
        "try:\n"
        "    runpy.run_module('foundationdb_tpu_torch.analysis.flowlint',"
        " run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print(e.code, 'torch' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    body, last = out.stdout.rsplit("\n", 2)[0], out.stdout.split("\n")[-2]
    assert last == "0 False"
    doc = json.loads(body)
    assert doc["new"] == [] and doc["total"] == 0
    assert len(doc["rule_wall_ms"]) == 11


def test_the_packages_build_directory_is_not_linted(tmp_path, monkeypatch):
    """``foundationdb_tpu_torch/build/`` holds what the package builds at
    run time and unpacked trees of other commits: the walk skips it at
    the package's root, and only there."""
    pkg = tmp_path / "pkg"
    for rel in ("server/a.py", "build/trees/parent/x.py",
                "server/build/b.py"):
        (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
        (pkg / rel).write_text("import os\n\nNONCE = os.urandom(4)\n")
    monkeypatch.setattr(flowlint, "package_dir", lambda: str(pkg))
    got = sorted(os.path.relpath(p, pkg)
                 for p in flowlint.iter_py_files([str(pkg)]))
    assert got == ["server/a.py", "server/build/b.py"]
