"""Fault-coverage reporter: fired runtime sites vs the static table.

flowlint FL011 enumerates every coded-error fabrication site in the
tree into ``analysis/faultsites.txt``; the runtime witness
(``utils/faultcov.py``) counts which of those sites actually fire.
This tool closes the loop — the reference's question "did the chaos
campaign reach this error path?" becomes a diff between two sets:

* **never-fired** sites — enumerated statically, not driven by the
  run. Coverage debt, reported but not fatal (a single run cannot
  reach everything).
* **violations** — fired sites absent from the static table. These
  fail the run (exit 1): either FL011's enumeration has a hole or a
  fabrication site dodged the lint, and both are bugs. Matching is
  wildcard-aware: a fired ``module:qualname:code`` is covered by a
  ``module:qualname:*`` entry (dynamic-name sites can fabricate any
  code).

Both sides name a site ``foundationdb_tpu_torch.<module>:<qualname>:
<code>``, so they diff with no mapping.

Input is a witness snapshot — the canonical ``witness_doc()`` JSON —
from ``--snapshot FILE``, or produced in-process by ``--probe``, which
runs the canonical seeded chaos simulation (buggify + crashes +
machine kills over conflicting cycle/counter workloads). The probe is
deterministic: the same ``--seed`` yields byte-identical snapshots.

Like every entry point of the port, the probe's cluster runs on
``cuda:0`` and raises without a card: ``--device cpu`` (``device=
"cpu"``) runs the same device step on the CPU, and ``run_probe(
resolver_backend="cpu")`` resolves on the host set, the JAX package's
default for its simulator. ``--snapshot`` imports no ``torch``.

Usage::

    python -m foundationdb_tpu_torch.tools.faultcov --probe
    python -m foundationdb_tpu_torch.tools.faultcov --probe --device cpu
    python -m foundationdb_tpu_torch.tools.faultcov --probe --seed 7 --json
    python -m foundationdb_tpu_torch.tools.faultcov --probe --save w.json
    python -m foundationdb_tpu_torch.tools.faultcov --snapshot w.json
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

DEFAULT_PROBE_SEED = 11


def _table_path():
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(pkg, "analysis", "faultsites.txt")


def load_table(path=None):
    """``{site_id: table_line}`` from faultsites.txt (FL011's format)."""
    from foundationdb_tpu_torch.analysis.rules.fl011_faultsites import (
        load_faultsites,
    )

    path = path or _table_path()
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return load_faultsites(f.read())


def site_covered(site, table):
    """Wildcard-aware membership: an exact entry, or the site's
    ``module:qualname:*`` dynamic entry."""
    if site in table:
        return True
    return site.rsplit(":", 1)[0] + ":*" in table


def coverage_report(fired_counts, table):
    """The diff the CLI and the chip check read:

    ``sites_total``/``sites_fired``/``coverage_pct`` count STATIC
    table entries (a wildcard entry counts fired when any of its codes
    fired); ``never_fired`` lists unreached entries; ``violations``
    lists fired sites the table does not cover."""
    fired = set(fired_counts)
    hit = set()
    for site in fired:
        if site in table:
            hit.add(site)
        else:
            wild = site.rsplit(":", 1)[0] + ":*"
            if wild in table:
                hit.add(wild)
    total = len(table)
    return {
        "sites_total": total,
        "sites_fired": len(hit),
        "coverage_pct": round(100.0 * len(hit) / total, 2) if total
        else 0.0,
        "never_fired": sorted(set(table) - hit),
        "violations": sorted(s for s in fired
                             if not site_covered(s, table)),
        "fired_counts": {s: fired_counts[s] for s in sorted(fired)},
    }


def _version_skew_reader(cluster, n_ops):
    """Clients racing the MVCC window from both ends — what the RPC
    deployment's storageworker wait/fence path produces against a
    lagging or trimmed replica: a read version ahead of storage
    (1009 future_version) and one held past the oldest retained
    version (1007 transaction_too_old). Both retryable; the probe
    bounds them instead of retrying."""
    from foundationdb_tpu_torch.core.errors import FDBError

    router = cluster.storage
    for _ in range(n_ops):
        yield
        for skew_version in (router.version + 50, -1):
            try:
                router.get(b"cycle/skew-probe", skew_version)
            except FDBError as e:
                if e.code not in (1007, 1009, 1037):
                    raise


def run_probe(seed=DEFAULT_PROBE_SEED, datadir=None, steps_budget=None,
              device=None, resolver_backend=None):
    """The canonical chaos probe: a seeded simulation under the full
    fault battery, faultcov armed, returning the canonical witness
    snapshot (JSON text). Deterministic per seed — same seed, byte-
    identical snapshot.

    The fault surface is chosen to reach every client-visible chaos
    code: buggified commit/GRV proxies (1021, 1037), conflicting
    cycle workloads (1020 not_committed), crash/recovery plus machine
    kills (1007 transaction_too_old, 1009 future_version via storage
    fencing and lag).

    ``device`` is the resolver's device (``None``: ``cuda:0``, which
    raises without a card); ``resolver_backend="cpu"`` resolves on the
    host set instead of the device step."""
    import random

    from foundationdb_tpu_torch.sim.simulation import Simulation
    from foundationdb_tpu_torch.sim.workloads import (
        counter_workload,
        cycle_setup,
        cycle_workload,
        slow_cycle_workload,
    )
    from foundationdb_tpu_torch.utils import faultcov

    cluster_kw = {"device": device}
    if resolver_backend is not None:
        cluster_kw["resolver_backend"] = resolver_backend
    owns_dir = datadir is None
    if owns_dir:
        datadir = tempfile.mkdtemp(prefix="fdbtorch-faultcov-")
    faultcov.reset()
    faultcov.enable()
    try:
        sim = Simulation(seed=seed, buggify=True, crash_p=0.01,
                         machines=4, datadir=datadir, **cluster_kw)
        # force-activate the client-path fault sites (activation is
        # otherwise a 25% coin per seed — the probe must certainly
        # reach 1021 and 1037; same idiom as the idempotency sims)
        sim.buggify._sites["commit_dropped"] = True
        sim.buggify._sites["commit_applied_then_unknown"] = True
        sim.buggify._sites["grv_rejected"] = True
        with sim:
            n_nodes = 12
            cycle_setup(sim.db, n_nodes)
            stats = {"committed": 0, "retried_1021": 0}
            for a in range(3):
                rng = random.Random(seed * 1000 + a)
                sim.add_workload(
                    f"cycle{a}",
                    cycle_workload(sim.db, n_nodes, 25, rng))
                sim.add_workload(
                    f"slow{a}",
                    slow_cycle_workload(sim.db, n_nodes, 12, rng))
            sim.add_workload(
                "ctr", counter_workload(sim.db, 30, stats))
            sim.add_workload(
                "skew", _version_skew_reader(sim.cluster, 10))
            sim.run(max_steps=steps_budget or 1_000_000)
            sim.quiesce()
        return faultcov.witness_doc()
    finally:
        faultcov.disable()
        faultcov.reset()
        if owns_dir:
            shutil.rmtree(datadir, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m foundationdb_tpu_torch.tools.faultcov",
        description="diff runtime-fired fault sites against the "
                    "static FL011 enumeration (analysis/faultsites"
                    ".txt); exit 1 on fired-but-unenumerated sites",
    )
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--snapshot", metavar="FILE",
                     help="witness_doc() JSON to analyze ('-' = stdin)")
    src.add_argument("--probe", action="store_true",
                     help="run the canonical seeded chaos simulation "
                          "to produce the snapshot in-process")
    ap.add_argument("--seed", type=int, default=DEFAULT_PROBE_SEED,
                    help="probe simulation seed (default: "
                         f"{DEFAULT_PROBE_SEED})")
    ap.add_argument("--device", default=None,
                    help="the probe's resolver device (default cuda:0; "
                         "cpu runs the device step's plain version)")
    ap.add_argument("--save", metavar="FILE", default=None,
                    help="write the probe's witness snapshot to FILE")
    ap.add_argument("--table", default=None,
                    help="faultsites.txt override (default: the "
                         "installed package's)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)
    if args.save and not args.probe:
        ap.error("--save needs --probe")

    if args.probe:
        doc = run_probe(seed=args.seed, device=args.device)
        if args.save:
            with open(args.save, "w", encoding="utf-8") as f:
                f.write(doc)
    elif args.snapshot == "-":
        doc = sys.stdin.read()
    else:
        with open(args.snapshot, encoding="utf-8") as f:
            doc = f.read()
    fired_counts = json.loads(doc).get("fired", {})
    table = load_table(args.table)
    rep = coverage_report(fired_counts, table)

    if args.json:
        print(json.dumps(rep, indent=2, sort_keys=True))
    else:
        print(f"fault coverage: {rep['sites_fired']}/"
              f"{rep['sites_total']} enumerated sites fired "
              f"({rep['coverage_pct']}%)")
        for site in rep["never_fired"]:
            print(f"  never fired: {site}")
        for site in rep["violations"]:
            print(f"  VIOLATION — fired but not enumerated: {site}")
    return 1 if rep["violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
