"""flowlint engine + CLI.

Run over the package tree::

    python -m foundationdb_tpu_torch.analysis.flowlint            # whole package
    python -m foundationdb_tpu_torch.analysis.flowlint path/ file.py
    python -m foundationdb_tpu_torch.analysis.flowlint --fix-baseline
    python -m foundationdb_tpu_torch.analysis.flowlint --fix-lockorder
    python -m foundationdb_tpu_torch.analysis.flowlint --fix-errortable
    python -m foundationdb_tpu_torch.analysis.flowlint --fix-faultsites

Exit code 0 = no findings beyond the checked-in baseline
(``analysis/baseline.txt``); 1 = new findings (printed). The baseline
grandfathers pre-existing findings per (rule, file, message) — line
numbers are deliberately NOT part of the key, so edits above a
grandfathered site do not churn the file. ``--fix-baseline`` rewrites
it from the current tree; a finding FIXED in code makes its stale entry
disappear on the next ``--fix-baseline`` (the tree test warns about
stale entries so debt reduction gets recorded).

Per-line suppression: a ``# flowlint: disable=FL003`` comment on the
finding's line (or the line above) suppresses that rule there — for
sites where the pattern is deliberate and the reason is stated inline.
``# flowlint: disable-file=FL004`` anywhere in a file suppresses the
rule for the whole file. A line suppression that no longer matches any
finding is itself a finding (``FLSUP``) — dead suppressions rot into
blanket permission slips, so they fail the run exactly like a stale
baseline entry records unclaimed progress.

v2 (single-parse engine): every run builds one
:class:`~foundationdb_tpu_torch.analysis.model.ProgramModel` — each file is
parsed and tokenized exactly once, shared by all rules — and rules
come in two shapes: per-file (``check(tree, relpath)``) and
program-wide (``PROGRAM = True`` + ``check_model(model)``, for the
cross-module rules FL006–FL011). Per-rule wall time is reported
in ``--json`` (``rule_wall_ms``) so tier-1 lint cost stays observable
as rules grow.

v3 adds the error-propagation rules: FL009 (error taxonomy —
registered codes only, server-side retryability recorded in
``analysis/errortable.txt``), FL010 (retry/backoff discipline), and
FL011 (fault-site coverage — every fabrication site enumerated in
``analysis/faultsites.txt``, mirrored at runtime by
``utils/faultcov.py``). Both tables are checked in with stale-entry
detection and regenerated by their ``--fix-*`` flags.
"""

import argparse
import json
import os
import sys
import time
from collections import Counter

from foundationdb_tpu_torch.analysis.base import Finding
from foundationdb_tpu_torch.analysis.model import build_model, parse_rule_list
from foundationdb_tpu_torch.analysis.rules import ALL_RULES, BY_ID

PKG_NAME = "foundationdb_tpu_torch"

# engine-emitted pseudo-rules (not in ALL_RULES): FL000 = syntax
# error, FLSUP = stale suppression comment
SUPPRESSION_RULE = "FLSUP"


def package_dir():
    import foundationdb_tpu_torch

    return os.path.dirname(os.path.abspath(foundationdb_tpu_torch.__file__))


def default_baseline_path():
    return os.path.join(package_dir(), "analysis", "baseline.txt")


def default_lockorder_path():
    return os.path.join(package_dir(), "analysis", "lockorder.txt")


def module_relpath(path, root):
    """Path keyed relative to the foundationdb_tpu_torch package dir when the
    file lives inside it ("server/batcher.py"), else relative to the
    scan root — baselines stay valid no matter where the CLI runs."""
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    if PKG_NAME in parts:
        i = len(parts) - 1 - parts[::-1].index(PKG_NAME)
        if i < len(parts) - 1:
            return "/".join(parts[i + 1:])
    return os.path.relpath(path, root).replace(os.sep, "/")


def _parse_rule_list(text):
    return parse_rule_list(text)


def _load_test_texts(package_root):
    """Raw text of tests/*.py next to the package — FL008's
    version-gate test references grep these; None when the package is
    installed without its test tree (the checks that need it skip)."""
    if not package_root:
        return None
    tests_dir = os.path.join(os.path.dirname(package_root), "tests")
    if not os.path.isdir(tests_dir):
        return None
    texts = {}
    for fn in sorted(os.listdir(tests_dir)):
        if fn.endswith(".py"):
            try:
                with open(os.path.join(tests_dir, fn),
                          encoding="utf-8") as f:
                    texts[fn] = f.read()
            except OSError:
                continue
    return texts


def build_tree_model(items, abspaths=None):
    """ProgramModel for a scanned file set. ``full_tree`` (the tree
    contracts: lockorder.txt comparison, dead-knob sweep, test
    references) turns on only when the scan covers the real package —
    both anchor files present — so subset and fixture lints stay
    purely structural."""
    relpaths = {rp for rp, _ in items}
    full = "rpc/wire.py" in relpaths and "core/options.py" in relpaths
    package_root = None
    test_texts = None
    if full and abspaths:
        anchor = abspaths.get("rpc/wire.py")
        if anchor:
            package_root = os.path.dirname(os.path.dirname(anchor))
        test_texts = _load_test_texts(package_root)
    return build_model(items, full_tree=full, package_root=package_root,
                       test_texts=test_texts)


def lint_model(model, rules=None, timings=None):
    """All non-suppressed findings for a built model, plus FLSUP
    findings for stale line suppressions. ``timings`` (optional dict)
    accumulates per-rule wall seconds."""
    rules = ALL_RULES if rules is None else rules
    findings = []
    used = set()  # (relpath, comment_line, rule) suppressions that hit
    for fm in model.files.values():
        if fm.syntax_error is not None:
            e = fm.syntax_error
            findings.append(Finding("FL000", fm.relpath, e.lineno or 0,
                                    f"syntax error: {e.msg}"))
    for rule in rules:
        t0 = time.perf_counter()
        raw = []
        if getattr(rule, "PROGRAM", False):
            raw = list(rule.check_model(model))
        else:
            for fm in model.files.values():
                if fm.tree is None or not rule.applies(fm.relpath) or \
                        rule.RULE in fm.file_disabled:
                    continue
                raw.extend(rule.check(fm.tree, fm.relpath))
        for f in raw:
            fm = model.files.get(f.path)
            if fm is not None:
                if f.rule in fm.file_disabled:
                    continue
                dl = fm.line_disabled
                hit = None
                if f.rule in dl.get(f.line, ()):
                    hit = f.line
                elif f.rule in dl.get(f.line - 1, ()):
                    hit = f.line - 1
                if hit is not None:
                    used.add((f.path, hit, f.rule))
                    continue
            findings.append(f)
        if timings is not None:
            timings[rule.RULE] = timings.get(rule.RULE, 0.0) + \
                (time.perf_counter() - t0)
    # stale suppressions: a disable= comment whose rule RAN but
    # filtered nothing is dead weight — fail until it's removed
    ran = {r.RULE for r in rules}
    for fm in model.files.values():
        if fm.tree is None:
            continue
        for line in sorted(fm.line_disabled):
            for rid in sorted(fm.line_disabled[line]):
                if rid not in ran or rid in fm.file_disabled:
                    continue
                if (fm.relpath, line, rid) not in used:
                    findings.append(Finding(
                        SUPPRESSION_RULE, fm.relpath, line,
                        f"stale suppression: disable={rid} no longer "
                        f"matches any finding here — remove it"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_source(relpath, text, rules=None):
    """All non-suppressed findings for one file's source text."""
    model = build_tree_model([(relpath, text)])
    return lint_model(model, rules)


# the package's build directory holds what it builds at run time and
# unpacked trees of other commits (gitignored), never its own source
BUILD_DIR = "build"


def iter_py_files(paths):
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(
                d for d in dirnames
                if not d.startswith((".", "__pycache__"))
                and not (d == BUILD_DIR and os.path.samefile(
                    dirpath, package_dir()))
            )
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def _read_items(paths):
    items, abspaths = [], {}
    for path in iter_py_files(paths):
        root = paths[0] if os.path.isdir(paths[0]) else \
            os.path.dirname(paths[0]) or "."
        with open(path, encoding="utf-8") as f:
            text = f.read()
        rp = module_relpath(path, root)
        items.append((rp, text))
        abspaths[rp] = os.path.abspath(path)
    return items, abspaths


def lint_paths(paths, rules=None, timings=None):
    items, abspaths = _read_items(paths)
    model = build_tree_model(items, abspaths)
    return lint_model(model, rules, timings)


# ───────────────────────────── baseline ─────────────────────────────
def baseline_key(finding):
    return f"{finding.rule}\t{finding.path}\t{finding.message}"


def load_baseline(path):
    """Multiset of grandfathered finding keys (missing file = empty)."""
    counts = Counter()
    if not os.path.exists(path):
        return counts
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            counts[line] += 1
    return counts


def format_baseline(findings):
    header = (
        "# flowlint baseline — grandfathered findings, one per line:\n"
        "#   RULE<TAB>path<TAB>message\n"
        "# Regenerate: python -m foundationdb_tpu_torch.analysis.flowlint "
        "--fix-baseline\n"
        "# Policy: FL001/FL002/FL003/FL005/FL006/FL007/FL008/FL009/"
        "FL010/FL011 must stay EMPTY here (fix, sanction in "
        "lockorder.txt / errortable.txt / faultsites.txt, or suppress "
        "inline with a reason); FL004 entries are lint debt to burn "
        "down.\n"
    )
    body = "".join(
        key + "\n" for key in sorted(baseline_key(f) for f in findings)
    )
    return header + body


def split_by_baseline(findings, baseline):
    """(new, grandfathered, stale_keys): findings beyond the baseline's
    per-key multiplicity are new; baseline keys the tree no longer
    produces are stale (fixed — regenerate to record the progress)."""
    used = Counter()
    new, old = [], []
    for f in findings:
        key = baseline_key(f)
        if used[key] < baseline.get(key, 0):
            used[key] += 1
            old.append(f)
        else:
            new.append(f)
    stale = [
        key for key, n in baseline.items() if used.get(key, 0) < n
        for _ in range(n - used.get(key, 0))
    ]
    return new, old, stale


def count_findings(paths=None):
    """Total findings (suppressions honored, baseline IGNORED) over the
    package — the lint-debt gauge."""
    findings = lint_paths(paths or [package_dir()])
    return len(findings)


def count_findings_by_rule(paths=None):
    """Per-rule split of :func:`count_findings`, so a regression names
    its rule without a rerun."""
    findings = lint_paths(paths or [package_dir()])
    return dict(sorted(Counter(f.rule for f in findings).items()))


# ─────────────────────────────── CLI ────────────────────────────────
def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m foundationdb_tpu_torch.analysis.flowlint",
        description="AST invariant checker for foundationdb_tpu_torch "
                    "(FL001 determinism, FL002 future settlement, "
                    "FL003 lock discipline, FL004 capture purity, "
                    "FL005 exception hygiene, FL006 lock order, "
                    "FL007 thread escape, FL008 protocol/knob drift, "
                    "FL009 error taxonomy, FL010 retry discipline, "
                    "FL011 fault-site coverage).",
    )
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the installed "
                         "foundationdb_tpu_torch package)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: "
                         "foundationdb_tpu_torch/analysis/baseline.txt)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, baseline ignored")
    ap.add_argument("--fix-baseline", action="store_true",
                    help="rewrite the baseline from the current tree "
                         "and exit 0")
    ap.add_argument("--fix-lockorder", action="store_true",
                    help="regenerate analysis/lockorder.txt from the "
                         "current tree's lock-acquisition graph "
                         "(sanctioned '<>' pairs are preserved)")
    ap.add_argument("--fix-errortable", action="store_true",
                    help="regenerate analysis/errortable.txt (FL009 "
                         "non-retryable classifications) from the "
                         "current tree")
    ap.add_argument("--fix-faultsites", action="store_true",
                    help="regenerate analysis/faultsites.txt (FL011 "
                         "fault-site enumeration) from the current "
                         "tree")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run "
                         "(default: all)")
    args = ap.parse_args(argv)

    paths = args.paths or [package_dir()]
    rules = None
    if args.rules:
        wanted = _parse_rule_list(args.rules)
        unknown = wanted - set(BY_ID)
        if unknown:
            ap.error(f"unknown rule ids: {sorted(unknown)}")
        rules = [BY_ID[r] for r in sorted(wanted)]
    baseline_path = args.baseline or default_baseline_path()

    if args.fix_lockorder:
        from foundationdb_tpu_torch.analysis.rules import fl006_lockorder

        items, abspaths = _read_items(paths)
        model = build_tree_model(items, abspaths)
        path = fl006_lockorder.rewrite_lockorder(model)
        print(f"lockorder rewritten: {path}")
        return 0

    if args.fix_errortable:
        from foundationdb_tpu_torch.analysis.rules import fl009_errortaxonomy

        items, abspaths = _read_items(paths)
        model = build_tree_model(items, abspaths)
        path = fl009_errortaxonomy.rewrite_errortable(model)
        print(f"errortable rewritten: {path}")
        return 0

    if args.fix_faultsites:
        from foundationdb_tpu_torch.analysis.rules import fl011_faultsites

        items, abspaths = _read_items(paths)
        model = build_tree_model(items, abspaths)
        path = fl011_faultsites.rewrite_faultsites(model)
        print(f"faultsites rewritten: {path}")
        return 0

    timings = {}
    findings = lint_paths(paths, rules, timings)

    if args.fix_baseline:
        with open(baseline_path, "w", encoding="utf-8") as f:
            f.write(format_baseline(findings))
        print(f"baseline rewritten: {baseline_path} "
              f"({len(findings)} entries)")
        return 0

    baseline = Counter() if args.no_baseline else \
        load_baseline(baseline_path)
    new, old, stale = split_by_baseline(findings, baseline)

    rule_wall_ms = {r: round(s * 1000.0, 2)
                    for r, s in sorted(timings.items())}
    if args.json:
        print(json.dumps({
            "new": [f._asdict() for f in new],
            "baselined": len(old),
            "stale_baseline": len(stale),
            "total": len(findings),
            "rule_wall_ms": rule_wall_ms,
        }, indent=2))
    else:
        for f in new:
            print(f"{f.path}:{f.line}: {f.rule} {f.message}")
        per_rule = Counter(f.rule for f in findings)
        summary = ", ".join(
            f"{r}={n}" for r, n in sorted(per_rule.items())
        ) or "none"
        wall = sum(timings.values()) * 1000.0
        print(f"flowlint: {len(new)} new finding(s), {len(old)} "
              f"baselined, {len(stale)} stale baseline entr(ies); "
              f"totals: {summary}; rules {wall:.0f}ms")
        if stale:
            print("stale baseline entries (fixed in the tree — run "
                  "--fix-baseline to record the progress):")
            for key in stale:
                print(f"  {key}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
