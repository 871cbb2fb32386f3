"""Trees of this repo on one card in turn: each tree's chip_smoke.py end
to end, its seconds split by the phase that printed each line.

    python3 chip_phases.py [--out DIR] TREE [TREE ...]

A tree is a checkout of a commit, for example ``git archive`` of the
parent commit unpacked into a gitignored directory. The trees run in the
order given, each in a process of its own from the tree's root: give
OLD NEW NEW OLD to alternate, so that a drift of the host's speed over
the call falls on both trees alike.

Each line a run prints is stamped with the seconds since the run began.
A line's tag, the first word inside its leading brackets (``[pipeline
mako] ...`` is ``pipeline``), names the phase that printed it, and the
seconds since the line before are charged to that phase: every phase of
chip_smoke.py logs after its work, so a phase's seconds are its work's.
A line without a tag is charged to the tag before it.
Every line of phase 17 (the simulator, the special keys and the
metacluster) carries the tag ``simulation``, every line of phase 18
(the fdbserver processes over RPC) the tag ``rpc``, every line of
phase 19 (the operator tools) the tag ``tools``, and every line of
phase 20 (flowlint and the fault-coverage probe) the tag ``faultcov``.

Writes each run's stamped output to DIR/phases_<i>.log (by default
foundationdb_tpu_torch/build/phases, which git ignores), prints one
line per run and, last, one JSON object with each run's tree, exit
code, seconds and seconds by tag. Exits 1 if any run failed.
"""

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TAG = re.compile(r"^\[([A-Za-z_-]+)")


def run(tree, out_path):
    """One tree's chip_smoke.py: its exit code, seconds and seconds by
    tag; the stamped lines go to ``out_path``."""
    by_tag, tag = {}, "start"
    t0 = time.perf_counter()
    last = t0
    with open(out_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-u", "chip_smoke.py"], cwd=tree,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            now = time.perf_counter()
            m = TAG.match(line)
            if m:
                tag = m.group(1)
            by_tag[tag] = by_tag.get(tag, 0.0) + (now - last)
            last = now
            out.write(f"{now - t0:10.3f} {line}")
        rc = proc.wait()
    return rc, time.perf_counter() - t0, by_tag


def main():
    args = sys.argv[1:]
    out_dir = os.path.join(HERE, "foundationdb_tpu_torch", "build", "phases")
    if args[:1] == ["--out"] and len(args) > 1:
        out_dir, args = os.path.abspath(args[1]), args[2:]
    trees = args
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for i, tree in enumerate(trees):
        path = os.path.join(out_dir, f"phases_{i}.log")
        rc, seconds, by_tag = run(os.path.abspath(tree), path)
        runs.append(dict(tree=tree, rc=rc, seconds=seconds,
                         seconds_by_tag=by_tag))
        top = sorted(by_tag.items(), key=lambda kv: -kv[1])[:6]
        print(f"[run {i}] {tree}: rc {rc}, {seconds:.3f} s; "
              + ", ".join(f"{k} {v:.1f}" for k, v in top), flush=True)
    print(json.dumps({"runs": runs}))
    return 1 if any(r["rc"] for r in runs) else 0


if __name__ == "__main__":
    sys.exit(main())
