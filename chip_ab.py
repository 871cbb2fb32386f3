"""Two trees of this repo on one card, side by side: kernel times by one
method, and each tree's own chip_smoke.py end to end.

    python3 chip_ab.py OLD_TREE NEW_TREE

A tree is a checkout of a commit, for example ``git archive`` of the
parent commit unpacked into a gitignored directory. The runs alternate
old, new, new, old, each in processes of its own (the two trees' packages
have one name). A run is:

  1. a kernel probe: this directory's ``chip_smoke.kernel_cases`` on the
     tree's package; per case the kernel's ``ms`` and the plain version's
     ``plain_ms`` by ``chip_smoke.cuda_ms`` (CUDA events around
     back-to-back calls, host cost included), and the kernel's device
     ms per call by torch.profiler, by kernel (``parts_ms``, named by
     this directory's ``chip_smoke.PARTS``) and in all (``device_ms``),
     and the plain version's (``plain_device_ms``); the same methods for
     both trees;
  2. the tree's own ``chip_smoke.py``, from its ``[summary]`` line the
     resolve and resolve_many txns/s of each stream, and its exit code.

Prints one line per run and, last, one JSON object with every number.
Needs a card; fails if a probe or a chip_smoke run fails.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe(tree):
    """Kernel times of ``tree``'s package on this directory's cases."""
    sys.path.insert(0, tree)
    import foundationdb_tpu_torch

    assert foundationdb_tpu_torch.__file__.startswith(tree), (
        foundationdb_tpu_torch.__file__)
    cs = load_chip_smoke()
    cs.log = lambda *a: None
    _, cases = cs.kernel_cases()
    out = []
    for c in cases:
        parts = cs.kernel_parts(c["fn"], 20, cs.PARTS[c["kernel"]])
        out.append(dict(
            kernel=c["kernel"], case=c["case"],
            ms=cs.cuda_ms(c["fn"], 20),
            plain_ms=cs.cuda_ms(c["plain"], c["plain_reps"]),
            parts_ms=parts, device_ms=sum(parts.values()),
            plain_device_ms=cs.kernel_parts(c["plain"], c["plain_reps"],
                                            ())["other"]))
    print(json.dumps(out))


def run(tree):
    """One run of ``tree``: its kernel probe, then its chip_smoke.py."""
    tree = os.path.abspath(tree)
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--probe",
                        tree], capture_output=True, text=True, cwd=tree)
    if p.returncode:
        sys.stderr.write(p.stderr[-4000:])
        raise SystemExit(f"kernel probe of {tree} failed")
    kernels = json.loads(p.stdout.strip().splitlines()[-1])
    s = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, cwd=tree)
    if s.returncode:
        sys.stderr.write(s.stderr[-4000:])
        raise SystemExit(f"chip_smoke.py of {tree} exited {s.returncode}")
    summary = next(json.loads(line[len("[summary] "):])
                   for line in s.stdout.splitlines()
                   if line.startswith("[summary] "))
    rates = {name: [v["resolve_txns_per_s"], v["resolve_many_txns_per_s"]]
             for name, v in summary["main"].items()
             if "resolve_txns_per_s" in v}  # not the "graphs" counts
    rates["mixed, ring route"] = [
        summary["ring_route"]["mixed"]["resolve_txns_per_s"],
        summary["ring_route"]["mixed"]["resolve_many_txns_per_s"]]
    return dict(tree=tree, kernels=kernels, rates=rates,
                smoke_seconds=summary["seconds"])


def main():
    if sys.argv[1:2] == ["--probe"]:
        return probe(sys.argv[2])
    old, new = sys.argv[1:3]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for label, tree in (("old", old), ("new", new), ("new", new), ("old", old)):
        r = dict(label=label, **run(tree))
        runs.append(r)
        for k in r["kernels"]:
            print(f"[{label}] {k['kernel']} {k['case']}: ms {k['ms']:.4f} "
                  f"device {k['device_ms']:.4f} (" + ", ".join(
                      f"{n} {v:.4f}" for n, v in k["parts_ms"].items())
                  + f") plain {k['plain_ms']:.4f} / "
                  f"{k['plain_device_ms']:.4f}", flush=True)
        print(f"[{label}] txns/s (resolve, resolve_many) " + json.dumps(
            r["rates"]), flush=True)
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    sys.exit(main())
