"""The control of a cell's output check: the reference put in the
program's place, with its version offsets cut from the 32 bits the
configuration states to 16, judged as a run's statuses are.

    python fdbbench/control.py --workload <cell> --seeds 1,2,3 --batches <n>

``--batches`` is how many batches a run of the cell dispatches (read it
from the runs' ``judged`` line). Prints, for each seed, the judge's
numbers for the control and for the exact reference beside them (which
must read 0 unsound commits and 0 false conflicts), one JSON line each.
The benchmark's own runs never run it: it sets the limits'
upper readings.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from fdbbench import reference, spec  # noqa: E402

CONTROL_VERSION_BITS = 16


def readings(cell, seed, n_batches, version_bits):
    keys, pool, versions = cell.traffic(seed)
    runs = list(range(n_batches))
    judge = reference.Judge(pool, versions, keys.record_count)
    for i, s in zip(runs, reference.decide(pool, versions, keys.record_count,
                                           runs, version_bits)):
        judge.batch(i, s)
    return judge.numbers()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", type=int, required=True)
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = {"workload": args.workload, "seed": seed,
               "batches": args.batches,
               "control": readings(cell, seed, args.batches,
                                   CONTROL_VERSION_BITS),
               "exact": readings(cell, seed, args.batches, None)}
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
