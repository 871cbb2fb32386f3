"""Run one cell of the benchmark once and print its result.

    python fdbbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for. The last line of standard output is the result as one JSON
object; the last lines of standard error are the output check's numbers,
each beside its limit. Exits with another code than 0, and prints no
result, without a CUDA device, with fewer cards than the cell asks for,
or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from fdbbench import harness, spec

    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    if torch.cuda.device_count() < cell.chips:
        sys.exit(f"{args.workload} needs {cell.chips} card(s), "
                 f"{torch.cuda.device_count()} present")
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda:0", t_start=T_START)
    # the last step before the result: whatever the run loaded, the
    # metric readers, kernel counts and judge included, is in sys.modules
    found = harness.forbidden_modules()
    if found:
        sys.exit(f"loaded during the run: {', '.join(found)}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
