"""Runs of one cell with a stand-in in the port's place, to show that
`correct` refuses it: the control (the plain reference with one of the
configuration's guarantees broken) or a fault planted in the port's call
(reference/control.py).  Several seeds in one process; the benchmark's
own runs never run this.

    python3 zbench/control.py --workload <cell> --seconds <s> --seeds 1 2 3 \
        --stand-in control|alter|half

Prints, a line a seed, `correct` and every number compared with its
limit.  Exits 0 where every run came out not correct.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zbench import harness  # noqa: E402
from zbench.reference import control  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--stand-in", choices=("control", *control.FAULTS), required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(harness.ROOT, args.workload)
    device = harness.require_cuda(cell.chips)
    program = harness.stand_in(cell, args.stand_in)
    verdicts = []
    for seed in args.seeds:
        line = harness.run_cell(cell, seed, args.seconds, False, device, time.perf_counter(), program)
        verdicts.append(line["correct"])
        print(json.dumps({"workload": args.workload, "stand_in": args.stand_in, "seed": seed,
                          "correct": line["correct"], "attempted": line["attempted"],
                          "failed": line["failed"], "compared": line["compared"]}), flush=True)
    return 0 if not any(verdicts) else 1


if __name__ == "__main__":
    sys.exit(main())
