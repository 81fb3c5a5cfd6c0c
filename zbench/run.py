"""One run of one cell of BENCHMARK.json on this machine's CUDA card.

    python3 zbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is the
result, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), device,
with --trace 1 breakdown, and last the numbers that decided `correct`,
each beside its limit, which also end standard error.  Exits non-zero and
prints no result without a CUDA card, without the port, or where jax,
jaxlib, flax or tpuzlib were loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(harness.ROOT, args.workload)
    try:
        device = harness.require_cuda(cell.chips)
    except harness.NoCard as e:
        print("zbench: %s" % e, file=sys.stderr)
        return 2
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    leaked = harness.leaked_modules()
    if leaked:
        print("zbench: the process loaded %s; the benchmark measures the port alone"
              % ", ".join(leaked), file=sys.stderr)
        return 3
    for name, c in line["compared"].items():
        print("zbench: %s %s (limit %s)" % (name, c["value"], c["limit"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
