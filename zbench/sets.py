"""Runs of one cell in a row, each a process of its own as the check runs
them, and the spread of each metric over them.

    python3 zbench/sets.py --workload <cell> --seconds <s> --seeds 11 12 13 [--trace 1]
        [--out chiprun_out/<file>.jsonl]

Each run's seed, exit code, wall seconds, result line and the end of its
standard error go to --out, one JSON object a line; the summary gives, for
each metric, its values, median and spread: the distance between the
first and third quartiles (statistics.quantiles(values, n=4)) as a share
of the median, which is what a bound is set from.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

RUN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "run.py")


def spread(values: list) -> float | None:
    """(Q3 - Q1) / median, or None below two values."""
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    """One run as its own process, given the contract's 1,200 s for a run
    that builds."""
    cmd = [sys.executable, RUN, "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
        rc, out, err = res.returncode, res.stdout, res.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
    lines = out.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else None
    except ValueError:
        line = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc": rc,
            "wall_s": time.perf_counter() - t0, "line": line, "stderr": err[-3000:]}


def summary(records: list) -> dict:
    values: dict = {}
    for r in records:
        for name, m in ((r["line"] or {}).get("metrics") or {}).items():
            values.setdefault(name, []).append(m["value"])
    return {name: {"median": statistics.median(v), "spread": spread(v), "n": len(v), "values": v}
            for name, v in values.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    records = []
    for seed in args.seeds:
        r = one_run(args.workload, seed, args.seconds, args.trace)
        records.append(r)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
        line = r["line"] or {}
        print("%s seed %d rc %d %.1f s correct %s %s" % (
            args.workload, seed, r["rc"], r["wall_s"], line.get("correct"),
            {k: v["value"] for k, v in (line.get("metrics") or {}).items()}), flush=True)
        if r["rc"] or not line.get("correct"):
            print(r["stderr"][-1500:], flush=True)
    print(json.dumps({"workload": args.workload, "seconds": args.seconds, "trace": args.trace,
                      "summary": summary(records)}), flush=True)
    return 0 if all(r["rc"] == 0 and (r["line"] or {}).get("correct") for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
