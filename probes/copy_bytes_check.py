"""The port's copy counters against the profiler's own copies, on one CUDA
card: for each cell of BENCHMARK.json, one warm call of the cell's
traffic (a window of calls for crc32) with the telemetry on, inside a
span of a torch.profiler capture after one call outside it, and the bytes of its Memcpy events beside the
copy.h2d_bytes and copy.d2h_bytes counters that the call moved.

    python3 probes/copy_bytes_check.py [--seed N] [--calls-crc32 N] [--calls N] [cell ...]

Prints a JSON line a cell: the card's name and power limit, each
direction's bytes from the trace (HtoD and DtoH Memcpy events; DtoD ones
apart: no counter counts them) and from the counters, their ratio, and
`within_1pct`; beside them the trace's copies by size and its kernel
events, to tell a copy the counters miss from an event the trace lost.  The program only counts; this probe alone reads a trace.
"""

from __future__ import annotations

import argparse
import collections
import glob
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


WINDOW = "probe.window"


def memcpy_bytes(logdir: str) -> dict:
    """Bytes of the Memcpy events by direction (HtoD, DtoH, DtoD) launched
    inside the record_function span WINDOW: a card event counts where the
    host call that launched it (the cuda_runtime event of the same
    correlation id) lies inside the span, so a copy of a call outside it
    (the warm-up's) does not count, and a card timestamp that the trace
    puts a little before or after the span does not drop a copy.
    `skewed` counts the copies and kernels whose own timestamps lie outside
    the span.  A card event without a correlation id counts by its own
    timestamp."""
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (win,) = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    w0, w1 = win["ts"], win["ts"] + win["dur"]

    def inside(e):
        return "ts" in e and w0 <= e["ts"] and e["ts"] + e.get("dur", 0) <= w1

    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and inside(e)
                and "correlation" in e.get("args", {})}
    out, count, sizes = collections.Counter(), collections.Counter(), collections.Counter()
    kernels = skewed = 0
    for e in events:
        if e.get("cat") not in ("gpu_memcpy", "kernel"):
            continue
        corr = e.get("args", {}).get("correlation")
        if not (corr in launched if corr is not None else inside(e)):
            continue
        skewed += not inside(e)
        if e["cat"] == "kernel":
            kernels += 1
            continue
        kind = e["name"].split()[1]  # "Memcpy HtoD (Pageable -> Device)"
        out[kind] += int(e["args"]["bytes"])
        count[kind] += 1
        sizes["%s %d" % (kind, int(e["args"]["bytes"]))] += 1
    return {"bytes": dict(out), "events": dict(count), "sizes": dict(sizes), "kernels": kernels,
            "skewed": skewed}


def one_cell(name: str, seed: int, crc_calls: int, other_calls: int) -> dict:
    import torch

    import tpuzlib_torch
    from tpuzlib_torch import testing
    from tpuzlib_torch.utils import trace
    from zbench import harness

    cell = harness.load_cell(ROOT, name)
    entry = importlib.import_module("zbench.entries." + cell.entry)
    fn = entry.program(tpuzlib_torch, cell.config, "cuda")
    driver = entry.Driver(cell.config, cell.traffic, seed, "cuda")
    driver.warm(fn)
    calls = crc_calls if cell.entry == "crc32" else other_calls
    trace.enable()
    torch.cuda.synchronize()
    logdir = tempfile.mkdtemp(prefix="copy_bytes_")
    try:
        # one call before the window: the profiler's first moments can
        # miss the card's first copies
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
            driver.call(fn)
            torch.cuda.synchronize()
            before = trace.get_counters()
            with torch.profiler.record_function(WINDOW):
                for _ in range(calls):
                    driver.call(fn)
                torch.cuda.synchronize()
            moved = testing.counters_since(before)
        seen = memcpy_bytes(logdir)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
        trace.enable(False)
    row = {"cell": name, "seed": seed, "calls": calls, "trace_events": seen["events"],
           "trace_kernels": seen["kernels"], "trace_skewed": seen["skewed"],
           "trace_sizes": seen["sizes"],
           "trace_dtod_bytes": seen["bytes"].get("DtoD", 0),
           "declined": moved.get("inflate.device_fallback", 0)
           + moved.get("inflate.device_mismatch_fallback", 0)}
    ok = True
    for kind, counter in (("HtoD", "copy.h2d_bytes"), ("DtoH", "copy.d2h_bytes")):
        want, got = seen["bytes"].get(kind, 0), moved.get(counter, 0)
        ratio = got / want if want else None
        row[kind] = {"trace_bytes": want, "counter_bytes": got, "ratio": ratio}
        ok &= want == got or (ratio is not None and abs(ratio - 1) <= 0.01)
    row["within_1pct"] = ok
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=3000000001)
    ap.add_argument("--calls-crc32", type=int, default=100)
    ap.add_argument("--calls", type=int, default=1, help="calls of the other cells")
    ap.add_argument("cells", nargs="*")
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = args.cells or [w["name"] for w in json.load(f)["workloads"]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    bad = 0
    for name in cells:
        row = one_cell(name, args.seed, args.calls_crc32, args.calls)
        row["card"] = smi
        print(json.dumps(row), flush=True)
        bad += not row["within_1pct"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
