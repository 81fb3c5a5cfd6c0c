"""What one telemetry stage costs on the host, three ways: with the
telemetry off, on without a live profiler, and on under torch.profiler
(the host and the card traced, every thread, as the benchmark's traced
slice runs it).

    python3 probes/span_cost.py [--spans N] [--rounds R]

Each row is R rounds of N empty `with trace.timed_stage(...)` blocks
(also nested one deep, as the encoder's phases sit in
deflate.encode_batch), less an empty loop of N, as the median and range
of the rounds' µs a stage; then a stage with span=False (as
crc32.launch), count_copy, pending_stage and a bare
torch.profiler.record_function the same way (the last outside a capture
in the modes "off" and "on", inside one in "on_profiled").  On a card, a
last row times a whole crc32() of a 64 KiB card-resident record (its
result read back) in the modes off, on, off_profiled and on_profiled,
each profiled mode in a capture of its own, N/10 calls a round: what the
benchmark's traced slice pays a call for the telemetry is on_profiled
less off_profiled.  Prints one JSON line a row, the first the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def timed(body, n: int, rounds: int) -> list:
    """µs a call of body(), less an empty loop's, for each round."""
    def loop(f):
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        return time.perf_counter() - t0

    empty = lambda: None  # noqa: E731
    loop(body), loop(empty)  # warm
    return [(loop(body) - loop(empty)) * 1e6 / n for _ in range(rounds)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spans", type=int, default=20000)
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from tpuzlib_torch.utils import trace

    cuda = torch.cuda.is_available()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip() if cuda else "no card"
    print(json.dumps({"card": smi, "torch": torch.__version__, "spans": args.spans,
                      "rounds": args.rounds}), flush=True)
    host = np.zeros(1 << 20, np.uint8)

    def stage():
        with trace.timed_stage("probe.stage", 7):
            pass

    def nested():
        with trace.timed_stage("probe.outer", 7):
            with trace.timed_stage("probe.inner", 7):
                pass

    def no_span():
        with trace.timed_stage("probe.no_span", 7, span=False):
            pass

    def bare():
        with torch.profiler.record_function("probe.bare"):
            pass

    def copy():
        trace.count_copy("h2d", "cuda", host)

    def pending():
        with trace.pending_stage("probe.pending", 7) as st:
            if st is not None:
                st.keep = True

    rows = (("stage", stage, 1), ("nested_pair", nested, 2), ("stage_no_span", no_span, 1),
            ("count_copy", copy, 1), ("pending_stage", pending, 1),
            ("bare_record_function", bare, 1))

    def report(mode):
        for name, body, per in rows:
            us = [u / per for u in timed(body, args.spans, args.rounds)]
            print(json.dumps({"mode": mode, "row": name, "us_per_stage_median": statistics.median(us),
                              "us_min": min(us), "us_max": max(us)}), flush=True)

    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)

    @contextlib.contextmanager
    def capture():
        """A torch.profiler capture as the benchmark's traced slice takes
        one (every thread), into a directory removed after it."""
        logdir = tempfile.mkdtemp(prefix="span_cost_")
        try:
            with torch.profiler.profile(
                    activities=activities,
                    on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
                    experimental_config=torch._C._profiler._ExperimentalConfig(
                        profile_all_threads=True)):
                yield
        finally:
            shutil.rmtree(logdir, ignore_errors=True)

    trace.enable(False)
    report("off")
    trace.enable(True)
    report("on")
    try:
        with capture():
            report("on_profiled")
    finally:
        trace.enable(False)
    if not cuda:
        return 0
    import tpuzlib_torch

    record = torch.randint(0, 256, (1 << 16,), dtype=torch.uint8, device="cuda")

    def crc():
        tpuzlib_torch.crc32(record)

    ncrc = max(1, args.spans // 10)

    def crc_row(mode):
        us = timed(crc, ncrc, args.rounds)
        print(json.dumps({"mode": mode, "row": "crc32_call_64KiB", "us_per_stage_median":
                          statistics.median(us), "us_min": min(us), "us_max": max(us)}), flush=True)

    for mode in ("off", "on", "off_profiled", "on_profiled"):
        trace.enable(mode.startswith("on"))
        try:
            with capture() if mode.endswith("profiled") else contextlib.nullcontext():
                crc_row(mode)
        finally:
            trace.enable(False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
