"""What the metric files (metrics/<name>.py) share: each reads one number
from a finished run, or None where the run has nothing for it to read
(another entry point, no trace), and the harness then leaves the metric
out of the line.

A run (harness.Run) carries the entry point its calls timed, the calls
of the measured window (start, end, bytes in, bytes out on the host clock),
the window's length, the port's stage telemetry and counters over the
window, and, in a traced run, the split of the traced slice.
"""

from __future__ import annotations

import numpy as np

from . import peaks

MiB = 1 << 20
# the entry points that the readers and the metric files key on (Run.entry)
ENTRIES = ("deflate", "inflate", "crc32")


def _calls(run, entry: str):
    return run.calls if run.entry == entry and run.calls else None


def rate(run, entry: str, side: str, unit: float) -> float | None:
    """All bytes of one side ("in" or "out") of the window's completed
    calls, in `unit` bytes, over the window: from its start to the last
    call's end."""
    calls = _calls(run, entry)
    if calls is None or run.window_s <= 0:
        return None
    return sum(c.nin if side == "in" else c.nout for c in calls) / unit / run.window_s


def latency_ms(run, entry: str, q: float) -> float | None:
    """The q-th percentile of the call times in the window, ms."""
    calls = _calls(run, entry)
    if calls is None:
        return None
    return float(np.percentile([(c.t1 - c.t0) * 1e3 for c in calls], q))


def stage_ms_per_MiB(run, entry: str, stage: str, side: str) -> float | None:
    """The host ms of the port's telemetry stage `stage` (summed over the
    window's calls) per MiB of the calls' input ("in") or output ("out")."""
    calls = _calls(run, entry)
    if calls is None or stage not in run.stages:
        return None
    nbytes = sum(c.nin if side == "in" else c.nout for c in calls)
    return run.stages[stage]["seconds"] * 1e3 / (nbytes / MiB)


def counter_pct(run, entry: str, counter: str, side: str) -> float | None:
    """A byte counter of the port, moved over the window, as a share of the
    calls' bytes of one side."""
    calls = _calls(run, entry)
    if calls is None:
        return None
    nbytes = sum(c.nin if side == "in" else c.nout for c in calls)
    return 100.0 * run.counters.get(counter, 0) / nbytes


def roofline_pct(run, entry: str) -> float | None:
    """The least time the card needs for the traced slice's calls (their
    bytes in and out, each read or written once at the card's peak) over
    the time an operation ran on the card in the slice."""
    t = run.trace
    if run.entry != entry or t is None or not t["calls"] or t["busy_s"] <= 0:
        return None
    peak = peaks.hbm_bytes_per_s(run.device_kind)
    if peak is None:
        return None
    nbytes = sum(c.nin + c.nout for c in t["calls"])
    return 100.0 * nbytes / peak / t["busy_s"]


def idle_pct(run, entry: str) -> float | None:
    """The share of the traced slice in which no operation ran on the card."""
    t = run.trace
    if run.entry != entry or t is None or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1 - t["busy_s"] / t["window_s"])
