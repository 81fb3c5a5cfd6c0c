"""Stage telemetry, event counters and a torch.profiler capture.

Counterpart of tpuzlib/utils/trace.py, with the same names, signatures
and return shapes:

- stage telemetry: per-stage (calls, bytes, seconds), off unless
  enable() is called or TPUZLIB_TRACE is set at import.  While it is on,
  timed_stage also opens a torch.profiler.record_function span of the
  stage's name, so a trace shows each stage on the host's timeline; while
  it is off, timed_stage costs a bool test.
- event counters: always on.  Every device-route entry and every host
  fallback counts, so a silent slide into fallbacks shows
  (``get_counters()['inflate.device_fallback']``).  A counter that a
  device program computes (count_on_device) stays in an int64 tensor on
  that device and is read, and folded in, by get_counters() only: the
  program adds it without reading anything back.
- profile(): a torch.profiler capture of the host and the card, written
  as a Chrome trace into `logdir`; it turns the telemetry on while it
  runs.

TPUZLIB_TRACE selects no route and changes no byte.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch

_enabled = bool(os.environ.get("TPUZLIB_TRACE"))
_lock = threading.Lock()
_stats: dict = defaultdict(lambda: [0, 0, 0.0])  # name -> [calls, bytes, secs]
_OFF = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def telemetry_enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _stats.clear()


def get_telemetry() -> dict:
    """{stage: {calls, bytes, seconds, MBps}}"""
    with _lock:
        out = {}
        for name, (calls, nbytes, secs) in _stats.items():
            out[name] = {
                "calls": calls,
                "bytes": nbytes,
                "seconds": round(secs, 6),
                "MBps": round(nbytes / secs / 1e6, 2) if secs > 0 else None,
            }
        return out


class _Stage:
    """One timed stage: a record_function span around a host-clock timing."""

    __slots__ = ("name", "nbytes", "span", "t0")

    def __init__(self, name: str, nbytes: int):
        self.name, self.nbytes = name, nbytes
        self.span = torch.profiler.record_function(name)

    def __enter__(self):
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.span.__exit__(*exc)
        with _lock:
            s = _stats[self.name]
            s[0] += 1
            s[1] += self.nbytes
            s[2] += dt


def timed_stage(name: str, nbytes: int = 0):
    """Record one stage execution (a no-op unless telemetry is enabled);
    use as `with timed_stage(name, nbytes):`."""
    return _Stage(name, nbytes) if _enabled else _OFF


_counters: dict = defaultdict(int)
# (name, device) -> int64 0-d tensor on that device (count_on_device)
_device_counters: dict = {}


def count(name: str, n: int = 1) -> None:
    """Increment a named event counter (always on: counters are cheap)."""
    with _lock:
        _counters[name] += n


def count_on_device(name: str, n: torch.Tensor) -> None:
    """Add the integer tensor `n` (one value) into counter `name`'s int64
    accumulator on n's device, without reading it back; get_counters()
    reads the accumulator and folds it into `name`."""
    key = (name, n.device)
    with _lock:
        acc = _device_counters.get(key)
        if acc is None:
            acc = _device_counters[key] = torch.zeros((), dtype=torch.int64, device=n.device)
    acc.add_(n.reshape(()))


def get_counters() -> dict:
    with _lock:
        out = dict(_counters)
        for (name, _), acc in _device_counters.items():
            out[name] = out.get(name, 0) + int(acc)
        return out


def reset_counters() -> None:
    with _lock:
        _counters.clear()
        _device_counters.clear()


@contextlib.contextmanager
def profile(logdir: str = "/tmp/tpuzlib_torch_profile", device="cuda"):
    """Capture a torch.profiler trace of a codec region into `logdir` (a
    Chrome trace, `*.pt.trace.json`), the host's activity and, for a
    CUDA device, the card's; the stage telemetry is on meanwhile.
    Yields logdir.  Raises where a CUDA device was asked for and the
    profiler cannot trace one."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if (not torch.cuda.is_available()
                or torch.profiler.ProfilerActivity.CUDA not in torch.profiler.supported_activities()):
            raise RuntimeError("profile(device=%r): the profiler cannot trace a CUDA device here"
                               % (device,))
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    was = _enabled
    enable(True)
    try:
        with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
        ):
            yield logdir
    finally:
        enable(was)
