"""Stage telemetry, event counters and a torch.profiler capture.

Counterpart of tpuzlib/utils/trace.py, with the same names, signatures
and return shapes:

- stage telemetry: per-stage (calls, bytes, seconds, self seconds), off
  unless enable() is called or TPUZLIB_TRACE is set at import.  While it
  is on and a torch.profiler capture records, timed_stage also opens a
  torch.profiler.record_function span of the stage's name, so a trace
  shows each stage on the host's timeline (a span costs more host time
  than the rest of a stage, so none is opened with no capture to record
  it, nor for a stage timed with span=False); while it is off,
  timed_stage costs a bool test.  Stages nest: each
  thread keeps its own stack of open stages, and a stage's self seconds
  are its seconds less those of the stages opened inside it on its
  thread.  pending_stage is a stage with no span whose record its caller
  keeps or drops at its end (an attempt that turns out to be a fallback).
- event counters: always on.  Every device-route entry and every host
  fallback counts, so a silent slide into fallbacks shows
  (``get_counters()['inflate.device_fallback']``).  A counter that a
  device program computes (count_on_device) stays in an int64 tensor on
  that device and is read, and folded in, by get_counters() only: the
  program adds it without reading anything back.  A kernel's device
  time (count_device_ns) is a pair of CUDA events kept until
  get_counters() reads their elapsed time into its counter, in ns, so
  the call that recorded them never waits for the card.  The copy
  counters (count_copy: copy.h2d_bytes, copy.d2h_bytes) count only while
  the telemetry is on.
- profile(): a torch.profiler capture of the host and the card, written
  as a Chrome trace into `logdir`; it turns the telemetry on while it
  runs.

TPUZLIB_TRACE selects no route and changes no byte.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

_enabled = bool(os.environ.get("TPUZLIB_TRACE"))
_lock = threading.Lock()
# name -> [calls, bytes, secs, self secs]
_stats: dict = defaultdict(lambda: [0, 0, 0.0, 0.0])
_OFF = contextlib.nullcontext()


class _Local(threading.local):
    def __init__(self):
        self.stack = []  # this thread's open stages, innermost last


_local = _Local()


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def telemetry_enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _stats.clear()


def get_telemetry() -> dict:
    """{stage: {calls, bytes, seconds, self_seconds, MBps}}: seconds are
    inclusive, self_seconds leave out the stages opened inside."""
    with _lock:
        out = {}
        for name, (calls, nbytes, secs, own) in _stats.items():
            out[name] = {
                "calls": calls,
                "bytes": nbytes,
                "seconds": round(secs, 6),
                "self_seconds": round(own, 6),
                "MBps": round(nbytes / secs / 1e6, 2) if secs > 0 else None,
            }
        return out


def size_of(x) -> int:
    """The bytes of `x`: a tensor's or an ndarray's data, an int as it is,
    the sum over a tuple or list of them."""
    if isinstance(x, torch.Tensor):
        return x.nelement() * x.element_size()
    if isinstance(x, np.ndarray):
        return x.nbytes
    if isinstance(x, int):
        return x
    n = 0
    for t in x:
        n += size_of(t)
    return n


def _capturing() -> bool:
    """Whether a torch.profiler capture is recording (true where this
    torch does not tell)."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", True)


_clock = time.perf_counter


class _Stage:
    """One timed stage on this thread's stack of open stages: a host-clock
    timing, inside a record_function span where it has one and a capture
    records.  `keep` decides at its end whether it is recorded."""

    __slots__ = ("name", "nbytes", "span", "t0", "inner", "keep")

    def __init__(self, name: str, nbytes: int, span: bool = True, keep: bool = True):
        self.name, self.nbytes, self.inner, self.keep = name, nbytes, 0.0, keep
        self.span = torch.profiler.record_function(name) if span and _capturing() else None

    def __enter__(self):
        if self.span is not None:
            self.span.__enter__()
        _local.stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = _clock() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].inner += dt
        if self.span is not None:
            self.span.__exit__(exc_type, exc, tb)
        if self.keep:
            with _lock:
                s = _stats[self.name]
                s[0] += 1
                s[1] += self.nbytes
                s[2] += dt
                s[3] += dt - self.inner


def timed_stage(name: str, nbytes=0, span: bool = True):
    """Record one stage execution (a no-op unless telemetry is enabled);
    use as `with timed_stage(name, nbytes):`.  nbytes: an int, or what
    size_of sizes (tensors, arrays, a tuple of them), sized only while
    the telemetry is on.  span=False opens no record_function (a stage
    inside a call too short to carry a second span's cost)."""
    if not _enabled:
        return _OFF
    return _Stage(name, nbytes if type(nbytes) is int else size_of(nbytes), span)


def pending_stage(name: str, nbytes=0):
    """A stage with no record_function span, recorded only where its
    caller sets `.keep = True` before it ends: for a stage whose outcome is
    known only at its end.  Its seconds count as a child's in the stage
    around it either way.  Use as `with pending_stage(name, n) as st:`;
    `st` is None while the telemetry is off."""
    return _Stage(name, size_of(nbytes), span=False, keep=False) if _enabled else _OFF


_counters: dict = defaultdict(int)
_COPY_COUNTERS = {"h2d": "copy.h2d_bytes", "d2h": "copy.d2h_bytes"}
_CPU = torch.device("cpu")
# (name, device) -> int64 0-d tensor on that device (count_on_device)
_device_counters: dict = {}
# (name, start event, end event) not yet read (count_device_ns)
_device_times: list = []


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


def count_device_ns(name: str, start, end) -> None:
    """Add the device time between the recorded CUDA events `start` and
    `end` (enable_timing=True) to counter `name`, in ns, when
    get_counters() next runs: it waits for `end` then, not here."""
    with _lock:
        _device_times.append((name, start, end))


def count_copy(direction: str, device, *xs) -> None:
    """While the telemetry is on, add the bytes of `xs` (what size_of
    sizes) to counter copy.<direction>_bytes ("h2d": host to card, "d2h":
    card to host), unless `device`, the card side of the copy, is the
    CPU."""
    if not _enabled:
        return
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device != _CPU:
        n = 0
        for x in xs:
            n += size_of(x)
        with _lock:
            _counters[_COPY_COUNTERS[direction]] += n


def get_counters() -> dict:
    with _lock:
        for name, start, end in _device_times:
            end.synchronize()
            _counters[name] += int(round(start.elapsed_time(end) * 1e6))
        _device_times.clear()
        out = dict(_counters)
        for (name, _), acc in _device_counters.items():
            out[name] = out.get(name, 0) + int(acc)
        return out


def reset_counters() -> None:
    with _lock:
        _counters.clear()
        _device_counters.clear()
        _device_times.clear()


@contextlib.contextmanager
def profile(logdir: str | None = None, device="cuda"):
    """Capture a torch.profiler trace of a codec region into `logdir` (a
    Chrome trace, `*.pt.trace.json`; by default a new directory made by
    tempfile.mkdtemp), the host's activity and, for a CUDA device, the
    card's; the stage telemetry is on meanwhile.  Yields logdir.  Raises
    where a CUDA device was asked for and the profiler cannot trace one."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if (not torch.cuda.is_available()
                or torch.profiler.ProfilerActivity.CUDA not in torch.profiler.supported_activities()):
            raise RuntimeError("profile(device=%r): the profiler cannot trace a CUDA device here"
                               % (device,))
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="tpuzlib_torch_profile_")
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
