"""Where a kernel call's host time goes, on one CUDA card: the earlier
launch path (re-created here as it was before its entry points were
resolved once: a lock, a getattr, a device guard and a Stream object a
call), this checkout's, and torch.gather beside them.

    python3 probes/launch_breakdown.py [--calls N] [--rounds R]

Every piece is timed on the host clock as R rounds of N calls (after a
warm-up round), and printed as the median and range of the rounds' mean
µs a call, on take_along's (1, 1) input (the launch floor):

  loop            an empty call: the timing loop's own cost, in every row
  checks_old      the earlier on_cpu, then the earlier check_arrays (a
                  torch.device object a tensor) and take_along's shape
                  checks
  checks          this checkout's one-pass test of a card call, as
                  take_along makes it before its launch
  checks_full     the full checks (gather_probe._check_take) that CPU
                  inputs, and refused ones, go through
  alloc_empty_like
                  torch.empty_like(idx): the output, as take_along makes it
  alloc_empty, alloc_empty_ints, alloc_empty_dev, alloc_new_empty
                  the same output by torch.empty((1, 1), dtype=int32,
                  device=x.device), torch.empty(1, 1, ...), torch.empty
                  with a torch.device made beforehand, idx.new_empty
  lock_getattr    the earlier lib(): its lock taken on every call, and
                  getattr(handle, entry)
  guard_old       `with torch.cuda.device(device)` on the current device
  guard           the index compare that replaces it (_current_device())
  stream_old      torch.cuda.current_stream(device).cuda_stream
  stream          torch._C._cuda_getCurrentRawStream(index)
  ctypes_noargs   a C entry point of no arguments (tz_gather_staged_words)
  ctypes_refused  the C entry point with take_along's 10 arguments and a
                  stream, refused before its launch (ir = 0): the ctypes
                  call and the C checks
  ctypes_refused_pydll
                  the same through ctypes.PyDLL (the GIL kept)
  ctypes_launch, ctypes_launch_pydll
                  the entry point launching the kernel: the launch's own
                  cost is this less ctypes_refused
  take_empty      torch.empty_like(idx) then the refused ctypes call: no
                  launch
  path_old        the earlier whole take_along call
  path            this checkout's take_along call
  torch_gather    torch.gather(x, 1, idx64), idx64 int64 beforehand

The last three are timed in turns, a round of each in every step, and
each also gives its median ratio to torch_gather, round by round
(`over_last`); the summary line gives those two ratios.  `breakdown()`
returns the rows; chip_smoke.py prints them as its "I launch probe" line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpuzlib_torch.kernels import _build, gather_probe as gp  # noqa: E402

INT32_MIN = -(1 << 31)


# ---- the earlier launch path, as it was ------------------------------------

_LOCK = threading.Lock()


def _lib_old():
    with _LOCK:  # the earlier Library.__call__ took its lock on every call
        return _build.lib()


def _launch_old(kernel, entry, device, *args):
    handle = _lib_old()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(handle, entry)(*args, stream)
    if err != 0:
        raise RuntimeError("%s launch failed: %s" % (kernel, handle.tz_error_string(err).decode()))
    for name in (kernel,) if isinstance(kernel, str) else kernel:
        _build.LAUNCHES[name] += 1


def _on_cpu_old(t):
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError("no kernel for tensors on %s" % t.device)
    return False


def _check_arrays_old(name, *tensors, dims=(2,)):
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError("%s: expected int32 tensors, got %s" % (name, t.dtype))
        if t.dim() not in dims or not t.is_contiguous():
            raise ValueError("%s: expected contiguous tensors" % name)
        if t.device != tensors[0].device:
            raise ValueError("%s: tensors must share one device" % name)


def _check_take_old(x, idx, axis):
    _check_arrays_old("take_along", x, idx)
    if axis not in (0, 1):
        raise ValueError("take_along: axis must be 0 or 1, got %r" % (axis,))
    if x.shape[1 - axis] != idx.shape[1 - axis] or x.shape[axis] == 0:
        raise ValueError("take_along: shapes")


def take_along_old(x, idx, axis, fill=INT32_MIN):
    """The earlier take_along wrapper on a CUDA tensor."""
    if _on_cpu_old(x):
        raise ValueError("a CUDA tensor is needed")
    _check_take_old(x, idx, axis)
    out = torch.empty_like(idx)
    if idx.numel():
        _launch_old("take_along", "tz_take_along", x.device, x.data_ptr(), x.shape[0],
                     x.shape[1], idx.data_ptr(), idx.shape[0], idx.shape[1], axis, fill,
                     out.data_ptr())
    return out


# ---- timing ---------------------------------------------------------------------

def round_us(fn, calls: int) -> float:
    """Mean host µs of fn() over `calls` calls, the card drained before."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def stats(per: list) -> dict:
    return {"us": statistics.median(per), "us_min": min(per), "us_max": max(per)}


def host_us(fn, calls: int, rounds: int) -> dict:
    """Median, min and max over `rounds` of round_us(fn, calls), after one
    warm-up round."""
    round_us(fn, calls)
    per = [round_us(fn, calls) for _ in range(rounds)]
    torch.cuda.synchronize()
    return stats(per)


def in_turns(fns: dict, calls: int, rounds: int) -> dict:
    """host_us of each of `fns`, their rounds taken in turns (one round
    of each, then the next), so that a drift of the host's speed reaches
    all of them; each row also gives its median ratio, round by round,
    to the last of `fns`."""
    for fn in fns.values():
        round_us(fn, calls)
    per = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            per[name].append(round_us(fn, calls))
    torch.cuda.synchronize()
    last = per[list(fns)[-1]]
    return {name: {**stats(p), "over_last": statistics.median(a / b for a, b in zip(p, last))}
            for name, p in per.items()}


def breakdown(calls: int = 2000, rounds: int = 15) -> dict:
    """The rows named in the module docstring: piece -> {us, us_min, us_max}."""
    dev = torch.device("cuda", torch.cuda.current_device())
    index = dev.index
    x = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    idx = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    idx64 = idx.long()
    out = torch.empty_like(idx)
    handle = _build.lib()
    fn = _build.lib.fns["tz_take_along"]
    pydll = ctypes.PyDLL(handle._name)
    pfn = pydll.tz_take_along
    pfn.restype, pfn.argtypes = fn.restype, fn.argtypes
    stream = _build._raw_stream(index)
    xp, ip_, op = x.data_ptr(), idx.data_ptr(), out.data_ptr()
    launch_args = (xp, 1, 1, ip_, 1, 1, 1, INT32_MIN, op, stream)
    refused_args = (xp, 1, 1, ip_, 0, 1, 1, INT32_MIN, op, stream)
    assert fn(*refused_args) != 0 and fn(*launch_args) == 0
    torch.cuda.synchronize()

    def checks_old():
        _on_cpu_old(x)
        _check_take_old(x, idx, 1)

    i32 = torch.int32

    def checks():
        device = x.get_device()
        if (x.is_cuda and idx.get_device() == device and x.dtype is i32 and idx.dtype is i32
                and x.dim() == 2 and idx.dim() == 2 and x.is_contiguous()
                and idx.is_contiguous()):
            xr, xc = x.shape
            ir, ic = idx.shape
            return xr == ir and xc

    def guard_old():
        with torch.cuda.device(dev):
            pass

    pieces = {
        "loop": lambda: None,
        "checks_old": checks_old,
        "checks": checks,
        "checks_full": lambda: gp._check_take(x, idx, 1),
        "alloc_empty_like": lambda: torch.empty_like(idx),
        "alloc_empty": lambda: torch.empty((1, 1), dtype=torch.int32, device=x.device),
        "alloc_empty_ints": lambda: torch.empty(1, 1, dtype=torch.int32, device=x.device),
        "alloc_empty_dev": lambda: torch.empty((1, 1), dtype=torch.int32, device=dev),
        "alloc_new_empty": lambda: idx.new_empty((1, 1)),
        "lock_getattr": lambda: getattr(_lib_old(), "tz_take_along"),
        "guard_old": guard_old,
        "guard": lambda: index == _build._current_device(),
        "stream_old": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "stream": lambda: _build._raw_stream(index),
        "ctypes_noargs": _build.lib.fns["tz_gather_staged_words"],
        "ctypes_refused": lambda: fn(*refused_args),
        "ctypes_refused_pydll": lambda: pfn(*refused_args),
        "ctypes_launch": lambda: fn(*launch_args),
        "ctypes_launch_pydll": lambda: pfn(*launch_args),
        "path_old": lambda: take_along_old(x, idx, 1),
        "path": lambda: gp.take_along(x, idx, 1),
        "torch_gather": lambda: torch.gather(x, 1, idx64),
        "take_empty": lambda: (torch.empty_like(idx), fn(*refused_args)),
    }
    paths = ("path_old", "path", "torch_gather")
    rows = {name: host_us(f, calls, rounds) for name, f in pieces.items() if name not in paths}
    rows.update(in_turns({name: pieces[name] for name in paths}, calls, rounds))
    return rows


def summary(rows: dict) -> dict:
    return {"path_old_over_gather": rows["path_old"]["over_last"],
            "path_over_gather": rows["path"]["over_last"],
            "launch_us": rows["ctypes_launch"]["us"] - rows["ctypes_refused"]["us"],
            "pydll_saves_us": rows["ctypes_launch"]["us"] - rows["ctypes_launch_pydll"]["us"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("launch_breakdown: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rows = breakdown(args.calls, args.rounds)
    for name, row in rows.items():
        print(json.dumps({"probe": "launch", "piece": name, **row}), flush=True)
    print(json.dumps({"probe": "launch summary", "nvidia_smi": smi, **summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
