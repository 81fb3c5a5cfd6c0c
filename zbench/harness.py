"""One run of one cell: set-up, the measured window, the check, the metrics
and the result line.

One client, the main thread of this one process, calls the port on the
current CUDA stream, as a caller does.  A closed loop: the next call goes
out when the last one returns.  The window runs from the start to the end
of the last call, and a call begun before the deadline completes inside
it.

--trace 1 runs the same window with the port's stage telemetry on (its
per-layer metrics read the stages, counters and call times of that
window), then a short traced slice of the same traffic under
torch.profiler, from whose Chrome trace the card's busy time, idle share,
roofline shares and breakdown are read (trace_split.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

from . import readers
from .reference import control

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuzlib")
WINDOW_SPAN = "zbench.window"


class NoCard(RuntimeError):
    """The cell asks for more CUDA cards than this machine shows."""


def require_cuda(chips: int) -> str:
    """"cuda" where torch sees at least `chips` CUDA cards; raises NoCard."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark measures a CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoCard("the cell needs %d CUDA cards, torch sees %d" % (chips, torch.cuda.device_count()))
    return "cuda"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """The module in `path`, by its file (metric names hold dots)."""
    name = "zbench_" + os.path.splitext(os.path.basename(path))[0].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with what its names point to."""

    root: str
    name: str
    chips: int
    config: dict
    traffic: dict
    entry: str  # the traffic's "entry": its driver, entries/<entry>.py
    end_to_end: list
    per_layer: list


def load_cell(root: str, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json, its configuration file, its
    traffic file and the metrics it reports (end to end: those that list
    it or list no cells; per layer: those that list it, or list no cells
    and move an end-to-end metric it reports)."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    (w,) = [w for w in manifest["workloads"] if w["name"] == name] or [None]
    if w is None:
        raise KeyError("no workload %r in BENCHMARK.json" % name)
    (c,) = [c for c in manifest["configs"] if c["name"] == w["config"]]
    config = load_json(os.path.join(root, c["file"]))
    traffic = load_json(os.path.join(root, "zbench", "traffic", w["traffic"] + ".json"))
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if name in m["workloads"] or ("workloads" not in m and m["moves"] in names)]
    return Cell(root, name, w["chips"], config, traffic, traffic["entry"], e2e, layer)


class UnknownEntry(ValueError):
    """An entry driver times an entry point that no reader keys on."""


def load_driver(cell: Cell):
    """The entry driver entries/<entry>.py of the cell's checkout, as the
    module zbench.entries.<entry> (its relative imports resolve there)."""
    importlib.import_module("zbench.entries")
    name = "zbench.entries." + cell.entry
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(cell.root, "zbench", "entries", cell.entry + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def timed_entry(cell: Cell, driver) -> str:
    """The entry point whose calls the driver times, which the readers key
    on (Run.entry): the driver's TIMES, else its own name."""
    entry = getattr(driver, "TIMES", cell.entry)
    if entry not in readers.ENTRIES:
        raise UnknownEntry("entries/%s.py times %r, which no reader keys on (readers.ENTRIES: %s)"
                           % (cell.entry, entry, ", ".join(readers.ENTRIES)))
    return entry


def stand_in(cell: Cell, name: str):
    """The program factory for the stand-in `name`: "control" is the
    driver's own control(api, config, device) where it gives one, else
    reference/control.py's for the entry point it times; a fault of
    control.FAULTS wraps the driver's program."""
    driver = load_driver(cell)
    if name == "control":
        return getattr(driver, "control", None) or control.control(timed_entry(cell, driver))
    return control.FAULTS[name](driver.program)


@dataclasses.dataclass
class Call:
    t0: float
    t1: float
    nin: int
    nout: int


@dataclasses.dataclass
class Run:
    """What the metric files read (readers.py).  `entry` is the entry
    point the calls timed (harness.timed_entry)."""

    entry: str
    device_kind: str
    setup_s: float
    window_s: float
    calls: list
    stages: dict
    counters: dict
    sizes: dict
    trace: dict | None


def closed_loop(driver, fn, seconds: float, before=None):
    """The driver calls fn, one call after another, from the start until
    `seconds` later; a call begun before then completes.  `before()` runs
    just before the start.  Returns (start, calls, failed)."""
    if before is not None:
        before()
    calls, failed = [], 0
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            return start, calls, failed
        try:
            nin, nout = driver.call(fn)
        except Exception:
            if not failed:
                traceback.print_exc()
            failed += 1
            continue
        calls.append(Call(t0, time.perf_counter(), nin, nout))


def _profiler(logdir: str, device: str):
    """torch.profiler over every thread of the process (the port's own
    worker threads too), written to logdir."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
        experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True))


def traced_slice(driver, fn, seconds: float, device: str) -> dict:
    """A short closed loop of the same traffic under the profiler, inside
    one span; its split (trace_split.py), busy and window seconds and the
    calls it made."""
    import torch

    from . import trace_split

    logdir = tempfile.mkdtemp(prefix="zbench_trace_")
    try:
        with _profiler(logdir, device):
            span = torch.profiler.record_function(WINDOW_SPAN)
            _, calls, failed = closed_loop(driver, fn, seconds, before=span.__enter__)
            span.__exit__(None, None, None)
        split = trace_split.trace_split(logdir, WINDOW_SPAN)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return {"split": split, "calls": calls, "failed": failed,
            "busy_s": split["device_busy_ms"] / 1e3, "window_s": split["wall_ms"] / 1e3}


@contextlib.contextmanager
def smi_sampler(on: bool):
    """nvidia-smi's utilization.gpu sampled every 100 ms while the block
    runs (a cross-check of the traced idle share), where `on` and it
    exists; yields a list that holds the samples afterwards."""
    samples: list = []
    exe = shutil.which("nvidia-smi") if on else None
    if exe is None:
        yield samples
        return
    proc = subprocess.Popen([exe, "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
                             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)
    try:
        yield samples
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        samples.extend(float(x) for x in out.split() if x.replace(".", "", 1).isdigit())


def card_info(device: str) -> dict:
    """The card's name and power limit from nvidia-smi, where it runs."""
    exe = shutil.which("nvidia-smi") if device == "cuda" else None
    if exe is None:
        return {}
    res = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return {"nvidia_smi": res.stdout.strip()}


def leaked_modules() -> list:
    """Modules of jax, jaxlib, flax or tpuzlib in this process, by whole
    top-level name (tpuzlib_torch is not tpuzlib)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
             program=None) -> dict:
    """One run of `cell`: returns the result line as a dict.  `program`
    (the control and the fault tests, stand_in) stands in for the
    driver's call to the port.  Raises UnknownEntry before set-up where
    the driver times an entry point that no reader keys on."""
    import torch

    import tpuzlib_torch
    from tpuzlib_torch.utils import trace as port_trace

    mod = load_driver(cell)
    times = timed_entry(cell, mod)
    port_trace.enable(trace)
    fn = (program or mod.program)(tpuzlib_torch, cell.config, device)
    driver = mod.Driver(cell.config, cell.traffic, seed, device)
    driver.warm(fn)  # every shape the traffic uses
    if device == "cuda":
        torch.cuda.synchronize()
    port_trace.reset()
    before = port_trace.get_counters()
    with smi_sampler(trace and device == "cuda") as smi:
        start, calls, failed = closed_loop(driver, fn, seconds)
    end = max((c.t1 for c in calls), default=start)
    stages = port_trace.get_telemetry()
    after = port_trace.get_counters()
    counters = {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)}
    sliced = None
    if trace:
        sliced = traced_slice(driver, fn, cell.traffic["trace_seconds"], device)
        failed += sliced["failed"]
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    readings, sizes = mod.check(cell.config, cell.traffic, driver)
    readings = {**readings, "failed_calls": (failed, 0), "empty_window": (int(not calls), 0)}
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    run = Run(times, kind, start - t_start, end - start, calls, stages,
              counters, sizes, sliced)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module(os.path.join(cell.root, "zbench", "metrics", m["name"] + ".py")).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": peak}
    traced = len(sliced["calls"]) if sliced is not None else 0
    line = {"correct": all(v <= lim for v, lim in readings.values()),
            "attempted": len(calls) + traced + failed, "failed": failed, "metrics": metrics,
            "device": dev, "card": card_info(device)}
    if sliced is not None:
        split = sliced["split"]
        dev["busy_s"], dev["window_s"] = sliced["busy_s"], sliced["window_s"]
        line["breakdown"] = {
            "device_ops": [[o["op"], o["ms"] / 1e3] for o in split["top_ops"]],
            "idle_gaps": [[g["stage"], g["ms"] / 1e3] for g in split["longest_gaps"]]}
        line["trace"] = {"calls": len(sliced["calls"]), "device_ops": split["device_ops"],
                         "stage_ms": split["stage_ms"], "idle_ms_by_stage": split["idle_ms_by_stage"],
                         "smi_util_pct": sum(smi) / len(smi) if smi else None,
                         "smi_samples": len(smi)}
    line["window"] = {"calls": len(calls), "seconds": end - start, **sizes,
                      "counters": {k: v for k, v in counters.items() if v}}
    line["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in readings.items()}
    return line

