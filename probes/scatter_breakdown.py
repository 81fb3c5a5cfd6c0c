"""scatter_max before and after its redesign, and the three probe kernels
that sit at the launch floor, on one CUDA card.

    python3 probes/scatter_breakdown.py OLD_ROOT

OLD_ROOT is a checkout whose gather_probe.cu runs scatter_max a thread an
element, a global atomicMax into an output its wrapper zeroes first (the
commit before the redesign, unpacked with `git archive`).  Builds OLD_ROOT's
gather_probe.cu alone, and copies of this checkout's changed by the text
patches of PATCHES, into probes/_build/ (one nvcc each, all at once; a
variant that does not build is reported and left out), then prints, after
the card's name and power limit, one JSON object a line:

  sass     from `cuobjdump -sass`: for each scatter kernel, old, new and
           patched, its atomics by opcode (ATOMS on shared memory against
           ATOMG and RED on global memory, and any CAS loop), its LDG, STG,
           LDS and STS, and `ldg_before_use` (the LDGs issued before the
           first instruction that reads a loaded value); for var_shifts,
           window64 and row_store_loop (inflate_prims.cu, this checkout's
           library) the same loads and stores and their launch grid;
  floor    the bare-launch floor in this process: take_along on (1, 1), as
           chip_smoke's "I launch floor" line, device ms;
  scatter  in RUNS runs, each after its own floor: scatter_max on the
           encoder batch's (8, 2304, 128) into 2,304 rows (chip_smoke I's
           shape; values in [0, 2^31)), on one such chunk, and on the
           tool's (256, 128) into 256 rows (its values zeros, and random
           ones beside): device ms of OLD_ROOT's kernel with its output's
           zeroing (`old`; `old_kernel` the kernel alone) and of this
           checkout's smem route at the width scatter_slabs gives (`new`),
           in turns old, new, new, old (bare launches queued behind a sleep
           kernel, 50 a timing), each output held to the plain version's,
           with each time's excess over the floor (`over_floor_`), beside:
             cols_<C>  the smem route at slabs of C = 1, 2, 4, 8, 16
                       columns (the entry point's argument);
             global    this checkout's global route (its zeroing included);
             the patched copies, at the plan's width:
               rowmajor  the slab row-major (row i's column j at i * C +
                         j), where the kernel keeps it column-major;
               padded    row-major with a word of padding a row (i * (C
                         + 1) + j) against bank conflicts;
               batch1    one row's loads a thread before its updates,
                         where the kernel issues kScatterBatch = 4;
               batch2, batch8
                         two and eight rows' loads;
               zero_first the slab zeroed before the first loads issue,
                         where the kernel zeroes while they are in flight;
               no_skip   every element's atomic, where the kernel skips
                         values of 0 or less (which cannot raise a slab
                         that starts at 0);
           and, on the encoder batch, `flushed_ms`: old, new and the
           batch and zeroing patches with the L2 evicted and written back
           by a 64 MiB read before each call (events around the call);
  calls    the 200-call host-held time of the parent's wrapper (torch.zeros
           and its launch) and this one's (torch.empty and its launch), in
           turns, after 20, beside scatter_reduce_ "amax" (chip_smoke's
           library call), and each call's host µs alone (200 calls, no
           wait on the card) and device ms alone (behind a sleep kernel);
  prims    var_shifts, window64 and row_store_loop at 128 and 8,192 lanes
           (chip_smoke I's inputs) in three runs, each run after its own
           floor: device ms and the excess over that floor, outputs held to
           the plain versions; `over_0.3us_in_all_runs` names a kernel
           more than 0.3 us over the floor in every run.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from probes.store_min_breakdown import (  # noqa: E402
    CSRC, OUT, caller, device_ms, entry, floor, ints, turns)
from probes.tree_fetch_breakdown import _LINE, load_runs  # noqa: E402
from tpuzlib_torch.kernels import _build, gather_probe as gp, inflate_prims as ip  # noqa: E402

I32 = np.iinfo(np.int32)
_SLAB_AT = "  return j * rows + row;\n"
_SLAB_WORDS = "  return static_cast<long long>(rows) * cols;\n"
_FIRST_LOAD = "  if (active) load(first);\n"
_NEXT_LOAD = "      if (r0 != first) load(r0);\n"
# the variants of gather_probe.cu: [(text in the file, its replacement)]
PATCHES = {
    "rowmajor": [(_SLAB_AT, "  return row * cols + j;\n")],
    "padded": [(_SLAB_AT, "  return row * (cols + 1) + j;\n"),
               (_SLAB_WORDS, "  return static_cast<long long>(rows) * (cols + 1);\n")],
    "batch1": [("constexpr int kScatterBatch = 4;", "constexpr int kScatterBatch = 1;")],
    "batch2": [("constexpr int kScatterBatch = 4;", "constexpr int kScatterBatch = 2;")],
    "batch8": [("constexpr int kScatterBatch = 4;", "constexpr int kScatterBatch = 8;")],
    "zero_first": [(_FIRST_LOAD, ""), (_NEXT_LOAD, "      load(r0);\n")],
    "no_skip": [("  if (v > 0 && static_cast<unsigned>(i)", "  if (static_cast<unsigned>(i)")],
}
SCATTER_KERNELS = ("scatter_max_smem", "scatter_max_kernel")
PRIM_KERNELS = ("var_shifts_kernel", "window64_kernel", "row_store_loop_kernel")
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_ARGS = [_P, _P, _I, _I, _I, _I, _P, _P]
LANES = (128, 8192)
RUNS = 3  # the scatter turns, each after its own floor
SHAPES = (("batch8", (8, 2304, 128), 2304, "random"), ("tool", (1, 256, 128), 256, "zeros"),
          ("tool", (1, 256, 128), 256, "random"), ("chunk", (1, 2304, 128), 2304, "random"))
FLUSHED = ("old", "new", "batch1", "batch2", "batch8", "zero_first")


def nvcc(src: str, name: str) -> subprocess.Popen:
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                             os.path.join(OUT, "lib%s.so" % name), src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def sass(label: str, lib: str, kernels, grid=None) -> None:
    """One JSON line for each kernel of `kernels` in the library `lib`."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split(None, 1)[0]
        kernel = next((k for k in kernels if k in name), None)
        if kernel is None:
            continue
        ops = [op for op, _ in _LINE.findall(part)]
        runs = load_runs(part)
        atomics = {}
        for op in ops:
            if op.startswith(("ATOM", "RED")):
                atomics[op] = atomics.get(op, 0) + 1
        row = {"probe": "sass", "which": label, "kernel": name, "atomics": atomics,
               "global_atomics": sum(n for op, n in atomics.items()
                                     if op.startswith(("ATOMG", "RED", "ATOM."))),
               "cas": sum(n for op, n in atomics.items() if "CAS" in op),
               **{k: sum(o.startswith(k) for o in ops) for k in ("LDG", "STG", "LDS", "STS")},
               "ldg_before_use": runs[0] if runs else 0,
               "ldg_runs": [r for r in runs if r], "instructions": len(ops)}
        if grid:
            row["grid"] = grid
        print(json.dumps(row), flush=True)


def held(outs: dict, want: torch.Tensor, what) -> None:
    torch.cuda.synchronize()
    for k, o in outs.items():
        if not torch.equal(o, want):
            raise SystemExit("scatter_breakdown: %s differs from the plain version at %s"
                             % (k, what))


def host_ms(fn, reps: int = 200, warmup: int = 20) -> float:
    """Mean ms of fn() over `reps` calls after `warmup`, CUDA events
    around the calls, as chip_smoke's cuda_ms: held by the host where a
    call's host time passes its device time."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flushed_ms(fn, reps: int = 20) -> float:
    """Device ms of fn() with the L2 evicted and its dirty lines written
    back by a read of 64 MiB before each call, CUDA events around each
    call alone, the calls queued behind a sleep kernel; the mean of
    `reps` (chip_smoke's flushed_ms)."""
    evict = torch.ones(16 << 20, dtype=torch.int32, device="cuda")
    total = torch.empty((), dtype=torch.int64, device="cuda")
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2 * reps)]

    def call(i):
        torch.sum(evict, 0, out=total)
        marks[2 * i].record()
        fn()
        marks[2 * i + 1].record()

    for i in range(3):
        call(i)
    torch.cuda.synchronize()
    torch.cuda._sleep(int((reps * 200e-6 + 1e-3) * 1.98e9))
    for i in range(reps):
        call(i)
    torch.cuda.synchronize()
    return sum(marks[2 * i].elapsed_time(marks[2 * i + 1]) for i in range(reps)) / reps


def scatter(old, variants, dev, floor_ms, run) -> None:
    rng = np.random.default_rng(20)
    new = _build.lib.fns["tz_scatter_max"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    staged = gp.staged_words(dev)
    for label, (b, r, w), rows, values in SHAPES:
        idx = ints(rng, (b, r, w), 0, rows, dev)
        vals = (torch.zeros(b, r, w, dtype=torch.int32, device=dev) if values == "zeros"
                else ints(rng, (b, r, w), 0, I32.max, dev))
        cols, threads = gp.scatter_slabs(b, r, w, rows, sms, staged)
        want = gp.scatter_max_plain(idx, vals, rows)
        outs = {k: torch.empty(b, rows, w, dtype=torch.int32, device=dev)
                for k in ("old", "old_kernel", "new", "global",
                          *("cols_%d" % c for c in (1, 2, 4, 8, 16)), *variants)}
        args = (idx, vals, b, r, w, rows)
        old_go = caller(old, *args, outs["old"])
        zero_old, zero_global = outs["old"].zero_, outs["global"].zero_
        global_go = caller(new, *args, 0, 0, outs["global"])
        go = {"old": lambda: (zero_old(), old_go()),
              "old_kernel": caller(old, *args, outs["old_kernel"]),
              "new": caller(new, *args, cols, threads, outs["new"]),
              "global": lambda: (zero_global(), global_go())}
        outs["old_kernel"].zero_()
        for c in (1, 2, 4, 8, 16):
            go["cols_%d" % c] = caller(new, *args, c, gp.scatter_threads(r, w, rows, c),
                                       outs["cols_%d" % c])
        for k, f in variants.items():
            go[k] = caller(f, *args, cols, threads, outs[k])
        for f in go.values():
            f()
        held(outs, want, (label, values))
        row = turns(go, {"probe": "scatter", "run": run, "shape": [b, r, w], "rows": rows,
                         "values": values, "cols": cols, "threads": threads,
                         "blocks": b * -(-w // cols),
                         "route": gp._scatter_design(rows, staged), "floor_ms": floor_ms},
                    floor_ms)
        if label == "batch8":  # with the L2 evicted before each call
            row["flushed_ms"] = {k: flushed_ms(go[k]) for k in FLUSHED if k in go}
        print(json.dumps(row), flush=True)
        if values == "zeros" or label == "chunk":
            continue
        # the wrappers' host-held time: the parent's (its zeroing and launch)
        # against this one's, in turns, and the library call
        stream = _build._raw_stream(dev.index)
        iptr, vptr = idx.data_ptr(), vals.data_ptr()

        def parent():
            _build.on_cpu(idx)
            gp._check_scatter(idx, vals, rows)
            out = torch.zeros(b, rows, w, dtype=torch.int32, device=dev)
            if old(iptr, vptr, b, r, w, rows, out.data_ptr(), stream):
                raise SystemExit("scatter_breakdown: the parent's launch was refused")
            return out

        lib_out, idx64 = torch.zeros(b, rows, w, dtype=torch.int32, device=dev), idx.long()
        calls = {"parent": parent, "this": lambda: gp.scatter_max(idx, vals, rows),
                 "library": lambda: lib_out.scatter_reduce_(1, idx64, vals, "amax")}
        t = {k: [] for k in calls}
        for k in ("parent", "this", "library", "this", "parent", "library"):
            t[k].append(host_ms(calls[k]))
        # each call's host time alone (no wait on the card) and device time
        # alone (behind a sleep kernel)
        host_us, device = {}, {}
        for k, f in calls.items():
            f()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                f()
            host_us[k] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            device[k] = device_ms(f)
        print(json.dumps({"probe": "calls", "run": run, "shape": [b, r, w], "rows": rows,
                          "reps": 200, **{k + "_ms": v for k, v in t.items()},
                          **{k + "_host_us": v for k, v in host_us.items()},
                          **{k + "_device_ms": v for k, v in device.items()}}), flush=True)


def prims(dev, runs: int = 3) -> None:
    rng = np.random.default_rng(21)
    fns = _build.lib.fns
    cases = {}
    for lanes in LANES:
        rv, eb = ints(rng, (1, lanes), 0, 1 << 16, dev), ints(rng, (1, lanes), 0, 14, dev)
        win = (*(ints(rng, (1, lanes), I32.min, I32.max, dev) for _ in range(3)),
               ints(rng, (1, lanes), 0, 32, dev), ints(rng, (1, lanes), 0, 21, dev))
        outs = {k: torch.empty(n, lanes, dtype=torch.int32, device=dev)
                for k, n in (("var_shifts", 17), ("window64", 3), ("row_store_loop", 24))}
        cases[lanes] = {
            "var_shifts": (caller(fns["tz_var_shifts"], rv, eb, lanes, outs["var_shifts"]),
                           outs["var_shifts"], ip.var_shifts_plain(rv, eb)),
            "window64": (caller(fns["tz_window64"], *win, lanes, outs["window64"]),
                         outs["window64"], ip.window64_plain(*win)),
            "row_store_loop": (caller(fns["tz_row_store_loop"], 24, lanes, outs["row_store_loop"]),
                               outs["row_store_loop"], ip.row_store_loop_plain(24, lanes, dev))}
        for name, (go, out, want) in cases[lanes].items():
            go()
            held({name: out}, want, ("prims", lanes))
    excess = {(k, lanes): [] for lanes in LANES for k in cases[lanes]}
    for run in range(runs):
        floor_ms = floor(dev)
        row = {"probe": "prims", "run": run, "floor_ms": floor_ms}
        for lanes in LANES:
            for name, (go, _, _) in cases[lanes].items():
                ms = device_ms(go)
                row["%s_%d_ms" % (name, lanes)] = ms
                row["over_floor_%s_%d_ms" % (name, lanes)] = ms - floor_ms
                excess[name, lanes].append(ms - floor_ms)
        print(json.dumps(row), flush=True)
    print(json.dumps({"probe": "prims", "runs": runs, "over_0.3us_in_all_runs": sorted(
        "%s_%d" % key for key, e in excess.items() if min(e) > 0.0003)}), flush=True)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("scatter_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    old_src = os.path.join(sys.argv[1], "tpuzlib_torch", "kernels", "csrc", "gather_probe.cu")
    procs = {"sc_old": nvcc(old_src, "sc_old")}
    with open(os.path.join(CSRC, "gather_probe.cu")) as f:
        text = f.read()
    for name, patches in PATCHES.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise SystemExit("%r is not once in gather_probe.cu" % old)
            src = src.replace(old, new)
        path = os.path.join(OUT, "sc_" + name + ".cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = nvcc(path, "sc_" + name)
    _build.lib()
    built = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        built[name] = p.returncode == 0
        if not built[name]:
            print(json.dumps({"variant": name, "built": False, "nvcc": log[-2000:]}), flush=True)
    if not built["sc_old"]:
        raise SystemExit("scatter_breakdown: OLD_ROOT's gather_probe.cu does not build")
    sass("old", os.path.join(OUT, "libsc_old.so"), SCATTER_KERNELS)
    lib = _build.build()
    sass("new", lib, SCATTER_KERNELS)
    for name in PATCHES:
        if built[name]:
            sass(name, os.path.join(OUT, "libsc_%s.so" % name), SCATTER_KERNELS)
    sass("new", lib, PRIM_KERNELS, grid="ceil(lanes / 256) blocks of 256 threads (blocks_for)")
    dev = torch.device("cuda", torch.cuda.current_device())
    variants = {k: entry("sc_" + k, "tz_scatter_max", _build._ARGTYPES["tz_scatter_max"])
                for k in PATCHES if built[k]}
    old = entry("sc_old", "tz_scatter_max", OLD_ARGS)
    for run in range(RUNS):
        scatter(old, variants, dev, floor(dev), run)
    prims(dev)
    floor(dev)  # again after the kernels
    return 0


if __name__ == "__main__":
    sys.exit(main())
