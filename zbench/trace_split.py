"""The split of a traced window from a torch.profiler Chrome trace.

A frozen copy of chip_smoke.py's `_op_name` and `trace_split` at commit
8f9712c.  The benchmark keeps its own copy so that a later change to
chip_smoke.py cannot move the yardstick its per-layer metrics and
breakdown are read with.
"""

from __future__ import annotations

import collections
import glob
import json
import os


def _op_name(name: str) -> str:
    """A device operation's name up to its argument list, without its
    namespaces, at most 120 characters (template arguments kept); a copy
    or a memset by its whole name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    for ns in ("void ", "(anonymous namespace)::", "at::native::", "at_cuda_detail::",
               "cub::", "std::"):
        name = name.replace(ns, "")
    depth = 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name.strip()[:120]


def trace_split(logdir: str, window: str) -> dict:
    """The split of the call under the record_function span `window` in
    logdir's Chrome trace (ts and dur in µs): its wall ms; the card's busy
    ms, the union of its kernel, copy and memset intervals inside the
    window, and idle share; the 8 device operations of most time; each
    stage span's host ms; the idle ms under each innermost stage span; and
    the 8 longest idle gaps, each with the innermost stage span open on
    the host at its middle."""
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    (win,) = [e for e in spans if e["name"] == window]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    stages = [e for e in spans if e is not win and w0 <= e["ts"] <= w1]
    ops = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = []
    for a, b in sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in ops):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def open_at(t):
        inner = [e for e in stages if e["ts"] <= t <= e["ts"] + e["dur"]]
        return max(inner, key=lambda e: e["ts"])["name"] if inner else "(no stage)"

    busy_us = sum(b - a for a, b in busy)
    by_op, n_op = collections.Counter(), collections.Counter()
    for e in ops:
        by_op[_op_name(e["name"])] += e["dur"]
        n_op[_op_name(e["name"])] += 1
    stage_ms, idle_ms = collections.Counter(), collections.Counter()
    for e in stages:
        stage_ms[e["name"]] += e["dur"] / 1e3
    for a, b in gaps:
        idle_ms[open_at((a + b) / 2)] += (b - a) / 1e3
    return {
        "wall_ms": (w1 - w0) / 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": 1 - busy_us / (w1 - w0), "device_ops": len(ops),
        "top_ops": [{"op": k, "ms": v / 1e3, "count": n_op[k]} for k, v in by_op.most_common(8)],
        "stage_ms": dict(stage_ms.most_common()), "idle_ms_by_stage": dict(idle_ms.most_common()),
        "longest_gaps": [{"ms": (b - a) / 1e3, "at_ms": (a - w0) / 1e3, "stage": open_at((a + b) / 2)}
                         for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:8]],
    }
