"""Counterparts of the repo's tools/ probes on PyTorch and CUDA.

Each module keeps its tool's name (tools/probe_crc.py and
tpuzlib_torch/tools/probe_crc.py) and has a main(argv), run as

    python -m tpuzlib_torch.tools.probe_crc [--device cuda|cpu] [--mib 64] [--reps 20]

Every probe prints JSON lines: first the card's `nvidia-smi
--query-gpu=name,power.limit` line (null on the CPU), then one line a
measurement with the tool's name.  On the card a time is the mean of
`reps` back-to-back calls between two CUDA events, after three warm-up
calls; on the CPU (the tests) it is one call on the host clock, and says
nothing about the card.  The CRC probes read the tools' data, `--mib` MiB
from numpy's default_rng(0), and give ms a pass and GB/s; the gather and
primitive probes (probe_gather, probe_primitives, probe_inflate_prims,
probe_inflate_prims2) take no --mib, make the tools' int32 arrays from the
tools' seeds, and give each line a verdict (`held`).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..kernels import crc32


def parse(argv, doc: str, data: bool) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    if data:
        p.add_argument("--mib", type=int, default=64, help="MiB of data (the tools' 64)")
    p.add_argument("--reps", type=int, default=20, help="timed calls a measurement on the card")
    return p.parse_args(argv)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def begin(argv, doc: str, data: bool = False):
    """Parse argv (with --mib where `data`), print the card's line; returns
    (args, device)."""
    args = parse(argv, doc, data)
    dev = torch.device(args.device)
    smi = None
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
    emit({"nvidia_smi": smi, "device": str(dev),
          "clock": "cuda events" if dev.type == "cuda" else "host"})
    return args, dev


def start(argv, doc: str):
    """Parse argv, print the card's line; returns (args, device, data as a
    numpy array, the same bytes as a tensor on the device)."""
    args, dev = begin(argv, doc, data=True)
    host = np.random.default_rng(0).integers(0, 256, args.mib << 20, np.uint8)
    return args, dev, host, torch.from_numpy(host).to(dev)


def time_ms(fn, dev: torch.device, reps: int) -> float:
    """ms a call of fn: on the card the mean of `reps` calls between CUDA
    events after 3 warm-ups; on the CPU one call on the host clock."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def report(name: str, ms: float, nbytes: int, **extra) -> None:
    emit({"name": name, "ms_per_pass": ms, "GBps": nbytes / ms / 1e6, "bytes": nbytes, **extra})


def held(name: str, calls: dict, dev: torch.device, reps: int,
         words=("MATCH", "DIVERGE", "FAIL"), units: dict | None = None, **extra) -> None:
    """Hold a kernel to its plain version and time it.  calls: label ->
    (kernel call, plain call), as many shapes of one line.  Emits one line:
    words[0] (the tool's verdict for a match) and ms for each label, with
    ns an element where `units` gives a label's elements.  On a difference
    it emits words[1] and the first differing positions, on an error
    words[2] and the error, and raises."""
    ok, differs, failed = words
    ms = {}
    for label, (fn, plain) in calls.items():
        try:
            got = fn()
        except Exception as e:
            emit({"name": name, "verdict": failed, "at": label,
                  "error": "%s: %s" % (type(e).__name__, str(e).split("\n")[0][:160])})
            raise
        want = plain()
        if not torch.equal(got, want):
            first = []
            if got.shape == want.shape:
                for pos in (got != want).nonzero()[:6].tolist():
                    first.append({"at": pos, "got": int(got[tuple(pos)]),
                                  "want": int(want[tuple(pos)])})
            emit({"name": name, "verdict": differs, "at": label, "shapes": [list(got.shape),
                  list(want.shape)], "first": first})
            raise RuntimeError("%s: %s at %s" % (name, differs, label))
        ms[label] = time_ms(fn, dev, reps)
    line = {"name": name, "verdict": ok, "ms": ms, **extra}
    if units:
        line["ns_per_elem"] = {k: ms[k] * 1e6 / units[k] for k in units}
    emit(line)


def check(what: str, got: int, want: int) -> None:
    if got != want:
        raise RuntimeError("%s: CRC %#010x, zlib %#010x" % (what, got, want))


def forms_crc(cols: torch.Tensor, block: int, n: int) -> int:
    """The CRC-32 of n bytes from their blocks' parity columns (nb, 32): the
    forms packed, combined on the host and finished (seed 0)."""
    from ..kernels.crc32_probe import pack_forms

    g = pack_forms(cols).cpu().numpy().view(np.uint32)
    return crc32._finish(crc32._combine_blocks(g, block), n, 0)
