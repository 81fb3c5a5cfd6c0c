"""The host routes a BGZF slice could take, beside inflate_members() on
the card, on the card's own host: the bar the device route has to pass.

    python3 probes/members_bar.py [--mib 32] [--calls 5]

One 32 MiB slice of the benchmark cell's BAM records
(zbench/entries/bgzf.py), its members written by Python's zlib at level
6.  Each row is the median and range of `calls` warm calls, in MB/s of
output: inflate_members(device="cpu") (the host route, the host engine a
member at a time), decompress_members(wire, index) with 1 and with 8
workers (host threads, no member checked), Python's zlib member by
member (zbench/reference/bgzf_ref.read, every member checked), and, on a
card, inflate_members(device="cuda") with its stages' host seconds.
Prints one JSON line a row, the first the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tpuzlib_torch  # noqa: E402
from tpuzlib_torch.api.inflate_api import member_index  # noqa: E402
from tpuzlib_torch.parallel.members import decompress_members  # noqa: E402
from tpuzlib_torch.utils import trace  # noqa: E402
from zbench.entries import bgzf  # noqa: E402
from zbench.reference import bgzf_ref  # noqa: E402


def timed(fn, calls: int) -> dict:
    fn()  # warm
    secs = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = fn()
        secs.append(time.perf_counter() - t0)
    n = len(out[0] if isinstance(out, tuple) else out)
    return {"MBps": n / statistics.median(secs) / 1e6, "MBps_range": [n / max(secs) / 1e6,
                                                                       n / min(secs) / 1e6],
            "s": statistics.median(secs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mib", type=int, default=32)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    smi = shutil.which("nvidia-smi")
    card = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip() if smi else "none"
    print(json.dumps({"card": card, "cores": os.cpu_count()}), flush=True)
    config = {"level": 6, "window_bits": 15, "mem_level": 8, "member_input_bytes": 65280}
    data = bgzf.records(args.mib << 20, [3000000051, 0])
    wire = np.frombuffer(b"".join(bgzf_ref.member(p, config) for p in bgzf_ref.pieces(data, config))
                         + bgzf_ref.EOF_MEMBER, np.uint8)
    index = [m.start for m in member_index(wire)]
    rows = {
        "inflate_members_host_route": lambda: tpuzlib_torch.inflate_members(wire, device="cpu"),
        "decompress_members_1_worker": lambda: decompress_members(wire, index, max_workers=1),
        "decompress_members_8_workers": lambda: decompress_members(wire, index, max_workers=8),
        "zlib_member_by_member": lambda: bgzf_ref.read(wire),
    }
    if torch.cuda.is_available():
        rows["inflate_members_card"] = lambda: tpuzlib_torch.inflate_members(wire, device="cuda")
    for name, fn in rows.items():
        print(json.dumps({"row": name, "members": len(index), **timed(fn, args.calls)}), flush=True)
    if torch.cuda.is_available():
        trace.enable(True)
        trace.reset()
        tpuzlib_torch.inflate_members(wire, device="cuda")
        trace.enable(False)
        print(json.dumps({"row": "inflate_members_card stages",
                          "self_s": {k: v["self_seconds"] for k, v in trace.get_telemetry().items()},
                          "s": {k: v["seconds"] for k, v in trace.get_telemetry().items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
