"""Where the device inflate's header scan spends its time on one CUDA card,
beside the native host scan it replaced there.

    python3 probes/header_scan_breakdown.py [--seed 2420000001] [--reps 3] [--out FILE]

On one stream of the benchmark's pylogs-gzip9.inflate-1c cell (the
seed's 32 MiB blend of 1 MiB text pieces, zlib level 9, the raw body of
its gzip member):

  kernels       the two kernels of csrc/header_scan.cu (one tz_header_scan
                call), device ms by CUDA events, mean of 20 calls queued
                back to back after a warm-up, and each kernel's mean device
                ms from torch.profiler where it traces the card;
  card          the scan as the planner runs it on the card: the stream
                words built and uploaded (inflate_cuda.stream_words), the
                kernels, the read-back and the host's confirmation
                (header_scan.block_starts), host ms;
  upload, confirm
                those two pieces alone, host ms;
  plain         the kernels' plain version (header_scan.candidates_plain) on
                the card's tensors, host ms of one call after a warm one;
  native        find_all_block_starts on the host (tz_find_headers, up to
                4 threads), host ms.

card and native run in turns (card, native, native, card) --reps times;
each figure is the median of its calls.  Each kernel's bound is
header_scan.bounds_ms of the plain version's counts on the card's
tensors (work_plain) at 3.35 TB/s and the INT32 issue rate (132 SMs x 64
lanes x 1.98 GHz, 16.7 T/s), against its torch.profiler time.  Prints the card's name and power limit, then one JSON line,
also written to --out where it is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12
SM_HZ = 1.98e9  # the H100 SXM's top SM clock
INT32_OPS_PER_S = 132 * 64 * SM_HZ  # 132 SMs of 64 INT32 lanes


def pylogs_stream(seed: int):
    from zbench.entries import blend
    from zbench.reference import zlib_ref

    with open(os.path.join(ROOT, "zbench", "configs", "pylogs-gzip9.json")) as f:
        config = json.load(f)
    data = np.concatenate(blend(config["data"], 32 << 20, seed))
    return np.frombuffer(zlib_ref.compress(data, config), np.uint8)[10:-8]


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2420000001)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("header_scan_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from tpuzlib_torch.kernels import _build
    from tpuzlib_torch.kernels import header_scan as HS
    from tpuzlib_torch.kernels import inflate_cuda as PC
    from tpuzlib_torch.kernels import inflate_device2 as P
    from tpuzlib_torch.parallel import speculative as sp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    buf = pylogs_stream(args.seed)
    nbits = len(buf) * 8
    lay = P.plan_cursors(buf)
    from_bit = (lay.plan[0].data_start >> 3) * 8
    dev = torch.device("cuda")

    def upload():
        return PC.stream_words(buf, lay.stride_bits, 2 * P.OVERLAP, dev)

    def card():
        return HS.block_starts(buf, upload(), from_bit)

    def native():
        return sp.find_all_block_starts(buf, from_bit, True)

    words = upload()
    want = native()
    assert card() == want, "the card scan differs from the native scan"
    cands = HS.candidates(words, nbits, from_bit)

    # the kernels alone: one tz_header_scan call, room for every survivor
    cap = HS._first_cap(nbits)
    cand = torch.empty(cap, dtype=torch.int32, device=dev)
    res = torch.empty(2 + cap, dtype=torch.int32, device=dev)

    def launch():
        _build.launch(("header_filter", "header_parse"), "tz_header_scan", dev, words.data_ptr(),
                      words.numel(), nbits, from_bit, 1, cand.data_ptr(), cap, res.data_ptr())

    launch()
    torch.cuda.synchronize()
    n_filter = int(res[0])
    calls = 20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        launch()
    end.record()
    torch.cuda.synchronize()
    kernels_ms = start.elapsed_time(end) / calls
    per_kernel = {}
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                launch()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            for name in ("header_filter", "header_parse"):
                if name + "_kernel" in ev.key:
                    t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
                    per_kernel[name] = t / 1e3 / max(1, ev.count)
    except Exception as e:  # the profiler may not trace the card here
        per_kernel = {"error": repr(e)}

    times = {"card": [], "native": [], "upload": [], "confirm": []}
    for _ in range(args.reps):
        for name in ("card", "native", "native", "card"):
            out, ms = host_ms(card if name == "card" else native)
            assert out == want
            times[name].append(ms)
        _, ms = host_ms(upload)
        times["upload"].append(ms)
        _, ms = host_ms(lambda: sp.confirm_block_starts(buf, cands))
        times["confirm"].append(ms)

    HS.candidates_plain(words, nbits, from_bit)
    plain, plain_ms = host_ms(lambda: HS.candidates_plain(words, nbits, from_bit))
    assert np.array_equal(plain, cands)

    work = HS.work_plain(words, nbits, from_bit)
    assert work["survivors"] == n_filter and work["passes"] == len(cands)
    bounds = HS.bounds_ms(work, HBM_BYTES_PER_S, INT32_OPS_PER_S, SM_HZ)
    line = {
        "probe": "header_scan_breakdown", "card": smi, "seed": args.seed,
        "stream_bytes": int(len(buf)), "from_bit": from_bit, "headers": len(want),
        "filter_survivors": n_filter, "candidates": int(len(cands)),
        "work": work, "kernels_device_ms": kernels_ms,
        "per_kernel_device_ms": per_kernel, "launches_a_scan": 2, "plain_ms": plain_ms,
        "bound_ms": {k: b[0] for k, b in bounds.items()},
        "bound_by": {k: b[1] for k, b in bounds.items()},
        "pct_of_bound": {k: 100.0 * b[0] / per_kernel[k] for k, b in bounds.items()
                         if per_kernel.get(k)},
        **{name + "_ms": float(np.median(v)) for name, v in times.items()},
        **{name + "_ms_all": v for name, v in times.items()},
    }
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(line, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
