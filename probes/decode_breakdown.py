"""Where the cursor-decode kernel's time goes, on one CUDA card.

    python3 probes/decode_breakdown.py

Builds patched copies of tpuzlib_torch/kernels/csrc/inflate_decode.cu
(one nvcc each, all at once, into probes/_build/) and times each at the
shapes of chip_smoke.py's phase G1: python zlib's level-6 stream of the
port's 32 MiB mixed corpus.  The copies drop the sentinel tails, or all
tape stores; one stores each full group of four rows as soon as it is
made, not after the next step's table loads; one computes each symbol's
bit count from the entry instead of reading it from the table; one reads
clock64() around each cursor's loop; two launch
with 24 KiB of (unused) dynamic shared memory, with and without a 25%
preferred shared-memory carve-out.  Then builds and runs latency.cu.
Prints the card's name and power limit, then one JSON object a line.
The patched copies are for timing only: only "as built" gives the
kernel's outputs, which are checked against the port's wrapper.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from tpuzlib_torch import testing  # noqa: E402
from tpuzlib_torch.kernels import _build, inflate_cuda as ic, inflate_device2 as d2  # noqa: E402

SRC = os.path.join(os.path.dirname(HERE), "tpuzlib_torch", "kernels", "csrc", "inflate_decode.cu")
OUT = os.path.join(HERE, "_build")
LOOP = "      if (cu.step(tv, bv, store_full)) {\n        const int n = cu.cnt++;"
LAUNCH = "  inflate_decode_kernel<<<grid, threads, 0,"
# variant -> [(text in the source, its replacement)]
PATCHES = {
    "as built": [],
    "no sentinel tails": [("  fill_tails(k, cnt, K, cap, tok, bp);\n}", "}")],
    "no tape stores": [("  fill_tails(k, cnt, K, cap, tok, bp);\n}", "}"),
                       (LOOP, "      if (cu.step(tv, bv, store_full) && (++cu.cnt, false)) {\n"
                              "        const int n = cu.cnt;")],
    "stores in step order": [("if (s == 3) full = n >> 2;",
                              "if (s == 3) {\n            full = n >> 2;\n"
                              "            store_full();\n          }")],
    "bit counts from the entry": [("    jump = static_cast<int>(e.y >> 8);",
                                   "    jump = len + extra_bits(ent);"),
                                  ("pos + jump1 + (is_len ? djump : 0);",
                                   "pos + jump1 + (is_len ? dlen + extra_bits(dent) : 0);")],
    "clock64 a cursor": [
        ("    for (int it = 0; it < cap && cu.status == kRun; ++it) {",
         "    const long long t0 = clock64();\n"
         "    for (int it = 0; it < cap && cu.status == kRun; ++it) {"),
        ("    fin[3 * K + k] = cu.eob_first;",
         "    fin[3 * K + k] = static_cast<int32_t>(clock64() - t0);")],
    "24 KiB shared memory": [(LAUNCH, "  inflate_decode_kernel<<<grid, threads, 24576,")],
    "24 KiB shared memory, 25% carve-out": [
        (LAUNCH, "  cudaFuncSetAttribute(inflate_decode_kernel,\n"
                 "                       cudaFuncAttributePreferredSharedMemoryCarveout, 25);\n"
                 "  inflate_decode_kernel<<<grid, threads, 24576,")],
}


def nvcc(src: str, out: str, shared: bool) -> subprocess.Popen:
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    flags += ["-shared", "-Xcompiler", "-fPIC"] if shared else []
    return subprocess.Popen([_build._nvcc(), *flags, "-o", out, src])


def cuda_ms(fn, reps: int = 10) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    text = open(SRC).read()
    procs = {}
    for i, (name, patches) in enumerate(PATCHES.items()):
        src = text
        for old, new in patches:
            if old not in src:
                raise SystemExit("decode_breakdown: %r no longer in the kernel source" % old)
            src = src.replace(old, new)
        path = os.path.join(OUT, "variant%d.cu" % i)
        with open(path, "w") as f:
            f.write(src)
        procs[name] = nvcc(path, os.path.join(OUT, "libvariant%d.so" % i), True)
    procs["latency"] = nvcc(os.path.join(HERE, "latency.cu"), os.path.join(OUT, "latency"), False)

    corpus = testing.mixed(32 << 20, seed=1)
    raw6 = np.frombuffer(testing.zlib_stream(corpus, 6), np.uint8)[2:-4]
    lay = d2.plan_cursors(raw6)
    a = lay.decode_args(raw6, "cuda")
    luts = ic.decode_luts(a)
    ref = ic.cursor_decode(a, luts)
    K, cap = a.cur.shape[1], a.cap
    if any(p.wait() for p in procs.values()):
        raise SystemExit("decode_breakdown: a build failed")

    for i, name in enumerate(PATCHES):
        fn = ctypes.CDLL(os.path.join(OUT, "libvariant%d.so" % i)).tz_inflate_decode
        fn.restype, fn.argtypes = ctypes.c_int, _build._ARGTYPES["tz_inflate_decode"]

        def run(threads=ic.DECODE_THREADS):
            tok = torch.empty(K * cap, dtype=torch.int32, device="cuda")
            bp = torch.empty_like(tok)
            fin = torch.empty((4, K), dtype=torch.int32, device="cuda")
            err = fn(a.words.data_ptr(), a.cur.data_ptr(), K, a.nwp, cap, a.tabs.data_ptr(),
                     a.lents.data_ptr(), a.dents.data_ptr(), luts.data_ptr(), ic.LUT_BITS,
                     ic.DLUT_BITS, threads, tok.data_ptr(), bp.data_ptr(), fin.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit("decode_breakdown: %s launch failed (%d)" % (name, err))
            return tok, bp, fin
        row = {"variant": name, "threads": ic.DECODE_THREADS,
               "ms": [cuda_ms(run) for _ in range(2)]}
        tok, bp, fin = run()
        if name == "as built":
            row["equal_to_wrapper"] = all(torch.equal(g, r) for g, r in zip(
                (tok, bp, fin[0], fin[1], fin[2], fin[3]), ref))
        if name == "clock64 a cursor":
            cnt, cyc = fin[0].double(), fin[3].double()
            k = int(torch.argmax(cnt))
            row["longest_cursor_symbols"] = int(cnt[k])
            row["cycles_per_symbol_of_longest"] = float(cyc[k] / cnt[k])
            live = cnt > 0
            row["median_cycles_per_symbol"] = float((cyc[live] / cnt[live]).median())
        print(json.dumps(row), flush=True)
    out = subprocess.run([os.path.join(OUT, "latency")], capture_output=True, text=True)
    print(out.stdout, end="", flush=True)
    return out.returncode


if __name__ == "__main__":
    sys.exit(main())
