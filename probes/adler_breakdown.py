"""Where the Adler-32's time goes, and the public adler32 before and after
the scalar kernel, on one CUDA card.

    python3 probes/adler_breakdown.py OLD_ROOT

OLD_ROOT is a checkout whose adler32 combines the block sums with torch
ops and reads the pair to the host (the commit before
adler32_device_scalar, unpacked with `git archive`).  On 256 MiB of the
seeded mixed corpus (chip_smoke.py's checksum input), and on its first
200 KiB and 8 MiB:

  blocks  device ms of OLD_ROOT's adler32_blocks kernel (built alone
          from its csrc/adler32.cu into probes/_build/) and this
          checkout's, in turns old, new, new, old, each held to the other;
  device  device ms of adler32_blocks alone (row 7's kernel), of
          adler32_blocks and the torch combine (adler32_totals: the
          earlier path's device work, before its read), and of
          adler32_device_scalar (one launch: the block sums, their
          combine and the finish);
  grid    device ms of the scalar's kernel at other grids: a block a
          warp (as adler32_blocks), and 4, 8, 16 and 32 CUDA blocks an SM
          looping over the blocks; each must give zlib's Adler-32;
  public  host ms of a warm tpuzlib_torch.adler32 of a card tensor of
          each size (median of 10 after 3 warm-ups), OLD_ROOT's and this
          checkout's, each in a process of its own, in turns old, new,
          new, old.

Prints the card's name and power limit, then one JSON object a line.
Device times are the mean of 10 calls after 3 warm-ups from CUDA events
with every call queued behind a sleep kernel (launch overhead hidden).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.abspath(HERE)))

from screen_breakdown import OUT, call, cuda_ms, entry, nvcc, turns  # noqa: E402

from tpuzlib_torch import testing  # noqa: E402
from tpuzlib_torch.kernels import _build, adler32_cuda  # noqa: E402

ROOT = os.path.dirname(HERE)
SIZES = {"200KiB": 200 << 10, "8MiB": 8 << 20, "256MiB": 256 << 20}

# run in OLD_ROOT and in this checkout: warm host ms of the public adler32
PUBLIC = r"""
import json, statistics, sys, time, zlib
import numpy as np, torch
sys.path.insert(0, ".")
import tpuzlib_torch
from tpuzlib_torch import testing
host = np.tile(testing.mixed(32 << 20, seed=1), 8)
big = torch.from_numpy(host).cuda()
out = {}
for name, n in %r.items():
    x, want = big[:n], zlib.adler32(host[:n])
    ms = []
    for _ in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = tpuzlib_torch.adler32(x)
        ms.append((time.perf_counter() - t0) * 1e3)
        assert got == want, name
    out[name] = statistics.median(ms[3:])
print(json.dumps(out))
""" % SIZES


def public_ms(root: str) -> dict:
    r = subprocess.run([sys.executable, "-c", PUBLIC], cwd=root, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit("adler_breakdown: the public adler32 in %s failed:\n%s"
                         % (root, r.stderr[-3000:]))
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("adler_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    old_root = os.path.abspath(sys.argv[1])
    # the earlier checkout's kernel library builds meanwhile
    old_lib = subprocess.Popen([sys.executable, "-c", "from tpuzlib_torch.kernels import _build;"
                                " _build.lib()"], cwd=old_root)
    os.makedirs(OUT, exist_ok=True)
    old_blocks = nvcc(os.path.join(old_root, "tpuzlib_torch", "kernels", "csrc", "adler32.cu"),
                      os.path.join(OUT, "libadler_old.so"))
    host = np.tile(testing.mixed(32 << 20, seed=1), 8)
    big = torch.from_numpy(host).cuda()
    if old_blocks.wait():
        raise SystemExit("adler_breakdown: the earlier adler32.cu does not build")
    old_fn = entry("libadler_old.so", "tz_adler32_blocks", [ctypes.c_void_p, ctypes.c_longlong,
                                                            ctypes.c_longlong, ctypes.c_void_p,
                                                            ctypes.c_longlong, ctypes.c_void_p])
    for size, n in SIZES.items():
        x = big[:n]
        pad = (-n) % adler32_cuda.BLOCK
        nb = (n + pad) // adler32_cuda.BLOCK
        out = torch.empty((nb, 2), dtype=torch.int32, device=big.device)
        old = lambda x=x, pad=pad, nb=nb, out=out: call(old_fn, x, x.numel(), pad, out, nb)  # noqa: E731
        old()
        if not torch.equal(out, adler32_cuda.adler32_blocks(x, pad)):
            raise SystemExit("adler_breakdown: the block sums of %s differ" % size)
        print(json.dumps({"stage": "blocks", "bytes": n,
                          **turns(old, lambda x=x, pad=pad: adler32_cuda.adler32_blocks(x, pad))}),
              flush=True)
    for size, n in SIZES.items():
        x = big[:n]
        pad = (-n) % adler32_cuda.BLOCK
        if int(adler32_cuda.adler32_device_scalar(x)) != zlib.adler32(host[:n]):
            raise SystemExit("adler_breakdown: the scalar of %s differs from zlib" % size)
        print(json.dumps({
            "stage": "device", "bytes": n,
            "blocks_ms": cuda_ms(lambda: adler32_cuda.adler32_blocks(x, pad))[0],
            "blocks_and_torch_combine_ms": cuda_ms(
                lambda: adler32_cuda.adler32_totals(adler32_cuda.adler32_blocks(x, pad)))[0],
            "scalar_ms": cuda_ms(lambda: adler32_cuda.adler32_device_scalar(x))[0]}), flush=True)
    sms = torch.cuda.get_device_properties(big.device).multi_processor_count
    lib, dev = _build.lib(), big.device
    for size, n in SIZES.items():
        x = big[:n]
        pad = (-n) % adler32_cuda.BLOCK
        nb = (n + pad) // adler32_cuda.BLOCK
        grids = {"a block a warp": -(-nb // adler32_cuda.WARPS)}
        grids.update({"%d an SM" % k: min(grids["a block a warp"], k * sms) for k in (4, 8, 16, 32)})
        line = {"stage": "grid", "bytes": n}
        for name, grid in grids.items():
            partials = torch.empty(2 * grid, dtype=torch.int64, device=dev)
            out = torch.empty((), dtype=torch.int64, device=dev)
            ticket = _build.ticket(dev)
            run = (lambda x=x, pad=pad, nb=nb, grid=grid, partials=partials, out=out, ticket=ticket:
                   call(lib.tz_adler32_scalar, x, n, pad, nb, grid, partials, ticket, 1, out))
            run()
            if int(out) != zlib.adler32(host[:n]):
                raise SystemExit("adler_breakdown: the grid %s of %s differs from zlib"
                                 % (name, size))
            line[name + " ms"] = cuda_ms(run)[0]
        print(json.dumps(line), flush=True)
    del big
    torch.cuda.empty_cache()
    if old_lib.wait():
        raise SystemExit("adler_breakdown: the earlier checkout's build failed")
    public = [public_ms(root) for root in (old_root, ROOT, ROOT, old_root)]
    print(json.dumps({"stage": "public", "host_ms_old": [public[0], public[3]],
                      "host_ms_new": [public[1], public[2]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
