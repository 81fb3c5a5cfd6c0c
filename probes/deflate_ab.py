"""Warm deflate() throughput of two checkouts of the port, in turns.

    python3 probes/deflate_ab.py OLD_ROOT NEW_ROOT [ROUNDS]

Each run is a process of its own that imports tpuzlib_torch from one
checkout, compresses 32 MiB of the seeded mixed corpus at level 6 in the
zlib container on the card twice, checks that python's zlib decodes it,
and reports the second (warm) call.  The runs go old, new, new, old, and
so on for ROUNDS (default 2) rounds.  Prints the card's name and power
limit, then one JSON object a run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SIZE, LEVEL = 32 << 20, 6

RUN = """
import json, sys, time, zlib
import torch
sys.path.insert(0, sys.argv[1])
import tpuzlib_torch
from tpuzlib_torch import testing
data = testing.mixed(%d, seed=1)
times = []
for _ in range(2):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tpuzlib_torch.deflate(data, level=%d, device="cuda")
    times.append(time.perf_counter() - t0)
ok = zlib.decompress(out.tobytes()) == data.tobytes()
print(json.dumps({"roundtrip": ok, "bytes_out": len(out), "cold_s": times[0], "warm_s": times[1],
                  "warm_MBps": len(data) / times[1] / 1e6}))
""" % (SIZE, LEVEL)


def run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN, os.path.abspath(root)], capture_output=True,
                         text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) not in (3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    old, new = sys.argv[1:3]
    rounds = int(sys.argv[3]) if len(sys.argv) == 4 else 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    ok = True
    for _ in range(rounds):
        for name, root in (("old", old), ("new", new), ("new", new), ("old", old)):
            row = run(root)
            ok &= row["roundtrip"]
            print(json.dumps({"tree": name, **row}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
