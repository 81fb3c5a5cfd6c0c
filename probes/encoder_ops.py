"""The torch ops that one batch of the encoder dispatches, on any device.

    python3 probes/encoder_ops.py [ROOT ...]

For each checkout ROOT (default: this one; an earlier one unpacked with
`git archive`), one process imports its tpuzlib_torch, encodes one batch
of the seeded mixed corpus at level 6 (16 KiB chunks, batch 2) on the
CPU, and counts the aten ops dispatched outside the kernel wrappers,
whose plain versions stand in for one launch each and are counted apart.
That is the host dispatch a batch costs on the card, where each wrapper
is one launch (ROADMAP queue 2, E1).  The count does not depend on the
shapes: every loop of the encoder has a fixed trip count.  Prints one
JSON object a checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from tpuzlib_torch import testing
from tpuzlib_torch.kernels import deflate_device3 as d3

state = {"ops": 0, "inside": 0, "launches": 0}

class Count(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        state["ops"] += state["inside"] == 0
        return func(*args, **(kwargs or {}))

def wrapped(f):
    def g(*a, **k):
        state["inside"] += 1
        try:
            return f(*a, **k)
        finally:
            state["inside"] -= 1
            state["launches"] += 1
    return g

for name in ("near_screen", "far_screen", "segment_parse", "pack_fields", "pack_words"):
    if hasattr(d3, name):
        setattr(d3, name, wrapped(getattr(d3, name)))
chunk, batch = 1 << 14, 2
args = [torch.from_numpy(a) for a in
        d3.batch_arrays(testing.mixed(1 << 16, 1), range(batch), chunk, batch)]
enc = d3.make_encode_batch_v3(6, chunk, batch, d3.out_words_for(chunk))
with Count():
    enc(*args)
print(json.dumps({"root": sys.argv[1], "ops_outside_kernels": state["ops"],
                  "kernel_calls": state["launches"]}))
"""


def main() -> int:
    roots = sys.argv[1:] or [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    for root in roots:
        out = subprocess.run([sys.executable, "-c", RUN, os.path.abspath(root)],
                             capture_output=True, text=True, check=True).stdout
        print(out.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
