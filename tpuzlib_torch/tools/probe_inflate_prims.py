"""Inflate primitive probe: the steps of the TPU decode kernel, each alone.

Counterpart of tools/probe_inflate_prims.py.  The tool held each Pallas
kernel on the chip to the same kernel in interpret mode; here each CUDA
kernel is held to its plain version, at the tool's 128 lanes (the tool's
arrays: numpy's default_rng(0), drawn in the tool's order) and at 8,192
(the TPU decode's padded cursor count on the 32 MiB level-6 stream; the
same draws from default_rng(8192)).  Lines, under the tool's names, each
MATCH with ms at both lane counts:

  a u32 sublane gather       take_along(x, idx, 0, fill=-1): row idx of
                             (8, lanes) uint32 words, by lane;
  b dyn-row store while      row_store_loop(24, lanes);
  c vec-cond while           vec_cond_while: add 1 to the lanes below 100
                             while any is, at most 64 steps;
  d fetch3 straddle          fetch_rows(words, j, 3): words j, j + 1, j + 2
                             of 40 rows, 0 past the last;
  e while+gather+store       gather_store_loop(words, j, 16).

A difference prints DIVERGE and the first differing positions, an error
FAIL, and the probe raises.  What has no counterpart: interpret mode (the
plain versions are the oracle), enable_compile_cache, and the tool's
where-chains over 8-row tiles in d and e, a TPU workaround (each lane
loads its word).

    python -m tpuzlib_torch.tools.probe_inflate_prims [--device cuda|cpu] [--reps 20]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import tools
from ..kernels import gather_probe as gp, inflate_prims as ip

LANES = ((128, 0), (8192, 8192))  # (lanes, seed): the tool's, then G1's Kpad
NW = 40  # rows of words (d, e)


def u32(rng, shape) -> np.ndarray:
    """The tool's uint32 draw, as int32 bits."""
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)


def arrays(rng, lanes: int) -> dict:
    """The tool's inputs at `lanes`, in its order of draws."""
    a = {"x": u32(rng, (8, lanes)), "idx": rng.integers(0, 8, (1, lanes), dtype=np.int32)}
    a["x0"] = rng.integers(0, 100, (1, lanes), dtype=np.int32)
    a["words"] = u32(rng, (NW, lanes))
    a["j"] = rng.integers(0, NW - 3, (1, lanes), dtype=np.int32)
    return a


def main(argv=None) -> None:
    args, dev = tools.begin(argv, __doc__)
    by_lanes = {}
    for lanes, seed in LANES:
        a = arrays(np.random.default_rng(seed), lanes)
        by_lanes[str(lanes)] = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    lines = (
        ("a u32 sublane gather", "take_along", lambda t: gp.take_along(t["x"], t["idx"], 0, -1),
         lambda t: gp.take_along_plain(t["x"], t["idx"], 0, -1)),
        ("b dyn-row store while", "row_store_loop",
         lambda t: ip.row_store_loop(24, t["x"].shape[1], dev),
         lambda t: ip.row_store_loop_plain(24, t["x"].shape[1], dev)),
        ("c vec-cond while", "vec_cond_while", lambda t: ip.vec_cond_while(t["x0"]),
         lambda t: ip.vec_cond_while_plain(t["x0"])),
        ("d fetch3 straddle", "fetch_rows", lambda t: ip.fetch_rows(t["words"], t["j"], 3),
         lambda t: ip.fetch_rows_plain(t["words"], t["j"], 3)),
        ("e while+gather+store", "gather_store_loop",
         lambda t: ip.gather_store_loop(t["words"], t["j"], 16),
         lambda t: ip.gather_store_loop_plain(t["words"], t["j"], 16)),
    )
    for name, kernel, fn, plain in lines:
        calls = {k: (lambda t=t: fn(t), lambda t=t: plain(t)) for k, t in by_lanes.items()}
        tools.held(name, calls, dev, args.reps, kernel=kernel)


if __name__ == "__main__":
    main(sys.argv[1:])
