"""Inflate primitive probe 2: column reductions, variable shifts, and the
decode's tree decode, table lookup and window assembly on real tables.

Counterpart of tools/probe_inflate_prims2.py.  The tool held each Pallas
kernel on the chip to the same kernel in interpret mode; here each CUDA
kernel is held to its plain version, at the tool's 128 lanes (the tool's
arrays: numpy's default_rng(1), drawn in the tool's order) and at 8,192
(the same draws from default_rng(8192)).  Lines, under the tool's names,
each MATCH with ms at both lane counts:

  f sublane min/sum          col_min_sum on (16, lanes);
  g variable shifts          var_shifts: r >> (16 - L) for L < 16, and the
                             mask (1 << e) - 1;
  h tree_decode fixed-lit    tree_decode on the fixed lit/len code's
                             tables (inflate_cuda.canon_tables), one
                             column a lane;
  i lookup 288               table_lookup: the clipped rank's entry of the
                             (288, lanes) entry table (take_along, axis 0);
  j window assembly          window64: the 64-bit window at a bit shift of
                             three words, and its re-window.

A difference prints DIVERGE and the first differing positions, an error
FAIL, and the probe raises.  What has no counterpart: interpret mode (the
plain versions are the oracle), enable_compile_cache, and k_i's
where-chain over 8-row tiles, a TPU workaround (each lane loads its
entry).

    python -m tpuzlib_torch.tools.probe_inflate_prims2 [--device cuda|cpu] [--reps 20]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import tools
from ..codec.tables import FIXED_LITLEN_LENGTHS
from ..kernels import inflate_cuda, inflate_prims as ip
from .probe_inflate_prims import u32

LANES = ((128, 1), (8192, 8192))  # (lanes, seed): the tool's, then G1's Kpad


def arrays(rng, lanes: int) -> dict:
    """The tool's inputs at `lanes`, in its order of draws."""
    ents, cnt16, first16, off16 = inflate_cuda.canon_tables(FIXED_LITLEN_LENGTHS, "litlen")
    tile = lambda v: np.ascontiguousarray(np.tile(v[:, None], (1, lanes)))  # noqa: E731
    a = {"x": rng.integers(0, 1000, (16, lanes), dtype=np.int32)}
    a["rv"] = rng.integers(0, 1 << 16, (1, lanes), dtype=np.int32)
    a["eb"] = rng.integers(0, 14, (1, lanes), dtype=np.int32)
    a.update(cnt=tile(cnt16), first=tile(first16), off=tile(off16), w=u32(rng, (1, lanes)))
    a["etab"] = tile(ents).view(np.int32)
    a["rank"] = rng.integers(0, 286, (1, lanes), dtype=np.int32)
    for k in ("wa", "wb", "wc"):
        a[k] = u32(rng, (1, lanes))
    a["sh"] = rng.integers(0, 32, (1, lanes), dtype=np.int32)
    a["o"] = rng.integers(0, 21, (1, lanes), dtype=np.int32)
    return a


def main(argv=None) -> None:
    args, dev = tools.begin(argv, __doc__)
    by_lanes = {}
    for lanes, seed in LANES:
        a = arrays(np.random.default_rng(seed), lanes)
        by_lanes[str(lanes)] = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
    win = ("wa", "wb", "wc", "sh", "o")
    tree = ("w", "cnt", "first", "off")
    lines = (
        ("f sublane min/sum", "col_min_sum", lambda t: ip.col_min_sum(t["x"]),
         lambda t: ip.col_min_sum_plain(t["x"])),
        ("g variable shifts", "var_shifts", lambda t: ip.var_shifts(t["rv"], t["eb"]),
         lambda t: ip.var_shifts_plain(t["rv"], t["eb"])),
        ("h tree_decode fixed-lit", "tree_decode", lambda t: ip.tree_decode(*(t[k] for k in tree)),
         lambda t: ip.tree_decode_plain(*(t[k] for k in tree))),
        ("i lookup 288", "take_along", lambda t: ip.table_lookup(t["etab"], t["rank"]),
         lambda t: ip.table_lookup_plain(t["etab"], t["rank"])),
        ("j window assembly", "window64", lambda t: ip.window64(*(t[k] for k in win)),
         lambda t: ip.window64_plain(*(t[k] for k in win))),
    )
    for name, kernel, fn, plain in lines:
        calls = {k: (lambda t=t: fn(t), lambda t=t: plain(t)) for k, t in by_lanes.items()}
        tools.held(name, calls, dev, args.reps, kernel=kernel)


if __name__ == "__main__":
    main(sys.argv[1:])
