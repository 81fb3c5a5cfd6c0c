"""CRC-32 probe: the read floor, the public CRC and the tensor-core forms.

Counterpart of tools/probe_crc.py.  Lines, under the tool's names:

  read+sum                  torch.sum of the bytes (impl "torch.sum", a
                            library call) and the crc_rowsum kernel over
                            1 KiB rows (impl "crc_rowsum");
  full (r4 baseline)        the port's crc32_device, checked against zlib;
  forms MODE B<B> T<tile>   crc_forms_mm in MODE's dtype, B bytes a block,
                            `tile` blocks a CUDA block; its forms are
                            combined on the host and checked against zlib.
                            plane_* and cat_* are one kernel on the card:
                            one measurement, printed under both names.

A mismatch raises.  What has no counterpart:
  floor_time    XLA's dispatch floor, taken off each loop: CUDA events time the launches.
  loop_time     XLA's fori_loop timing: the calls run back to back between two events.
  at[0].set     the carry copy each timed pass made, an artifact (tools/probe_crc3.py:3-9).
  [BAD], try    the tool tagged a wrong CRC and printed errors; here both raise.

    python -m tpuzlib_torch.tools.probe_crc [--device cuda|cpu] [--mib 64] [--reps 20]
"""

from __future__ import annotations

import sys
import zlib

import torch

from .. import tools
from ..kernels import crc32, crc32_probe

MODES = ("plane_bf16", "plane_i8", "cat_bf16", "cat_i8")
PAIRS = ((1024, 256), (4096, 256), (4096, 512))  # (B, tile)


def main(argv=None) -> None:
    args, dev, host, d = tools.start(argv, __doc__)
    n, want = host.size, zlib.crc32(host)
    ms = tools.time_ms(lambda: torch.sum(d, dtype=torch.int64), dev, args.reps)
    tools.report("read+sum", ms, n, impl="torch.sum")
    rows = d.view(-1, 1024)
    ms = tools.time_ms(lambda: crc32_probe.crc_rowsum(rows), dev, args.reps)
    tools.report("read+sum", ms, n, impl="crc_rowsum")

    tools.check("full (r4 baseline)", crc32.crc32_device(d), want)
    ms = tools.time_ms(lambda: crc32.crc32_device(d), dev, args.reps)
    tools.report("full (r4 baseline)", ms, n, impl="crc32_device")

    measured = {}
    for mode in MODES:
        dtype = mode.split("_")[1]
        for block, tile in PAIRS:
            key = (dtype, block, tile)
            if key not in measured:
                blocks = d.view(-1, block)
                cols = crc32_probe.crc_forms_mm(blocks, dtype, tile)
                tools.check("forms %s B%d T%d" % key, tools.forms_crc(cols, block, n), want)
                measured[key] = tools.time_ms(
                    lambda: crc32_probe.crc_forms_mm(blocks, dtype, tile), dev, args.reps)
            tools.report("forms %s B%d T%d" % (mode, block, tile), measured[key], n,
                         kernel="crc_forms_mm", dtype=dtype)


if __name__ == "__main__":
    main(sys.argv[1:])
