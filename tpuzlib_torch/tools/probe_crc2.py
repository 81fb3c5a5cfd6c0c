"""CRC-32 probe 2: the read floor, the bit unpack and the product alone.

Counterpart of tools/probe_crc2.py.  Lines, under the tool's names:

  read2d                    the two-level torch.sum (int32 row sums of
                            1 KiB rows, then their sum; a library line);
  pallas read+rowsum        the crc_rowsum kernel over 1 KiB rows, checked
                            against torch's row sums;
  pallas unpack u8|i32|bf16 the crc_unpack kernel in each mode, checked:
                            the three modes give the same bit counts;
  matmul-only (8MB data)    gf2_bits_mm on the first 8 MiB (or --mib, if
                            less) unpacked to bf16 bits beforehand, checked
                            against crc_forms_mm's columns of the same
                            bytes; GB/s counts the data bytes, as the tool.

A mismatch raises.  What has no counterpart:
  floor_time    XLA's dispatch floor, taken off each loop: CUDA events time the launches.
  loop_time     XLA's fori_loop timing: the calls run back to back between two events.
  copyonly      the cost of the loop's at[0].set carry copy, which no timing here makes.

    python -m tpuzlib_torch.tools.probe_crc2 [--device cuda|cpu] [--mib 64] [--reps 20]
"""

from __future__ import annotations

import sys

import torch

from .. import tools
from ..kernels import crc32_probe

MM_MIB = 8  # MiB of data for matmul-only


def main(argv=None) -> None:
    args, dev, host, d = tools.start(argv, __doc__)
    n = host.size
    rows = d.view(-1, 1024)
    ms = tools.time_ms(lambda: torch.sum(torch.sum(rows, 1, dtype=torch.int32),
                                         dtype=torch.int64), dev, args.reps)
    tools.report("read2d", ms, n, impl="torch.sum")

    if not torch.equal(crc32_probe.crc_rowsum(rows), rows.sum(1, dtype=torch.int32)):
        raise RuntimeError("pallas read+rowsum: crc_rowsum differs from torch's row sums")
    ms = tools.time_ms(lambda: crc32_probe.crc_rowsum(rows), dev, args.reps)
    tools.report("pallas read+rowsum", ms, n, kernel="crc_rowsum")

    counts = None
    for mode in crc32_probe.MODES:
        got = crc32_probe.crc_unpack(rows, mode)
        if counts is not None and not torch.equal(got, counts):
            raise RuntimeError("pallas unpack %s: bit counts differ from mode u8" % mode)
        counts = got
        ms = tools.time_ms(lambda: crc32_probe.crc_unpack(rows, mode), dev, args.reps)
        tools.report("pallas unpack %s" % mode, ms, n, kernel="crc_unpack", mode=mode)

    small = rows[: (min(MM_MIB, args.mib) << 20) // 1024]
    bits = crc32_probe.plane_bits(small)
    m = crc32_probe.form_matrix(1024, torch.bfloat16, dev)
    if not torch.equal(crc32_probe.gf2_bits_mm(bits, m), crc32_probe.crc_forms_mm(small)):
        raise RuntimeError("matmul-only: gf2_bits_mm differs from crc_forms_mm on the same bytes")
    ms = tools.time_ms(lambda: crc32_probe.gf2_bits_mm(bits, m), dev, args.reps)
    tools.report("matmul-only (8MB data)", ms, small.numel(), kernel="gf2_bits_mm")


if __name__ == "__main__":
    main(sys.argv[1:])
