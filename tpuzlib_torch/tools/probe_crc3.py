"""CRC-32 probe 3: the bf16 forms, the public CRC and Adler-32.

Counterpart of tools/probe_crc3.py.  Lines, under the tool's names:

  forms(copy-free) B<B> T<tile>   crc_forms_mm in bf16 (the tool's plane
                                  kernel), B bytes a block, `tile` blocks
                                  a CUDA block; its forms are combined on
                                  the host and checked against zlib;
  full crc (copy-free)            the port's crc32_device, checked against
                                  zlib;
  adler                           the port's adler32_device, checked
                                  against zlib (the tool's "adler HOISTABLE
                                  lower-bound": nothing is hoisted here).

A mismatch raises.  What has no counterpart:
  floor_time          XLA's dispatch floor, taken off each loop: CUDA events time the launches.
  loop_time_seeded    XLA's fori_loop timing: the calls run back to back between two events.
  mix                 the (8, 128) input that kept XLA from hoisting the kernel out of its loop.
  combine in the jit  "full crc" combined its forms on the TPU; crc32_device combines on the host.
  adler sig           the tool printed adler32_device_jit's signature.

    python -m tpuzlib_torch.tools.probe_crc3 [--device cuda|cpu] [--mib 64] [--reps 20]
"""

from __future__ import annotations

import sys
import zlib

from .. import tools
from ..kernels import adler32, crc32, crc32_probe

PAIRS = ((1024, 256), (4096, 256), (1024, 1024))  # (B, tile)


def main(argv=None) -> None:
    args, dev, host, d = tools.start(argv, __doc__)
    n, want = host.size, zlib.crc32(host)
    for block, tile in PAIRS:
        blocks = d.view(-1, block)
        name = "forms(copy-free) B%d T%d" % (block, tile)
        tools.check(name, tools.forms_crc(crc32_probe.crc_forms_mm(blocks, "bf16", tile), block, n),
                    want)
        ms = tools.time_ms(lambda: crc32_probe.crc_forms_mm(blocks, "bf16", tile), dev, args.reps)
        tools.report(name, ms, n, kernel="crc_forms_mm", dtype="bf16")

    tools.check("full crc (copy-free)", crc32.crc32_device(d), want)
    ms = tools.time_ms(lambda: crc32.crc32_device(d), dev, args.reps)
    tools.report("full crc (copy-free)", ms, n, impl="crc32_device")

    if adler32.adler32_device(d) != zlib.adler32(host):
        raise RuntimeError("adler: adler32_device differs from zlib")
    ms = tools.time_ms(lambda: adler32.adler32_device(d), dev, args.reps)
    tools.report("adler", ms, n, impl="adler32_device")


if __name__ == "__main__":
    main(sys.argv[1:])
