"""crc32() of records that lie on the card: the client checksums a pool
of 1-D uint8 tensors (traffic "record_bytes" each, "pool" of them, made
on the device from the seed), one record after another in turn, so that
the L2 never holds the next one.  Each call returns its int, as a caller
reads it.

Every value is kept and compared with zlib's CRC-32 of a host copy of
its record after the window.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import zlib_ref


def program(api, config: dict, device):
    def call(record):
        return api.crc32(record)

    return call


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence(seed).generate_state(1, np.uint64)[0] >> 1))
        n = traffic["record_bytes"]
        self.pool = [torch.randint(0, 256, (n,), dtype=torch.uint8, device=device, generator=g)
                     for _ in range(traffic["pool"])]
        self.calls = 0
        self.values = []  # (record, value)

    def warm(self, fn) -> None:
        fn(self.pool[0])

    def call(self, fn) -> tuple[int, int]:
        k = self.calls % len(self.pool)
        self.calls += 1
        self.values.append((k, fn(self.pool[k])))
        return self.pool[k].numel(), 4


def check(config: dict, traffic: dict, d: Driver) -> tuple[dict, dict]:
    want = [zlib_ref.crc32(t.cpu().numpy()) for t in d.pool]
    bad = sum(v != want[k] for k, v in d.values)
    return {"bad_outputs": (bad, 0)}, {"outputs_checked": len(d.values)}
