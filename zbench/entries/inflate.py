"""inflate(): the client decodes a pool of streams in turn, one call after
another.  The streams are zlib's compression (in set-up) at the
configuration's level and container of the configuration's data
(entries.blend), its pieces in another order in each stream (traffic
"pool" streams): whether the device route takes a stream or declines it
to the host engine turns on its bits, and a pool spreads that over a run.

A sample of the outputs drawn from the seed (traffic "keep_share", and
always each stream's first) is kept and compared byte for byte with its
piece after the window; the rest are dropped as a loader drops them, so
the allocator sees what it sees in use.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import blend
from ..reference import zlib_ref


def program(api, config: dict, device):
    def call(stream):
        return api.inflate(stream, device=device)

    return call


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        pieces = blend(config["data"], traffic["piece_bytes"], seed)
        rng = np.random.default_rng([seed, 1])
        orders = [np.arange(len(pieces))] + [rng.permutation(len(pieces))
                                             for _ in range(traffic["pool"] - 1)]
        self.pieces = [np.concatenate([pieces[i] for i in order]) for order in orders]
        with ThreadPoolExecutor(len(self.pieces)) as pool:  # zlib lets go of the GIL
            self.streams = [np.frombuffer(z, np.uint8) for z in
                            pool.map(lambda p: zlib_ref.compress(p, config), self.pieces)]
        self.keep = rng
        self.share = traffic["keep_share"]
        self.calls = 0
        self.outputs = []  # (stream, output)

    def warm(self, fn) -> None:
        for stream in self.streams:
            fn(stream)

    def call(self, fn) -> tuple[int, int]:
        k = self.calls % len(self.streams)
        out = fn(self.streams[k])
        if self.calls < len(self.streams) or self.keep.random() < self.share:
            self.outputs.append((k, out))
        self.calls += 1
        return len(self.streams[k]), len(out)


def check(config: dict, traffic: dict, d: Driver) -> tuple[dict, dict]:
    bad = sum(not zlib_ref.equal(out, d.pieces[k]) for k, out in d.outputs)
    return {"bad_outputs": (bad, 0)}, {"outputs_checked": len(d.outputs)}
