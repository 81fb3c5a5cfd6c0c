"""deflate(): the client compresses its seeded piece of the
configuration's data (entries.blend), held in host memory as np.uint8,
one call after another, at the configuration's level and container.

Every output is kept (a few MB each) and decoded by zlib after the
window; the port's bytes of each piece over zlib's bytes of it at the
same settings give the size ratio.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import blend
from ..reference import zlib_ref


def program(api, config: dict, device):
    level, container = config["level"], config["container"]

    def call(piece):
        return api.deflate(piece, level=level, format=container, device=device)

    return call


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.piece = np.concatenate(blend(config["data"], traffic["piece_bytes"], seed))
        self.outputs = []

    def warm(self, fn) -> None:
        fn(self.piece)

    def call(self, fn) -> tuple[int, int]:
        out = fn(self.piece)
        self.outputs.append(out)
        return len(self.piece), len(out)


def check(config: dict, traffic: dict, d: Driver) -> tuple[dict, dict]:
    """Every output must be one whole stream of the container that zlib
    decodes to the piece; the size ratio takes the piece once."""
    with ThreadPoolExecutor(4) as pool:  # zlib lets go of the GIL
        ok = list(pool.map(lambda out: zlib_ref.decodes_to(out, config, d.piece), d.outputs))
    sizes = {"outputs_checked": len(d.outputs)}
    if d.outputs:
        sizes.update(port_bytes=len(d.outputs[0]), zlib_bytes=len(zlib_ref.compress(d.piece, config)))
    return {"bad_outputs": (ok.count(False), 0)}, sizes
