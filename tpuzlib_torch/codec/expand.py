"""Pass 3 of the two-pass inflate on the host: token tape -> bytes.

Counterpart of tpuzlib/codec/expand.py's `expand_host`, through the
native serial expander (native/ tz_expand_tokens) only.  The device
expansion, pointer doubling in torch, is
kernels/inflate_device2.make_expand_v2.
"""

from __future__ import annotations

import numpy as np

from ..native import bindings
from .tokenize import DataError


def expand_host(litlen: np.ndarray, dist: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Expand a token tape against a history window; returns the new bytes.

    litlen: literal byte (dist == 0) or match length; dist: 0 or the match
    distance.  window: previous output or dictionary (up to 32 KiB), index
    -1 the byte just before the first output byte.  Raises DataError when
    a distance reaches before the window."""
    if len(litlen) == 0:
        return np.empty(0, dtype=np.uint8)
    litlen = np.ascontiguousarray(litlen, dtype=np.int32)
    dist = np.ascontiguousarray(dist, dtype=np.int32)
    total = int(np.where(dist > 0, litlen, 1).sum())
    wlen = len(window)
    dst = np.empty(wlen + total, dtype=np.uint8)
    dst[:wlen] = window
    out = bindings.lib().tz_expand_tokens(bindings.ptr(litlen), bindings.ptr(dist), len(litlen),
                                          bindings.ptr(dst), len(dst), wlen)
    if out == -2:
        raise DataError("invalid distance too far back")
    if out < 0:
        raise RuntimeError("tz_expand_tokens overflowed a buffer sized from its own tape")
    return dst[wlen : wlen + out]
