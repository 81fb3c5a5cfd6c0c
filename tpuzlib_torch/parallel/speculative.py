"""Block-header discovery and whole-block tokenization on the host.

Counterpart of tpuzlib/parallel/speculative.py's `find_all_block_starts`
and `_tokenize_range` (lines 205-254, 284-348), through the native host
library only (native/bindings.py): the device inflate's block planner
reads the header scan, and its open-end tail the range tokenizer.
"""

from __future__ import annotations

import numpy as np

from ..codec.tokenize import DataError
from ..native import bindings


def find_all_block_starts(buf: np.ndarray, from_bit: int = 0, allow_final: bool = True) -> list:
    """Bit positions of every confirmed dynamic-block header from
    `from_bit` on: a bit scan with a Kraft prefilter, each candidate
    confirmed by a bounded decode (tz_find_headers)."""
    lib = bindings.lib()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    cap = 4096
    while True:
        pos = np.empty(cap, np.int64)
        n = lib.tz_find_headers(bindings.ptr(buf), len(buf), from_bit, 1 if allow_final else 0,
                                bindings.ptr(pos), cap)
        if n < cap:
            return pos[:n].tolist()
        cap *= 8


def _tokenize_range(buf: np.ndarray, start_bit: int, stop_bit: int):
    """Tokenize blocks from start_bit until a block ends at/after stop_bit
    (or the stream's final block).  Returns (litlen, dist, end_bit,
    finished); raises DataError on malformed or truncated data."""
    lib = bindings.lib()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    # tokens rarely exceed ~0.6 per compressed byte; grow on overflow
    cap = max(1 << 16, max(1, (stop_bit - start_bit) // 8))
    while True:
        litlen = np.empty(cap, np.int32)
        dist = np.empty(cap, np.int32)
        end_bit, finished, status = bindings.out_scalars(np.int64, np.int32, np.int32)
        ntok = lib.tz_inflate_tokenize(
            bindings.ptr(buf), len(buf), start_bit, stop_bit, bindings.ptr(litlen),
            bindings.ptr(dist), cap, bindings.ptr(end_bit), bindings.ptr(finished),
            bindings.ptr(status))
        if status[0] == 3:
            cap *= 4
            continue
        if status[0] != 0:
            raise DataError("invalid compressed data")
        return litlen[:ntok].copy(), dist[:ntok].copy(), int(end_bit[0]), bool(finished[0])
