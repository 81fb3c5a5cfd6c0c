"""Pass 3 of the two-pass inflate on the host: token tape -> bytes.

Counterpart of tpuzlib/codec/expand.py's `expand_host`, which is its
`_expand_native`: the native serial expander (native/ tz_expand_tokens),
called the same way; the port has no numpy expander.  `expand_segments`
is the port's own: the speculative inflate's tapes expanded a segment a
thread (native/ tz_expand_segments), the same bytes as `expand_host` of
the joined tapes.  The device expansion, pointer doubling in torch, is
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


def tape_out_len(litlen: np.ndarray, dist: np.ndarray) -> int:
    """The bytes a token tape expands to (a literal 1, a match its
    length); native, so threads count tapes at once."""
    return int(bindings.lib().tz_tape_out_len(bindings.ptr(litlen), bindings.ptr(dist),
                                              len(litlen)))


def expand_segments(tapes, window: np.ndarray, threads: int) -> np.ndarray:
    """expand_host of the tapes joined, without joining them: `tapes` are
    (litlen, dist, out_len) of consecutive pieces of one stream (int32,
    C-contiguous, out_len from tape_out_len).  Each piece expands on one
    of `threads` threads with the 32 KiB before it left as markers, the
    windows then resolve in order and the pieces narrow to bytes in
    parallel.  Raises DataError when a distance reaches before the
    window."""
    lens = np.array([t[2] for t in tapes], np.int64)
    lit_ptrs = np.array([bindings.ptr(t[0]) for t in tapes], np.int64)
    dist_ptrs = np.array([bindings.ptr(t[1]) for t in tapes], np.int64)
    ntok = np.array([len(t[0]) for t in tapes], np.int64)
    window = np.ascontiguousarray(window, dtype=np.uint8)
    dst = np.empty(int(lens.sum()), np.uint8)
    out = bindings.lib().tz_expand_segments(
        len(tapes), bindings.ptr(lit_ptrs), bindings.ptr(dist_ptrs), bindings.ptr(ntok),
        bindings.ptr(lens), bindings.ptr(window), len(window), bindings.ptr(dst), threads)
    if out == -2:
        raise DataError("invalid distance too far back")
    return dst
