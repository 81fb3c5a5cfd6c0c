"""Pass 3 of the two-pass inflate on the host: token tape -> bytes.

Counterpart of tpuzlib/codec/expand.py.  `expand_host` calls the native
serial expander (native/ tz_expand_tokens) as tpuzlib's `_expand_native`
does; with the native library switched off it runs tpuzlib's numpy
expansion: every output byte points at its immediate source (literals
and window bytes are roots; a copy byte points dist back, a
self-overlapping copy rewritten mod dist to point before its own token),
and pointer doubling resolves each byte to its root in O(log n) gather
rounds.  `expand_segments` is the port's own: the speculative inflate's
tapes expanded a segment a thread (native/ tz_expand_segments), the same
bytes as `expand_host` of the joined tapes; tpuzlib has no numpy twin of
it, so with the library off it expands the tapes one after another
through `expand_host`, each against the 32 KiB before it, with the same
bytes.  The device expansion, pointer doubling in torch, is
kernels/inflate_device2.make_expand_v2.
"""

from __future__ import annotations

import numpy as np

from ..native import bindings
from .tokenize import DataError

WINDOW = 1 << 15


def _expand_native(lib, litlen: np.ndarray, dist: np.ndarray, window: np.ndarray) -> np.ndarray:
    litlen = np.ascontiguousarray(litlen, dtype=np.int32)
    dist = np.ascontiguousarray(dist, dtype=np.int32)
    total = int(np.where(dist > 0, litlen, 1).sum())
    wlen = len(window)
    dst = np.empty(wlen + total, dtype=np.uint8)
    dst[:wlen] = window
    out = lib.tz_expand_tokens(bindings.ptr(litlen), bindings.ptr(dist), len(litlen),
                               bindings.ptr(dst), len(dst), wlen)
    if out == -2:
        raise DataError("invalid distance too far back")
    if out < 0:
        raise RuntimeError("tz_expand_tokens overflowed a buffer sized from its own tape")
    return dst[wlen : wlen + out]


def expand_host(litlen: np.ndarray, dist: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Expand a token tape against a history window; returns the new bytes.

    litlen: literal byte (dist == 0) or match length; dist: 0 or the match
    distance.  window: previous output or dictionary (up to 32 KiB), index
    -1 the byte just before the first output byte.  Raises DataError when
    a distance reaches before the window."""
    ntok = len(litlen)
    if ntok == 0:
        return np.empty(0, dtype=np.uint8)
    lib = bindings.get_lib()
    if lib is not None:
        return _expand_native(lib, litlen, dist, window)
    is_copy = dist > 0
    out_lens = np.where(is_copy, litlen, 1).astype(np.int64)
    starts = np.zeros(ntok + 1, dtype=np.int64)
    np.cumsum(out_lens, out=starts[1:])
    total = int(starts[-1])
    wlen = len(window)

    # no copies at all (stored blocks, incompressible data)
    if not is_copy.any():
        return litlen.astype(np.uint8)

    tok_id = np.repeat(np.arange(ntok, dtype=np.int64), out_lens)
    j = np.arange(total, dtype=np.int64) - starts[tok_id]
    d = dist[tok_id].astype(np.int64)
    tok_start = starts[tok_id]

    # index space: [0, wlen) the window's bytes, [wlen, wlen + total) the
    # output; a copy byte's immediate source lies before its own token
    src = tok_start - d + np.where(d > 0, j % np.maximum(d, 1), 0)
    copy_byte = d > 0
    if int((src + wlen).min() if copy_byte.any() else 0) < 0:
        if ((src < -wlen) & copy_byte).any():
            raise DataError("invalid distance too far back")

    ptr = np.arange(wlen + total, dtype=np.int64)
    ptr[wlen:] = np.where(copy_byte, src + wlen, ptr[wlen:])

    vals = np.empty(wlen + total, dtype=np.uint8)
    vals[:wlen] = window
    np.putmask(vals[wlen:], ~copy_byte, litlen[tok_id].astype(np.uint8))

    # pointer doubling to the roots
    span = 1
    while span < wlen + total:
        nxt = ptr[ptr]
        if np.array_equal(nxt, ptr):
            break
        ptr = nxt
        span <<= 1
    return vals[ptr[wlen:]]


def tape_out_len(litlen: np.ndarray, dist: np.ndarray) -> int:
    """The bytes a token tape expands to (a literal 1, a match its
    length); native, so threads count tapes at once."""
    lib = bindings.get_lib()
    if lib is None:
        return int(np.where(dist > 0, litlen, 1).sum())
    return int(lib.tz_tape_out_len(bindings.ptr(litlen), bindings.ptr(dist), len(litlen)))


def expand_segments(tapes, window: np.ndarray, threads: int) -> np.ndarray:
    """expand_host of the tapes joined, without joining them: `tapes` are
    (litlen, dist, out_len) of consecutive pieces of one stream (int32,
    C-contiguous, out_len from tape_out_len).  Each piece expands on one
    of `threads` threads with the 32 KiB before it left as markers, the
    windows then resolve in order and the pieces narrow to bytes in
    parallel.  With the native library off the pieces expand in order
    through expand_host, each against the 32 KiB before it.  Raises
    DataError when a distance reaches before the window."""
    lens = np.array([t[2] for t in tapes], np.int64)
    window = np.ascontiguousarray(window, dtype=np.uint8)
    dst = np.empty(int(lens.sum()), np.uint8)
    lib = bindings.get_lib()
    if lib is None:
        at = 0
        for (litlen, dist, _), end in zip(tapes, np.cumsum(lens).tolist()):
            history = dst[max(0, at - WINDOW) : at]
            if at < WINDOW:
                history = np.concatenate([window, history])[-WINDOW:]
            dst[at:end] = expand_host(litlen, dist, history)
            at = end
        return dst
    lit_ptrs = np.array([bindings.ptr(t[0]) for t in tapes], np.int64)
    dist_ptrs = np.array([bindings.ptr(t[1]) for t in tapes], np.int64)
    ntok = np.array([len(t[0]) for t in tapes], np.int64)
    out = lib.tz_expand_segments(
        len(tapes), bindings.ptr(lit_ptrs), bindings.ptr(dist_ptrs), bindings.ptr(ntok),
        bindings.ptr(lens), bindings.ptr(window), len(window), bindings.ptr(dst), threads)
    if out == -2:
        raise DataError("invalid distance too far back")
    return dst
