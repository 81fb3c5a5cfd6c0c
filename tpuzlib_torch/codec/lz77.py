"""Vectorized LZ77 match search and greedy-lazy parse on the host (numpy).

Counterpart of tpuzlib/codec/lz77.py, the host deflate engine's
tokenizer when the native library is switched off
(native/bindings.set_native).  tpuzlib's `tokenize_chunk` dispatches to
its native matcher while its library loads; the port's has no such
branch, since the engine calls it only with the library off and calls
the native matcher itself otherwise.  The search:

 1. hash every position (multiplicative hash of the next 3/4/6/8 bytes);
 2. recover the K most recent same-bucket predecessors of every position
    with one stable sort (sorted by (bucket, position), the k-th previous
    occurrence in a bucket is the k-th previous row): a hash chain walked
    K deep, in parallel;
 3. screen the candidates with 8-byte window compares, extend the best
    two in full, and keep the longer (a tie: the closer);
 4. apply zlib's lazy rule locally (defer a match when the next
    position's match is longer) and mark the token starts by pointer
    doubling: the decisions of the serial greedy-lazy walk.

The 64-bit hash wraps modulo 2^64, which numpy's uint64 does; it stays in
numpy, since torch has no uint64 shifts on the CPU.  LEVELS (each level's
probes and lazy rule) and TOO_FAR are codec/tables.py's.
"""

from __future__ import annotations

import numpy as np

from .tables import LEVELS, MAX_MATCH, MIN_MATCH, TOO_FAR, WINDOW_SIZE, LevelParams
from .tokenize import byte_windows64

_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)


def _hash_positions(w64: np.ndarray, nbytes: int, bits: int) -> np.ndarray:
    """Multiplicative hash of the next `nbytes` bytes at every position."""
    if nbytes >= 8:
        v = w64
    else:
        v = w64 & ((np.uint64(1) << np.uint64(8 * nbytes)) - np.uint64(1))
    return ((v * _HASH_MULT) >> np.uint64(64 - bits)).astype(np.uint32)


def _candidates_from_sort(h: np.ndarray, k: int) -> np.ndarray:
    """(n, k) array: the k most recent earlier positions with equal hash
    (-1 where none).  One stable sort replaces per-position chain walks."""
    n = len(h)
    order = np.argsort(h, kind="stable").astype(np.int32)
    sh = h[order]
    cands = np.full((n, k), -1, dtype=np.int32)
    for j in range(1, k + 1):
        same = sh[j:] == sh[:-j]
        src = order[:-j]
        dst = order[j:]
        cands[dst[same], j - 1] = src[same]
    return cands


def _prefix_len_u64(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Common-prefix byte count (0..8) of two u64 little-endian windows."""
    v = x ^ y
    plen = np.zeros(len(v), dtype=np.int32)
    alive = np.ones(len(v), dtype=bool)
    for j in range(8):
        b = (v >> np.uint64(8 * j)) & np.uint64(0xFF)
        alive = alive & (b == 0)
        plen += alive
    return plen


def _extend_matches(data: np.ndarray, w64: np.ndarray, pos: np.ndarray, cand: np.ndarray,
                    limit: np.ndarray) -> np.ndarray:
    """Exact match lengths for (pos, cand) pairs, capped by `limit`."""
    n = len(pos)
    length = np.zeros(n, dtype=np.int32)
    active = cand >= 0
    offset = np.zeros(n, dtype=np.int32)
    while active.any():
        ai = np.flatnonzero(active)
        p = pos[ai] + offset[ai]
        c = cand[ai] + offset[ai]
        pl = _prefix_len_u64(w64[p], w64[c])
        pl = np.minimum(pl, limit[ai] - offset[ai])
        length[ai] = offset[ai] + pl
        cont = (pl == 8) & (offset[ai] + 8 < limit[ai])
        offset[ai] += 8
        nxt = np.zeros(n, dtype=bool)
        nxt[ai[cont]] = True
        active = nxt
    return np.minimum(length, limit)


def find_matches(data: np.ndarray, ctx_len: int,
                 params: LevelParams) -> tuple[np.ndarray, np.ndarray]:
    """Best (length, distance) per position of data[ctx_len:].

    data = [window context | new bytes]; matches may start inside the
    context (a preset dictionary, or the 32 KiB before a chunk)."""
    n = len(data)
    nnew = n - ctx_len
    if nnew <= 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    w64 = byte_windows64(data)
    pos = np.arange(ctx_len, n, dtype=np.int32)
    limit = np.minimum(n - pos, MAX_MATCH).astype(np.int32)

    best_cand = np.full(nnew, -1, dtype=np.int32)
    second_cand = np.full(nnew, -1, dtype=np.int32)
    best_screen = np.zeros(nnew, dtype=np.int32)

    for hash_bytes, k in params.probes:
        bits = 16 if hash_bytes == 4 else 18
        h = _hash_positions(w64, hash_bytes, bits)
        cands = _candidates_from_sort(h, k)[ctx_len:]
        for j in range(cands.shape[1]):
            c = cands[:, j]
            ok = (c >= 0) & (pos - c <= WINDOW_SIZE)
            cc = np.where(ok, c, 0)
            screen = _prefix_len_u64(w64[pos], w64[cc])
            screen = np.where(ok, np.minimum(screen, limit), -1)
            better = screen > best_screen
            # keep the displaced best as runner-up
            second_cand = np.where(better, best_cand, second_cand)
            best_cand = np.where(better, cc, best_cand)
            best_screen = np.where(better, screen, best_screen)

    # extend the best and the runner-up in full, keep the longer (a tie:
    # the closer)
    len1 = _extend_matches(data, w64, pos, best_cand, limit)
    len2 = _extend_matches(data, w64, pos, second_cand, limit)
    use2 = len2 > len1
    cand = np.where(use2, second_cand, best_cand)
    length = np.where(use2, len2, len1)
    dist = np.where(cand >= 0, pos - cand, 0).astype(np.int32)

    # legal and worth its bits
    length = np.where(length >= MIN_MATCH, length, 0)
    length = np.where((length == MIN_MATCH) & (dist > TOO_FAR), 0, length)
    length = np.where(dist > 0, length, 0)
    return length.astype(np.int32), dist


def lazy_parse(length: np.ndarray, dist: np.ndarray, params: LevelParams):
    """The greedy(-lazy) parse: returns (token starts, take-match, the
    effective match lengths), boolean, boolean and int32 per position.

    zlib's deflate_fast / deflate_slow decisions: at a match position,
    deflate_slow emits a literal instead when the next position holds a
    strictly longer match (unless the current one is max_lazy or
    longer)."""
    n = len(length)
    eff = length.copy()
    if params.lazy and n > 1:
        nxt_len = np.concatenate([length[1:], np.zeros(1, np.int32)])
        defer = (eff >= MIN_MATCH) & (eff < params.max_lazy) & (nxt_len > eff)
        eff = np.where(defer, 0, eff)
    step = np.where(eff >= MIN_MATCH, eff, 1).astype(np.int64)

    # a pointer-doubling walk from position 0 marks the token starts
    nxt = np.minimum(np.arange(n, dtype=np.int64) + step, n)
    J = np.concatenate([nxt, [np.int64(n)]])
    reach = np.zeros(n + 1, dtype=bool)
    reach[0] = True
    Jk = J
    steps = 1
    while steps < n + 1:
        newly = Jk[np.flatnonzero(reach)]
        before = reach[newly]
        reach[newly] = True
        if not (~before).any():
            break
        Jk = Jk[Jk]
        steps <<= 1
    starts = reach[:n]
    take_match = starts & (eff >= MIN_MATCH)
    return starts, take_match, eff


def tokenize_chunk(data: np.ndarray, ctx_len: int, level: int) -> tuple[np.ndarray, np.ndarray]:
    """A chunk's token tape (litlen, dist) with zlib's semantics, by the
    vectorized search above; data[:ctx_len] is context only."""
    params = LEVELS[level]
    length, dist = find_matches(data, ctx_len, params)
    if len(length) == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    starts, take_match, eff = lazy_parse(length, dist, params)
    idx = np.flatnonzero(starts)
    lit_vals = data[ctx_len:][idx].astype(np.int32)
    tm = take_match[idx]
    litlen = np.where(tm, eff[idx], lit_vals)
    dists = np.where(tm, dist[idx], 0)
    return litlen.astype(np.int32), dists.astype(np.int32)
