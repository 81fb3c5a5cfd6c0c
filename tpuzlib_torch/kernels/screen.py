"""LZ77 match screening for the batched device deflate encoder.

Counterpart of tpuzlib/kernels/screen_pallas.py.  Both screens read the
flat batch's bytes and compare 16-byte little-endian windows: the window
of position q is bytes q..q+15, bytes at or past the end reading as zero
(`window_words` holds it as four int32 word arrays).  A candidate's
packed key is `screen << 16 | (0xFFFF - dist)`, so a longer screen wins,
then a closer distance; 0 where no candidate reaches MIN_MATCH.

On a CUDA tensor each wrapper launches its kernel (csrc/screen.cu); on a
CPU tensor it runs the plain torch version beside it.
"""

from __future__ import annotations

import torch

from ..codec.tables import MIN_MATCH, WINDOW_SIZE
from . import _build
from .deflate_device import _build_w32

MAX_DEPTH = 64  # largest nd / k the kernels take (shared memory per block)


def window_words(data: torch.Tensor):
    """(w0, w1, w2, w3): the int32 words at +0, +4, +8, +12 bytes of every
    position, so that together they hold its 16-byte window."""
    w0 = _build_w32(data)
    n = w0.shape[0]
    return (w0, *(torch.cat([w0[o:], w0.new_zeros(min(o, n))]) for o in (4, 8, 12)))


def _shift(x: torch.Tensor, d: int, fill: int) -> torch.Tensor:
    """y[i] = x[i - d], with `fill` before the start."""
    d = min(d, x.shape[0])
    return torch.cat([x.new_full((d,), fill), x[: x.shape[0] - d]])


def _ctz_bytes(x: torch.Tensor) -> torch.Tensor:
    """Trailing zero BYTES of u32 bit patterns (4 when x == 0)."""
    return torch.where(
        (x & 0xFF) != 0, 0,
        torch.where((x & 0xFF00) != 0, 1,
                    torch.where((x & 0xFF0000) != 0, 2, torch.where(x != 0, 3, 4))),
    )


def _prefix16(a, b) -> torch.Tensor:
    """Common prefix bytes (0..16) of two 16-byte windows given as four
    word arrays each."""
    x0, x1, x2, x3 = (p ^ q for p, q in zip(a, b))
    return torch.where(
        x0 != 0, _ctz_bytes(x0),
        torch.where(x1 != 0, 4 + _ctz_bytes(x1),
                    torch.where(x2 != 0, 8 + _ctz_bytes(x2), 12 + _ctz_bytes(x3))),
    ).to(torch.int32)


def _pack_key(screen, dist):
    return (screen << 16) | (0xFFFF - dist)


def _check(name: str, data: torch.Tensor, depth: int, *ints) -> None:
    """Raise unless `data` is a flat uint8 batch, each of `ints` is a
    (tensor, dtype) of its length on its device, and 1 <= depth <=
    MAX_DEPTH."""
    _build.check_bytes(name, data)
    for t, dtype in ints:
        _build.check_inputs(name, tuple(data.shape), t, dtype=dtype, device=data.device)
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError("%s: depth must be in 1..%d, got %d" % (name, MAX_DEPTH, depth))


def near_screen_plain(data, mincand, lim16, nd: int) -> torch.Tensor:
    ws = window_words(data)
    total = data.shape[0]
    maxd = torch.arange(total, dtype=torch.int32, device=data.device) - mincand
    best = torch.zeros(total, dtype=torch.int32, device=data.device)
    for d in range(1, nd + 1):
        sc = torch.minimum(_prefix16(ws, [_shift(w, d, 0) for w in ws]), lim16)
        ok = (d <= maxd) & (sc >= MIN_MATCH)
        best = torch.maximum(best, torch.where(ok, _pack_key(sc, d), 0))
    return best


def near_screen(data, mincand, lim16, nd: int) -> torch.Tensor:
    """Position-domain near-band screen over the flat (total,) uint8 batch
    `data`, with int32 mincand and lim16 of its length.

    For each position p and d = 1..nd: the common prefix (0..16) of the
    windows at p and p - d, clipped to lim16[p], is a candidate when
    d <= p - mincand[p] and it is >= MIN_MATCH.  Windows before position 0
    are zero.  Returns the best key per position (int32)."""
    if _build.on_cpu(data):
        return near_screen_plain(data, mincand, lim16, nd)
    _check("near_screen", data, nd, (mincand, torch.int32), (lim16, torch.int32))
    total = data.shape[0]
    key = torch.empty(total, dtype=torch.int32, device=data.device)
    if total == 0:
        return key
    _build.launch(
        "near_screen", "tz_near_screen", data.device,
        *(t.data_ptr() for t in (data, mincand, lim16, key)), total, nd,
    )
    return key


def _sorted_windows(sp, data):
    return [w[sp] for w in window_words(data)]


def far_screen_plain(sh, sp, data, best, k: int) -> torch.Tensor:
    ws = _sorted_windows(sp, data)
    pos = sp.to(torch.int32)
    keys = torch.zeros_like(sh)
    for j in range(1, k + 1):
        d = pos - _shift(pos, j, -1)
        ok = (_shift(sh, j, -1) == sh) & (d >= 1) & (d <= WINDOW_SIZE)
        sc = _prefix16(ws, [_shift(w, j, 0) for w in ws])
        keys = torch.maximum(keys, torch.where(ok & (sc >= MIN_MATCH), _pack_key(sc, d), 0))
    # sp is a permutation: no two rows meet at one position
    return best.scatter_reduce_(0, sp, keys, "amax")


def far_screen(sh, sp, data, best, k: int) -> torch.Tensor:
    """k-deep hash-probe screen, written into the position domain in place.

    sh: (total,) int32 chunk-tagged hashes, stably sorted; sp: (total,)
    int64, each row's position (the sort's permutation of 0..total-1, so
    positions ascend within a bucket; the kernel skips a position outside
    it, the plain version raises); data: the flat (total,) uint8 batch; best:
    (total,) int32 keys (>= 0) by position.  For each row, the k previous
    rows with the same hash and 1 <= position gap <= 32768 are candidates
    (a row before row 0 has hash -1, pos -1 and a zero window); the best
    16-byte-screened key goes to best[sp[i]] where it is larger.  Updates
    `best` in place and returns it."""
    if _build.on_cpu(sh):
        return far_screen_plain(sh, sp, data, best, k)
    _check("far_screen", data, k, (sh, torch.int32), (sp, torch.int64), (best, torch.int32))
    total = data.shape[0]
    if total:
        _build.launch(
            "far_screen", "tz_far_screen", data.device,
            *(t.data_ptr() for t in (sh, sp, data, best)), total, k,
        )
    return best


def near_trips(data, mincand, lim16, nd: int) -> torch.Tensor:
    """Candidates near_screen's kernel must compare for each position
    (int32): nearest first, d <= p - mincand[p], up to the first whose
    screen reaches lim16[p]; none where lim16[p] < MIN_MATCH."""
    ws = window_words(data)
    total = data.shape[0]
    maxd = torch.arange(total, dtype=torch.int32, device=data.device) - mincand
    alive = lim16 >= MIN_MATCH
    trips = torch.zeros(total, dtype=torch.int32, device=data.device)
    for d in range(1, nd + 1):
        alive = alive & (d <= maxd)
        trips += alive
        sc = torch.minimum(_prefix16(ws, [_shift(w, d, 0) for w in ws]), lim16)
        alive = alive & (sc < lim16)
    return trips


def far_trips(sh, sp, data, k: int) -> torch.Tensor:
    """Predecessors far_screen's kernel compares for each row (int32,
    sorted domain): its walk stops at the first row of another hash, the
    first gap over 32768, or after the first 16-byte screen."""
    ws = _sorted_windows(sp, data)
    pos = sp.to(torch.int32)
    alive = torch.ones_like(sh, dtype=torch.bool)
    trips = torch.zeros_like(sh)
    for j in range(1, k + 1):
        alive = alive & (_shift(sh, j, -1) == sh) & (pos - _shift(pos, j, -1) <= WINDOW_SIZE)
        trips += alive
        alive = alive & (_prefix16(ws, [_shift(w, j, 0) for w in ws]) < 16)
    return trips
