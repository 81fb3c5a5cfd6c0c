"""The inflate primitive probe kernels (csrc/inflate_prims.cu).

Counterparts of the Pallas kernels of tools/probe_inflate_prims.py and
tools/probe_inflate_prims2.py, which the probes in tpuzlib_torch/tools
drive.  A lane is a column, as a cursor was a lane of the TPU decode
kernel; the tools run 128 and every wrapper takes the lane count from its
inputs.  Arrays are int32 (rows, lanes); uint32 values pass as their bits.

  vec_cond_while(x)        x (1, lanes): while some lane is below 100 and
                           fewer than 64 steps ran, add 1 to every lane
                           below 100 (k_c); on the card the lanes stay in
                           registers, shared memory or device memory
                           across the steps by their count (while_route;
                           each route counts in _build.LAUNCHES as
                           vec_cond_while_<route> too);
  fetch_rows(words, j, k)  (k, lanes): words[j + i] for i < k, 0 outside
                           the rows (k_d, k = 3); on the card a thread a
                           lane loads j, then issues a chunk of 4 rows'
                           loads together before it stores them, the
                           last chunk predicated on i < k;
  row_store_loop(rows, lanes)
                           (rows, lanes): row `it` set to `it` in step `it`
                           of a loop (k_b);
  gather_store_loop(words, j, steps)
                           (steps, lanes): row `it` is words[j] (0 outside
                           the rows), then j = (j + 3) mod (nw - 1) (k_e);
                           on the card a thread computes its rows as
                           store_loop_steps gives them, 16 a chunk, and
                           issues a chunk's loads together;
  col_min_sum(x)           (2, lanes): each column's min and int32 sum
                           (k_f); on the card a thread a lane issues 16
                           rows' loads a chunk together;
  var_shifts(r, e)         (17, lanes): r >> (16 - L) for L < 16, then the
                           uint32 mask (1 << e) - 1, 0xFFFFFFFF for e
                           outside [0, 32) (k_g);
  tree_decode(w, cnt, first, off)
                           (2, lanes): the counting decode of the window's
                           low 16 bits, bit-reversed, over the 16 code
                           lengths of (16, lanes) tables: the first length
                           L >= 1 whose range holds the L-bit code (99 for
                           none) and the rank at that length, or at 15 when
                           none matched (k_h); on the card a thread a lane
                           loads w and rows 1-15 of the tables (row 0 is
                           never selected) together, then selects the
                           length and its rank in registers;
  table_lookup(ents, rank) ents[clip(rank, 0, rows - 1)] by lane: take_along
                           on axis 0 (k_i);
  window64(a, b, c, sh, o) (3, lanes): the 64-bit window at bit sh of the
                           words a, b, c, and its low word re-windowed by o
                           clipped to [0, 31] (k_j).

k_a (the uint32 sublane gather) is gather_probe.take_along(x, idx, 0,
fill=-1).  The tools' where-chains over 8-row tiles (k_d, k_e, k_i) are a
TPU workaround: each lane loads its word.  gather_store_loop,
col_min_sum, fetch_rows and tree_decode spread their lanes over every SM
of the card (one block up to 128 lanes).  On a CUDA tensor each wrapper
launches its kernel and counts it in _build.LAUNCHES; on a CPU tensor it
runs the plain version beside it, which keeps uint32 values in int64.
"""

from __future__ import annotations

import torch

from . import _build
from .gather_probe import check_arrays, staged_words, take_along, take_along_plain, wrap32

LIMIT, MAX_STEPS = 100, 64  # k_c's condition
# vec_cond_while's routes on the card, by where the lanes stay across the
# steps: a thread's registers, up to REG_LANES (8 a thread of a block of
# 1,024); shared memory, up to staged_words(); device memory past that
WHILE_ROUTES = ("regs", "smem", "global")
REG_LANES = 8 * 1024
M32 = 0xFFFFFFFF
STORE_CHUNK = 16  # gather_store_loop's steps a thread loads at once (kChunk, csrc/inflate_prims.cu)


def _row(name: str, *tensors: torch.Tensor) -> int:
    """The lane count of (1, lanes) tensors, all of one shape."""
    check_arrays(name, *tensors)
    shape = tuple(tensors[0].shape)
    if shape[0] != 1 or shape[1] == 0 or any(tuple(t.shape) != shape for t in tensors):
        raise ValueError("%s: expected (1, lanes) tensors of one shape, got %s"
                         % (name, [tuple(t.shape) for t in tensors]))
    return shape[1]


def vec_cond_while_plain(x: torch.Tensor) -> torch.Tensor:
    _row("vec_cond_while", x)
    v, it = x.clone(), 0
    while it < MAX_STEPS and bool((v < LIMIT).any()):
        v += (v < LIMIT).int()
        it += 1
    return v


def while_route(lanes: int, staged: int) -> str:
    """vec_cond_while's route on the card for `lanes` lanes, `staged` the
    int32 words a block may hold in shared memory (staged_words())."""
    if lanes <= REG_LANES:
        return "regs"
    return "smem" if lanes <= staged else "global"


def vec_cond_while(x: torch.Tensor) -> torch.Tensor:
    """int32 (1, lanes): k_c's loop on x (1, lanes); on the card by the
    route while_route gives."""
    if _build.on_cpu(x):
        return vec_cond_while_plain(x)
    lanes = _row("vec_cond_while", x)
    route = while_route(lanes, staged_words(x.device) if lanes > REG_LANES else 0)
    out = torch.empty_like(x)
    _build.launch(("vec_cond_while", "vec_cond_while_" + route), "tz_vec_cond_while", x.device,
                  x.data_ptr(), lanes, WHILE_ROUTES.index(route), out.data_ptr())
    return out


def _check_fetch(name: str, words: torch.Tensor, j: torch.Tensor, count: int, least: int) -> None:
    check_arrays(name, words, j)
    if tuple(j.shape) != (1, words.shape[1]) or words.shape[1] == 0:
        raise ValueError("%s: words (nw, lanes) and j (1, lanes), got %s and %s"
                         % (name, tuple(words.shape), tuple(j.shape)))
    if words.shape[0] < least:
        raise ValueError("%s: at least %d rows of words, got %d" % (name, least, words.shape[0]))
    if not 0 < count < 1 << 20:
        raise ValueError("%s: 1 to 2^20 - 1 output rows, got %r" % (name, count))


def _rows_at(words: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """words[r, lane] by lane, 0 where r is outside the rows."""
    nw = words.shape[0]
    if nw == 0:
        return torch.zeros(r.shape, dtype=torch.int32, device=words.device)
    g = torch.gather(words, 0, r.clamp(0, nw - 1))
    return torch.where((r >= 0) & (r < nw), g, 0)


def fetch_rows_plain(words: torch.Tensor, j: torch.Tensor, k: int = 3) -> torch.Tensor:
    _check_fetch("fetch_rows", words, j, k, 0)
    return _rows_at(words, j.long() + torch.arange(k, device=j.device)[:, None])


def fetch_rows(words: torch.Tensor, j: torch.Tensor, k: int = 3) -> torch.Tensor:
    """int32 (k, lanes): words[j + i, lane] for i < k, 0 where j + i is
    outside [0, nw); words (nw, lanes), j (1, lanes)."""
    if _build.on_cpu(words):
        return fetch_rows_plain(words, j, k)
    _check_fetch("fetch_rows", words, j, k, 0)
    out = torch.empty(k, words.shape[1], dtype=torch.int32, device=words.device)
    _build.launch("fetch_rows", "tz_fetch_rows", words.device, words.data_ptr(), words.shape[0],
                  words.shape[1], j.data_ptr(), k, out.data_ptr())
    return out


def _check_store(rows: int, lanes: int) -> None:
    if not (0 < rows < 1 << 20 and 0 < lanes < 1 << 31):
        raise ValueError("row_store_loop: rows in [1, 2^20) and lanes in [1, 2^31), got %r, %r"
                         % (rows, lanes))


def row_store_loop_plain(rows: int, lanes: int, device="cuda") -> torch.Tensor:
    _check_store(rows, lanes)
    out = torch.empty(rows, lanes, dtype=torch.int32, device=device)
    for it in range(rows):
        out[it] = it
    return out


def row_store_loop(rows: int, lanes: int, device="cuda") -> torch.Tensor:
    """int32 (rows, lanes): row `it` stored as `it` in step `it` of a
    loop, on `device`."""
    _check_store(rows, lanes)
    out = torch.empty(rows, lanes, dtype=torch.int32, device=device)
    if _build.on_cpu(out):
        return row_store_loop_plain(rows, lanes, out.device)
    _build.launch("row_store_loop", "tz_row_store_loop", out.device, rows, lanes, out.data_ptr())
    return out


def gather_store_loop_plain(words: torch.Tensor, j: torch.Tensor, steps: int = 16) -> torch.Tensor:
    _check_fetch("gather_store_loop", words, j, steps, 2)
    jj, out = j.long(), []
    for _ in range(steps):
        out.append(_rows_at(words, jj))
        jj = wrap32(jj + 3).long() % (words.shape[0] - 1)
    return torch.cat(out)


def _add_mod(a, b, m: int):
    """(a + b) mod m for a, b in [0, m): ints or int64 tensors."""
    t = a + b
    return t - m * (t >= m)


def store_loop_steps(j: torch.Tensor, nw: int, steps: int) -> torch.Tensor:
    """int64 (steps, lanes): the row each of gather_store_loop's steps reads
    for j (1, lanes), as the card's kernel computes it: j itself at step 0
    (a row outside [0, nw) reads 0); at step t >= 1 (r1 + (t - 1) s) mod m,
    where m = nw - 1, r1 = floor_mod(wrap32(j + 3), m) and s = 3 mod m: in
    chunks of STORE_CHUNK steps, each row its chunk's first row plus an
    offset k s mod m (the offsets summed once, the same for every lane),
    each sum less m where it reaches m, the chunks' first rows stepping by
    STORE_CHUNK s mod m.  The rows from step 1 on lie in [0, m)."""
    if nw < 2 or steps < 0:
        raise ValueError("store_loop_steps: nw >= 2 and steps >= 0, got %r, %r" % (nw, steps))
    m, s, j0 = nw - 1, 3 % (nw - 1), j.long().reshape(-1)
    d = [0]
    for _ in range(1, STORE_CHUNK):
        d.append(_add_mod(d[-1], s, m))
    dn = _add_mod(d[-1], s, m)
    base = wrap32(j0 + 3).long() % m  # the row of step 1
    rows = [j0]
    for t in range(1, steps):
        c, k = divmod(t, STORE_CHUNK)
        if c and not k:  # a chunk's first step
            base = _add_mod(base, d[-1] if c == 1 else dn, m)
        rows.append(_add_mod(base, d[k - 1] if c == 0 else d[k], m))
    return torch.stack(rows) if steps else j0.new_zeros((0, j0.numel()))


def gather_store_loop(words: torch.Tensor, j: torch.Tensor, steps: int = 16) -> torch.Tensor:
    """int32 (steps, lanes): row `it` is words[j, lane] (0 outside the
    rows), then j = (j + 3) mod (nw - 1), a floor mod; words (nw, lanes)
    with nw >= 2, j (1, lanes)."""
    if _build.on_cpu(words):
        return gather_store_loop_plain(words, j, steps)
    _check_fetch("gather_store_loop", words, j, steps, 2)
    out = torch.empty(steps, words.shape[1], dtype=torch.int32, device=words.device)
    _build.launch("gather_store_loop", "tz_gather_store_loop", words.device, words.data_ptr(),
                  words.shape[0], words.shape[1], j.data_ptr(), steps, out.data_ptr())
    return out


def _check_cols(x: torch.Tensor) -> None:
    check_arrays("col_min_sum", x)
    if x.numel() == 0:
        raise ValueError("col_min_sum: x is empty, shape %s" % (tuple(x.shape),))


def col_min_sum_plain(x: torch.Tensor) -> torch.Tensor:
    _check_cols(x)
    return torch.cat([x.min(0, keepdim=True).values, wrap32(x.long().sum(0, keepdim=True))])


def col_min_sum(x: torch.Tensor) -> torch.Tensor:
    """int32 (2, lanes): the min and the int32 sum of each column of x
    (rows, lanes)."""
    if _build.on_cpu(x):
        return col_min_sum_plain(x)
    _check_cols(x)
    out = torch.empty(2, x.shape[1], dtype=torch.int32, device=x.device)
    _build.launch("col_min_sum", "tz_col_min_sum", x.device, x.data_ptr(), x.shape[0],
                  x.shape[1], out.data_ptr())
    return out


def _lengths(device) -> torch.Tensor:
    return torch.arange(16, device=device)[:, None]


def _shl32(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """uint32 x << s (in int64), 0 for s of 32 or more."""
    return torch.where(s < 32, (x << s.clamp(0, 31)) & M32, 0)


def _shr32(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """uint32 x >> s (in int64), 0 for s of 32 or more."""
    return torch.where(s < 32, x >> s.clamp(0, 31), 0)


def var_shifts_plain(r: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    _row("var_shifts", r, e)
    code = r.long() >> (16 - _lengths(r.device))
    mask = (_shl32(torch.ones_like(e, dtype=torch.int64), e.long() & M32) - 1) & M32
    return wrap32(torch.cat([code, mask]))


def var_shifts(r: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """int32 (17, lanes): r >> (16 - L), arithmetic, for L < 16, then the
    uint32 mask (1 << e) - 1 (e taken as uint32); r, e (1, lanes)."""
    if _build.on_cpu(r):
        return var_shifts_plain(r, e)
    lanes = _row("var_shifts", r, e)
    out = torch.empty(17, lanes, dtype=torch.int32, device=r.device)
    _build.launch("var_shifts", "tz_var_shifts", r.device, r.data_ptr(), e.data_ptr(), lanes,
                  out.data_ptr())
    return out


def _check_tree(w: torch.Tensor, cnt, first, off) -> int:
    lanes = _row("tree_decode", w)
    check_arrays("tree_decode", w, cnt, first, off)
    if any(tuple(t.shape) != (16, lanes) for t in (cnt, first, off)):
        raise ValueError("tree_decode: tables of shape (16, %d), got %s"
                         % (lanes, [tuple(t.shape) for t in (cnt, first, off)]))
    return lanes


def rev16(x: torch.Tensor) -> torch.Tensor:
    """The low 16 bits of x (int64) reversed."""
    r = x & 0xFFFF
    for mask, s in ((0x5555, 1), (0x3333, 2), (0x0F0F, 4), (0x00FF, 8)):
        r = ((r & mask) << s) | ((r >> s) & mask)
    return r


def tree_decode_plain(w: torch.Tensor, cnt: torch.Tensor, first: torch.Tensor,
                      off: torch.Tensor) -> torch.Tensor:
    _check_tree(w, cnt, first, off)
    L = _lengths(w.device)
    code = rev16(w.long()) >> (16 - L)
    first, cnt = first.long(), cnt.long()
    match = (code >= first) & (wrap32(code - first) < cnt) & (L >= 1)
    sel = torch.where(match, L, 99).min(0, keepdim=True).values
    rank = torch.where(L == sel.clamp(0, 15), off.long() + code - first, 0).sum(0, keepdim=True)
    return wrap32(torch.cat([sel, rank]))


def tree_decode(w: torch.Tensor, cnt: torch.Tensor, first: torch.Tensor,
                off: torch.Tensor) -> torch.Tensor:
    """int32 (2, lanes): the code length and rank of each lane's window w
    (1, lanes) under the (16, lanes) tables cnt, first, off of
    inflate_cuda.canon_tables."""
    if _build.on_cpu(w):
        return tree_decode_plain(w, cnt, first, off)
    lanes = _check_tree(w, cnt, first, off)
    out = torch.empty(2, lanes, dtype=torch.int32, device=w.device)
    _build.launch("tree_decode", "tz_tree_decode", w.device, w.data_ptr(), cnt.data_ptr(),
                  first.data_ptr(), off.data_ptr(), lanes, out.data_ptr())
    return out


def _clipped(ents: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    check_arrays("table_lookup", ents, rank)
    return rank.clamp(0, max(ents.shape[0] - 1, 0))


def table_lookup_plain(ents: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    return take_along_plain(ents, _clipped(ents, rank), 0)


def table_lookup(ents: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """int32 (1, lanes): ents[clip(rank, 0, rows - 1), lane]; ents (rows,
    lanes), rank (1, lanes).  take_along on axis 0, its kernel on a CUDA
    tensor."""
    return take_along(ents, _clipped(ents, rank), 0)


def window64_plain(a, b, c, sh, o) -> torch.Tensor:
    _row("window64", a, b, c, sh, o)
    wa, wb, wc = (t.long() & M32 for t in (a, b, c))
    shv = sh.long() & M32
    nsh = (32 - shv) & 31
    hi_b = torch.where(shv == 0, 0, _shl32(wb, nsh))
    hi_c = torch.where(shv == 0, 0, _shl32(wc, nsh))
    lo, hi = _shr32(wa, shv) | hi_b, _shr32(wb, shv) | hi_c
    ov = o.long().clamp(0, 31)
    w2 = torch.where(ov == 0, lo, _shr32(lo, ov) | _shl32(hi, (32 - ov) & 31))
    return wrap32(torch.cat([lo, hi, w2]))


def window64(a, b, c, sh, o) -> torch.Tensor:
    """int32 (3, lanes), uint32 bits: the low and high words of the
    64-bit window at bit sh (taken as uint32) of the words a, b, c, and
    the low word re-windowed by o clipped to [0, 31]; all (1, lanes)."""
    if _build.on_cpu(a):
        return window64_plain(a, b, c, sh, o)
    lanes = _row("window64", a, b, c, sh, o)
    out = torch.empty(3, lanes, dtype=torch.int32, device=a.device)
    _build.launch("window64", "tz_window64", a.device, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                  sh.data_ptr(), o.data_ptr(), lanes, out.data_ptr())
    return out
