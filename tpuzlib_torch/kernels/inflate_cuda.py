"""K-cursor speculative Huffman decode (one kernel) and its host tables.

Counterpart of tpuzlib/kernels/inflate_pallas.py.  Each cursor decodes
its own bit range of a raw DEFLATE stream into a token tape, one row per
symbol, from per-block canonical count tables; the splice
(kernels/inflate_device2.py) stitches the cursors' tapes.

`cursor_tokenize(buf, starts, stops_dec, block_of, plan, stride_bits,
overlap_bits, cap, expect_eob, device)` has pallas_cursor_tokenize's
contract: (tok_pack, tok_bp) of K * cap rows and (cnt, end_pos, status,
eob_idx) of K, all int32 tensors on `device`.  tok_pack holds
`val | dist << 9 | is_len << 25`, or `1 << 26` for an EOB the cursor does
not stop at; tok_bp the token's ABSOLUTE bit position, `SENT_BP` in
unused rows (so a stream must stay below 2^29 bits, as in tpuzlib).
eob_idx is the row of the cursor's first flagged EOB, or -1.

It runs in two steps: `prepare` builds the per-block count tables on the
host and moves them and the stream words (`stream_words`, unless the
block planner uploaded them for its header scan) to `device`;
`cursor_decode` runs the decode.  The uploads, and the read of the
highest slice start in the decode's check, count as copy.h2d_bytes and
copy.d2h_bytes while the telemetry is on.  On CUDA tensors that launches the two kernels of
csrc/inflate_decode.cu: `inflate_lut` (decode_luts) builds each block's
primary lookup tables on the card, then `inflate_decode` decodes; on CPU
tensors it runs the plain torch version, cursor_tokenize_plain.  The
lookup tables' plain version is decode_luts_plain.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..codec import huffman
from ..codec.tables import FIXED_DIST_LENGTHS, FIXED_LITLEN_LENGTHS
from ..utils import trace
from . import _build
from .deflate_device3 import _as_i32

LE = 288  # lit entry-table rows (286 symbols, canonical rank order)
DE = 32  # dist entry-table rows
SENT_BP = 1 << 30  # bit position of unused tape rows

ST_RUN, ST_STRIDE_END, ST_EOB, ST_ERR, ST_OOB = 0, 1, 2, 3, 4

# per-block table columns: count / first / offset over code lengths 0..15,
# for lit/len then dist
T_LC, T_LF, T_LO, T_DC, T_DF, T_DO = 0, 16, 32, 48, 64, 80
TB = 96
# per-cursor fields, rows of `cur`
C_SWSTART, C_START, C_STOP, C_AVAIL, C_ACTIVE, C_EXPECT, C_BLOCK = range(7)
NCUR = 7

# primary lookup tables: a window's first LUT_BITS (lit/len) or DLUT_BITS
# (distance) bits index them.  10 and 8 bits take nearly every symbol of
# zlib's dynamic blocks; a miss sends the whole warp through the counting
# loop, so fewer misses beat smaller tables (10 KiB a block, in L1 and L2)
LUT_BITS, DLUT_BITS = 10, 8
LUT_ROWS = (1 << LUT_BITS) + (1 << DLUT_BITS)
DECODE_THREADS = 64  # threads a block of the decode kernel (a multiple of 32)

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# host: canonical decode tables per block
# ---------------------------------------------------------------------------


def canon_tables(lengths: np.ndarray, kind: str):
    """(ents, cnt16, first16, off16) for a code-length set.

    ents[rank] = entry payload (codec/huffman.py) of the rank-th symbol in
    canonical order (length ascending, then symbol); a window whose L-bit
    MSB-first prefix c satisfies first16[L] <= c < first16[L] + cnt16[L]
    decodes to rank off16[L] + c - first16[L]."""
    lengths = np.asarray(lengths, dtype=np.int64)
    nsym = LE if kind == "litlen" else DE
    cnt = np.bincount(lengths[lengths > 0], minlength=huffman.MAX_BITS + 1).astype(np.int32)
    cnt16 = np.zeros(16, np.int32)
    cnt16[1 : huffman.MAX_BITS + 1] = cnt[1:]
    first16 = np.zeros(16, np.int32)
    code = 0
    for b in range(1, 16):
        code = (code + int(cnt16[b - 1])) << 1
        first16[b] = code
    # exclusive prefix: off16[L] = number of symbols shorter than L
    off16 = (np.cumsum(cnt16) - cnt16).astype(np.int32)
    syms = np.flatnonzero(lengths > 0)
    order = syms[np.argsort(lengths[syms], kind="stable")]
    ents = np.zeros(nsym, np.uint32)
    if len(order):
        ents[: len(order)] = huffman._entry_fields(order, kind) | (
            lengths[order].astype(np.uint32) << huffman.NB_SHIFT
        )
    return ents, cnt16, first16, off16


@functools.lru_cache()
def stored_canon_tables():
    """Transparent 8-bit tables: a stored block's byte-aligned data
    decodes as literals with the same kernel."""
    b = np.arange(256, dtype=np.uint32)
    rev8 = np.zeros(256, np.int64)
    for i in range(8):
        rev8 |= ((b >> i) & 1).astype(np.int64) << (7 - i)
    ents = np.zeros(LE, np.uint32)
    ents[rev8] = b | (np.uint32(8) << huffman.NB_SHIFT)
    cnt16 = np.zeros(16, np.int32)
    cnt16[8] = 256
    first16 = np.zeros(16, np.int32)
    off16 = np.zeros(16, np.int32)
    dents = np.zeros(DE, np.uint32)
    dzero = np.zeros(16, np.int32)
    return (ents, cnt16, first16, off16), (dents, dzero, dzero, dzero)


@functools.lru_cache()
def fixed_canon_tables():
    return (
        canon_tables(np.asarray(FIXED_LITLEN_LENGTHS), "litlen"),
        canon_tables(np.asarray(FIXED_DIST_LENGTHS), "dist"),
    )


def tables_for_block(lens_info):
    """Canonical tables from a block plan's lens_info tag."""
    if lens_info[0] == "stored":
        return stored_canon_tables()
    if lens_info[0] == "fixed":
        return fixed_canon_tables()
    _, litlens, distlens = lens_info
    return canon_tables(litlens, "litlen"), canon_tables(distlens, "dist")


# ---------------------------------------------------------------------------
# host: plan arrays -> the kernel's inputs
# ---------------------------------------------------------------------------


class DecodeArgs(NamedTuple):
    """The decode's inputs, on one device (all int32):

    words  the stream as little-endian u32 words, zero-padded so that every
           cursor's slice of `nwp` words lies inside;
    cur    (NCUR, K) per-cursor fields, rows C_*: the slice's first word,
           start / stop / available bits relative to the slice's start,
           active, stops-at-EOB, block;
    tabs   (nblk, TB) count / first / offset tables;
    lents  (nblk, LE) and dents (nblk, DE) entries in canonical rank order;
    nwp    words per cursor slice; cap tape rows per cursor."""

    words: torch.Tensor
    cur: torch.Tensor
    tabs: torch.Tensor
    lents: torch.Tensor
    dents: torch.Tensor
    nwp: int
    cap: int


def words_shape(buf_len: int, stride_bits: int, overlap_bits: int):
    """(words per cursor slice, padded stream words).  A cursor decodes up
    to `overlap_bits` past its stride, plus a symbol's worth."""
    nwp = -(-(stride_bits // 32 + overlap_bits // 32 + 8) // 8) * 8
    return nwp, (buf_len + 3) // 4 + nwp


def block_tables(plan):
    """(tabs int32 (nblk, TB), lents u32 (nblk, LE), dents u32 (nblk, DE))
    of a block plan (entries carry a lens_info tag last)."""
    nblk = len(plan)
    tabs = np.zeros((nblk, TB), np.int32)
    lents = np.zeros((nblk, LE), np.uint32)
    dents = np.zeros((nblk, DE), np.uint32)
    for b, p in enumerate(plan):
        (le, lcnt, lfst, loff), (de, dcnt, dfst, doff) = tables_for_block(p[-1])
        lents[b], dents[b] = le, de
        for col, t in ((T_LC, lcnt), (T_LF, lfst), (T_LO, loff),
                       (T_DC, dcnt), (T_DF, dfst), (T_DO, doff)):
            tabs[b, col : col + 16] = t
    return tabs, lents, dents


def _put(a: np.ndarray, device) -> torch.Tensor:
    """`a`'s bits as int32 on `device`, counted as copy.h2d_bytes."""
    a = np.ascontiguousarray(a).view(np.int32)
    trace.count_copy("h2d", device, a)
    return torch.from_numpy(a).to(device)


def stream_words(buf: np.ndarray, stride_bits: int, overlap_bits: int, device) -> torch.Tensor:
    """The decode's `words` of `buf` on `device`: its bytes as little-endian
    u32 words (int32), zero-padded to words_shape's length.  The block
    planner uploads them for the header scan on a card, and the decode
    reads the same tensor (prepare's `words`)."""
    _, nwpad = words_shape(len(buf), stride_bits, overlap_bits)
    wbuf = np.zeros(nwpad * 4, np.uint8)
    wbuf[: len(buf)] = buf
    return _put(wbuf.view("<u4"), device)


def prepare(buf: np.ndarray, starts, stops_dec, block_of, plan, stride_bits: int,
            overlap_bits: int, cap: int, expect_eob=None, device="cuda",
            words: torch.Tensor | None = None) -> DecodeArgs:
    """The decode's inputs for cursors with absolute bit ranges
    [starts, stops_dec) (starts < 0: an inactive cursor), each decoding
    the tables of block `block_of` of `plan`.  expect_eob: bool[K], the
    cursors that stop at an EOB (default all).  words: stream_words of
    these arguments, already on `device` (default: uploaded here).  Raises
    ValueError for a stream of 2^29 bits or more (its positions would pass
    SENT_BP)."""
    if len(buf) * 8 >= SENT_BP >> 1:
        raise ValueError("inflate_decode: the stream must have fewer than 2^29 bits")
    starts = np.asarray(starts, np.int64)
    K = len(starts)
    nwp, nwpad = words_shape(len(buf), stride_bits, overlap_bits)
    if words is None:
        words = stream_words(buf, stride_bits, overlap_bits, device)
    elif tuple(words.shape) != (nwpad,):
        raise ValueError("inflate_decode: the stream words must have words_shape's length")

    active = starts >= 0
    swstart = np.minimum(np.where(active, starts, 0) >> 5, nwpad - nwp)
    cur = np.zeros((NCUR, K), np.int64)
    cur[C_SWSTART] = swstart
    cur[C_START] = np.where(active, starts, 0) - (swstart << 5)
    cur[C_STOP] = np.where(active, np.asarray(stops_dec, np.int64) - (swstart << 5), 0)
    cur[C_AVAIL] = np.minimum(len(buf) * 8 - (swstart << 5), nwp * 32)
    cur[C_ACTIVE] = active
    cur[C_EXPECT] = True if expect_eob is None else np.asarray(expect_eob, bool)[:K]
    cur[C_BLOCK] = np.clip(block_of, 0, len(plan) - 1)
    tabs, lents, dents = block_tables(plan)
    return DecodeArgs(words, _put(cur.astype(np.int32), device), _put(tabs, device),
                      _put(lents, device), _put(dents, device), nwp, int(cap))


def cursor_tokenize(buf, starts, stops_dec, block_of, plan, stride_bits, overlap_bits, cap,
                    expect_eob=None, device="cuda"):
    """The decode of pallas_cursor_tokenize's contract (module docstring)."""
    return cursor_decode(prepare(buf, starts, stops_dec, block_of, plan, stride_bits,
                                 overlap_bits, cap, expect_eob, device))


# ---------------------------------------------------------------------------
# the decode: kernel wrapper and plain version
# ---------------------------------------------------------------------------


def _check_tables(a: DecodeArgs) -> int:
    """Raise unless the inputs have the kernels' types and shapes; returns K."""
    ncur, K = a.cur.shape
    nblk = a.tabs.shape[0]
    _build.check_inputs("inflate_decode", (ncur, K), a.cur)
    for name, t, shape in (("words", a.words, a.words.shape), ("tabs", a.tabs, (nblk, TB)),
                           ("lents", a.lents, (nblk, LE)), ("dents", a.dents, (nblk, DE))):
        _build.check_inputs("inflate_decode %s" % name, shape, t)
        if t.device != a.cur.device:
            raise ValueError("inflate_decode: all inputs must lie on one device")
    if ncur != NCUR or a.words.dim() != 1 or nblk < 1 or a.nwp < 8 or a.cap < 1:
        raise ValueError("inflate_decode: malformed inputs")
    return K


def _check_slices(a: DecodeArgs) -> None:
    """Raise unless every cursor's slice lies inside the stream words (a
    reduction read back to the host: it waits for the card)."""
    if not a.cur.shape[1]:
        return
    top = a.cur[C_SWSTART].max()
    trace.count_copy("d2h", top.device, top)
    if int(top) + a.nwp > a.words.numel():
        raise ValueError("inflate_decode: a cursor's slice runs past the stream words")


def _check(a: DecodeArgs) -> int:
    """_check_tables and _check_slices; returns K."""
    K = _check_tables(a)
    _check_slices(a)
    return K


def decode_luts(a: DecodeArgs) -> torch.Tensor:
    """The primary lookup tables of every block of `a` (decode_luts_plain's
    result): on CUDA tensors from the `inflate_lut` kernel, on CPU tensors
    from decode_luts_plain."""
    if _build.on_cpu(a.tabs):
        return decode_luts_plain(a.tabs, a.lents, a.dents)
    _check_tables(a)
    nblk = a.tabs.shape[0]
    lut = torch.empty((nblk, LUT_ROWS, 2), dtype=torch.int32, device=a.tabs.device)
    _build.launch("inflate_lut", "tz_inflate_lut", a.tabs.device, a.tabs.data_ptr(),
                  a.lents.data_ptr(), a.dents.data_ptr(), nblk, LUT_BITS, DLUT_BITS,
                  lut.data_ptr())
    return lut


def cursor_decode(a: DecodeArgs, luts: torch.Tensor | None = None,
                  threads: int = DECODE_THREADS):
    """(tok_pack, tok_bp, cnt, end_pos, status, eob_idx) of the decode,
    int32 tensors on the inputs' device.  On CUDA tensors: the `inflate_lut`
    kernel builds the lookup tables unless `luts` (decode_luts of `a`) is
    given, then the `inflate_decode` kernel runs in blocks of `threads`."""
    if _build.on_cpu(a.cur):
        return cursor_tokenize_plain(a)
    K = _check_tables(a)
    if threads % 32 or not 32 <= threads <= 128:
        raise ValueError("inflate_decode: threads must be a multiple of 32 from 32 to 128")
    dev = a.cur.device
    tok = torch.empty(K * a.cap, dtype=torch.int32, device=dev)
    bp = torch.empty(K * a.cap, dtype=torch.int32, device=dev)
    fin = torch.empty((4, K), dtype=torch.int32, device=dev)
    if K:
        luts = decode_luts(a) if luts is None else luts
        _build.check_inputs("inflate_decode luts", (a.tabs.shape[0], LUT_ROWS, 2), luts)
        if luts.device != dev:
            raise ValueError("inflate_decode: all inputs must lie on one device")
        _check_slices(a)  # last: the card idles from its read-back to the launch
        _build.launch("inflate_decode", "tz_inflate_decode", dev, a.words.data_ptr(),
                      a.cur.data_ptr(), K, a.nwp, a.cap, a.tabs.data_ptr(), a.lents.data_ptr(),
                      a.dents.data_ptr(), luts.data_ptr(), LUT_BITS, DLUT_BITS, threads,
                      tok.data_ptr(), bp.data_ptr(), fin.data_ptr())
    return tok, bp, fin[0], fin[1], fin[2], fin[3]


def _rev16(w: torch.Tensor) -> torch.Tensor:
    """Bit-reverse the low 16 bits of each value."""
    r = w & 0xFFFF
    r = ((r & 0x5555) << 1) | ((r >> 1) & 0x5555)
    r = ((r & 0x3333) << 2) | ((r >> 2) & 0x3333)
    r = ((r & 0x0F0F) << 4) | ((r >> 4) & 0x0F0F)
    return ((r & 0x00FF) << 8) | ((r >> 8) & 0x00FF)


def _tree_decode(w, cnt, first, off):
    """Counting decode of one symbol per cursor from window w (K,) with
    (K, 16) tables: (rank, code length, matched).  Where no length matches,
    the length reads as 15 and only `matched` is meaningful."""
    lrow = torch.arange(16, device=w.device)
    code = _rev16(w)[:, None] >> (16 - lrow)
    match = (code >= first) & (code - first < cnt) & (lrow >= 1)
    lsel = torch.where(match, lrow, 99).min(dim=1).values
    ok = lsel < 99
    lc = lsel.clamp(0, 15)[:, None]
    rank = (off.gather(1, lc) + code.gather(1, lc) - first.gather(1, lc))[:, 0]
    return rank, lc[:, 0], ok


def decode_luts_plain(tabs: torch.Tensor, lents: torch.Tensor, dents: torch.Tensor,
                      W: int = LUT_BITS, Wd: int = DLUT_BITS) -> torch.Tensor:
    """(nblk, 2^W + 2^Wd, 2) int32: for every block, its lit/len table of
    2^W rows, then its distance table of 2^Wd rows.  Row x holds
    (ent, L | (L + extra bits of ent) << 8) where the counting decode
    (_tree_decode) of a window whose first bits are x (first bit lowest)
    matches a code length L of at most the table's bits, with ent the entry
    it finds (rank clamped into the entry table); else (0, 0), and the
    decode counts from length W + 1 (Wd + 1).  The counting match at length
    L reads only the window's first L bits, so a row holds for every window
    that starts with x."""
    t = tabs.to(torch.int64)
    parts = []
    for ents, col, bits in ((lents, T_LC, W), (dents, T_DC, Wd)):
        ln = torch.arange(1, bits + 1, device=tabs.device)
        code = (_rev16(torch.arange(1 << bits, device=tabs.device))[:, None] >> (16 - ln))[None]
        cnt, first, off = (t[:, col + c + ln][:, None, :] for c in (0, 16, 32))
        match = (code >= first) & (code - first < cnt)  # (nblk, 2^bits, bits)
        lsel = torch.where(match, ln, bits + 1).min(dim=2).values
        hit = lsel <= bits
        i = (lsel.clamp(max=bits) - 1)[..., None]
        pick = lambda x: x.expand_as(match).gather(2, i)[..., 0]  # noqa: E731
        rank = pick(off) + pick(code) - pick(first)
        ent = ents.gather(1, rank.clamp(0, ents.shape[1] - 1))
        lens = lsel | (lsel + ((ent >> 19) & 0xF)) << 8
        parts.append(torch.stack([torch.where(hit, ent, 0), torch.where(hit, lens, 0).int()], -1))
    return torch.cat(parts, 1).to(torch.int32).contiguous()


def cursor_tokenize_plain(a: DecodeArgs):
    """The decode vectorized over cursors: one step of every cursor per
    iteration, on any device.  u32 values live in int64 masked to 32
    bits."""
    _check(a)
    K, cap, nwp = a.cur.shape[1], a.cap, a.nwp
    dev = a.cur.device
    cur = a.cur.to(torch.int64)
    swstart, pos, stop, avail = cur[C_SWSTART], cur[C_START], cur[C_STOP], cur[C_AVAIL]
    active, expect, blk = cur[C_ACTIVE] != 0, cur[C_EXPECT] != 0, cur[C_BLOCK]
    words = a.words.to(torch.int64) & _M32
    t = a.tabs.to(torch.int64)[blk]
    lc, lf, lo = t[:, T_LC : T_LC + 16], t[:, T_LF : T_LF + 16], t[:, T_LO : T_LO + 16]
    dc, df, do = t[:, T_DC : T_DC + 16], t[:, T_DF : T_DF + 16], t[:, T_DO : T_DO + 16]
    lents = a.lents.to(torch.int64).reshape(-1) & _M32
    dents = a.dents.to(torch.int64).reshape(-1) & _M32

    tok = torch.zeros((K, cap), dtype=torch.int64, device=dev)
    bp = torch.full((K, cap), SENT_BP, dtype=torch.int64, device=dev)
    cnt = torch.zeros(K, dtype=torch.int64, device=dev)
    eob_first = torch.full((K,), -1, dtype=torch.int64, device=dev)
    status = torch.where(active & (pos < stop), ST_RUN, ST_STRIDE_END)
    off = swstart << 5

    def shr_or(lo_w, hi_w, s):
        """(lo_w >> s) | (hi_w << (32 - s)) for s in 1..31, lo_w at s == 0."""
        return torch.where(s == 0, lo_w, ((lo_w >> s) | (hi_w << (32 - s))) & _M32)

    for it in range(cap):
        # a stopped cursor never runs again: stop when none runs (checked
        # every 32 steps, each check waits for the device)
        if it % 32 == 0 and not bool((status == ST_RUN).any()):
            break
        run = status == ST_RUN
        # the slice's words j, j + 1, j + 2, the index clamped into the slice
        j = swstart + (pos >> 5).clamp(0, nwp - 3)
        wa, wb, wc = words[j], words[j + 1], words[j + 2]
        sh = pos & 31
        lo_w = shr_or(wa, wb, sh)
        hi_w = shr_or(wb, wc, sh)

        # literal/length symbol, then its extra bits
        rank, L, okl = _tree_decode(lo_w, lc, lf, lo)
        ent = lents[blk * LE + rank.clamp(0, LE - 1)]
        eb = (ent >> 19) & 0xF
        val = (ent & 0x7FFF) + ((lo_w >> L) & ((1 << eb) - 1))
        is_len = (ent & (1 << 23)) != 0
        is_eob = (ent & (1 << 24)) != 0
        jump1 = L + eb
        bad = run & (~okl | ((ent >> 31) != 0))

        # distance symbol and its extra bits (meaningful for lengths only)
        o = jump1.clamp(0, 31)
        w2 = shr_or(lo_w, hi_w, o)
        w2hi = torch.where(o == 0, hi_w, hi_w >> o)
        drank, dL, okd = _tree_decode(w2, dc, df, do)
        dent = dents[blk * DE + drank.clamp(0, DE - 1)]
        deb = (dent >> 19) & 0xF
        dval = (dent & 0x7FFF) + (shr_or(w2, w2hi, dL) & ((1 << deb) - 1))
        bad = bad | (run & is_len & (~okd | ((dent >> 31) != 0)))

        jump = torch.where(is_len, jump1 + dL + deb, jump1)
        nxt = pos + jump
        oob = nxt > avail
        real_eob = is_eob & expect
        is_data = run & ~bad & ~real_eob & ~oob
        pack = val | (torch.where(is_len, dval, 0) << 9) | (is_len.long() << 25)
        pack = torch.where(is_eob, 1 << 26, pack)
        tok[:, it] = torch.where(is_data, pack, 0)
        bp[:, it] = torch.where(is_data, pos + off, SENT_BP)
        eob_first = torch.where(is_data & is_eob & (eob_first < 0), cnt, eob_first)
        cnt = cnt + is_data.long()
        pos = torch.where(is_data, nxt, pos)
        ends = run & real_eob & ~bad & ~oob
        status = torch.where(
            run & bad, ST_ERR,
            torch.where(run & ~bad & oob, ST_OOB, torch.where(ends, ST_EOB, status)))
        pos = torch.where(ends, pos + jump, pos)
        status = torch.where((status == ST_RUN) & (pos >= stop), ST_STRIDE_END, status)
    # cursors still running after `cap` steps overflowed the tape
    status = torch.where(status == ST_RUN, ST_ERR, status)
    end_pos = torch.where(active, pos + off, 0)
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    return (_as_i32(tok.reshape(-1)), i32(bp.reshape(-1)), i32(cnt), i32(end_pos), i32(status),
            i32(eob_first))
