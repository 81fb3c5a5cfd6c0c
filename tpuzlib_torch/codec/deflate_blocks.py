"""DEFLATE block emission: choose stored/static/dynamic per block and
write it through a BitSink.

A copy of tpuzlib/codec/deflate_blocks.py.  The native host engine
emits in C (tz_emit_chunk); these serve codec/emit_native.py's plain
emit (build_dynamic_trees and _body_cost for its leaves, emit_stored, and
emit_block for an empty final block) and, with the native library
switched off, the numpy engine (codec/deflate_engine.py), which emits
each block through emit_block_adaptive: one block, or two where the
estimated cost (_segment_cost) of two trees is lower.
"""

from __future__ import annotations

import numpy as np

from . import huffman_encode as he
from .bitsink import BitSink
from .tables import (CLC_ORDER, DIST_EXTRA, FIXED_DIST_LENGTHS, FIXED_LITLEN_LENGTHS,
                     LENGTH_EXTRA)

MAX_STORED = 65535


def _force_two_codes(lengths: np.ndarray) -> np.ndarray:
    """Ensure at least two nonzero code lengths (a complete 1-bit tree)."""
    used = np.flatnonzero(lengths > 0)
    if len(used) >= 2:
        return lengths
    lengths = lengths.copy()
    if len(used) == 1:
        lengths[used[0]] = 1
        extra = 0 if used[0] != 0 else 1
        lengths[extra] = 1
    else:
        lengths[0] = 1
        lengths[1] = 1
    return lengths


def _body_cost(lit_freq, dist_freq, ll, dl) -> int:
    """Histogram-based block body cost (incl. EOB and extra bits)."""
    bits = int((lit_freq * ll[:286]).sum())
    bits += int((lit_freq[257:286] * LENGTH_EXTRA).sum())
    bits += int((dist_freq * dl[:30]).sum())
    bits += int((dist_freq * DIST_EXTRA).sum())
    return bits


def _push_tokens(
    sink: BitSink,
    lsym,
    lext_val,
    lext_bits,
    dsym,
    dext_val,
    dext_bits,
    is_match,
    ll,
    dl,
    lcodes,
    dcodes,
):
    lnb = ll[lsym].astype(np.int64)
    v = lcodes[lsym].astype(np.uint64)
    nb = lnb.copy()
    v |= lext_val.astype(np.uint64) << nb.astype(np.uint64)
    nb += lext_bits
    dnb = np.where(is_match, dl[dsym], 0).astype(np.int64)
    v |= np.where(is_match, dcodes[dsym], 0).astype(np.uint64) << nb.astype(np.uint64)
    nb += dnb
    v |= np.where(is_match, dext_val, 0).astype(np.uint64) << nb.astype(np.uint64)
    nb += np.where(is_match, dext_bits, 0)
    sink.push(v, nb)
    sink.push_scalar(int(lcodes[256]), int(ll[256]))  # EOB


def _push_tree_header(sink, hlit, hdist, hclen, cl_len, cl_syms, cl_ev, cl_eb):
    sink.push_scalar(hlit - 257, 5)
    sink.push_scalar(hdist - 1, 5)
    sink.push_scalar(hclen - 4, 4)
    clc_in_order = cl_len[CLC_ORDER[:hclen]]
    sink.push(clc_in_order.astype(np.uint64), np.full(hclen, 3, dtype=np.int64))
    cl_codes = he.canonical_codes_lsb(cl_len)
    v = cl_codes[cl_syms].astype(np.uint64)
    nb = cl_len[cl_syms].astype(np.int64)
    v |= cl_ev.astype(np.uint64) << nb.astype(np.uint64)
    sink.push(v, nb + cl_eb)


def build_dynamic_trees(lit_freq: np.ndarray, dist_freq: np.ndarray):
    """Tree build + header fields from histograms.  Returns (ll, dl, header_pusher) where
    header_pusher(sink) writes HLIT..code-length stream."""
    ll = _force_two_codes(he.package_merge(lit_freq, 15))
    dl = _force_two_codes(he.package_merge(dist_freq, 15))
    hlit = max(int(np.flatnonzero(ll > 0).max()) + 1, 257)
    hdist = max(int(np.flatnonzero(dl > 0).max()) + 1, 1)
    all_lengths = np.concatenate([ll[:hlit], dl[:hdist]])
    cl_syms, cl_ev, cl_eb = he.codelen_rle(all_lengths)
    cl_freq = np.bincount(cl_syms, minlength=19)
    cl_len = _force_two_codes(he.package_merge(cl_freq, 7))
    order_pos = np.zeros(19, dtype=np.int64)
    order_pos[CLC_ORDER] = np.arange(19)
    hclen = max(int(order_pos[np.flatnonzero(cl_len > 0)].max()) + 1, 4)

    def pusher(sink):
        _push_tree_header(sink, hlit, hdist, hclen, cl_len, cl_syms, cl_ev, cl_eb)

    return ll, dl, pusher


def emit_stored(sink: BitSink, raw: np.ndarray, last: bool) -> None:
    """One or more stored blocks covering raw bytes."""
    n = len(raw)
    off = 0
    while True:
        take = min(n - off, MAX_STORED)
        final_piece = off + take == n
        sink.push_scalar(1 if (last and final_piece) else 0, 1)
        sink.push_scalar(0, 2)  # BTYPE=00
        sink.align_byte()
        sink.push_scalar(take, 16)
        sink.push_scalar(take ^ 0xFFFF, 16)
        if take:
            sink.push(
                raw[off : off + take].astype(np.uint64),
                np.full(take, 8, dtype=np.int64),
            )
        off += take
        if final_piece:
            break


def _segment_cost(lit_freq: np.ndarray, dist_freq: np.ndarray, nraw: int) -> int:
    """Estimated best-format bit cost of a token segment (header incl.)."""
    ll = _force_two_codes(he.package_merge(lit_freq, 15))
    dl = _force_two_codes(he.package_merge(dist_freq, 15))
    hlit = max(int(np.flatnonzero(ll > 0).max()) + 1, 257)
    hdist = max(int(np.flatnonzero(dl > 0).max()) + 1, 1)
    cl_syms, _, cl_eb = he.codelen_rle(np.concatenate([ll[:hlit], dl[:hdist]]))
    cl_freq = np.bincount(cl_syms, minlength=19)
    cl_len = _force_two_codes(he.package_merge(cl_freq, 7))
    dyn = (3 + 14 + 3 * 19 + int(cl_len[cl_syms].sum()) + int(cl_eb.sum())
           + _body_cost(lit_freq, dist_freq, ll, dl))
    static = 3 + _body_cost(lit_freq, dist_freq, FIXED_LITLEN_LENGTHS, FIXED_DIST_LENGTHS[:30])
    stored = 40 + 8 * nraw + 35 * max(0, (nraw - 1) // MAX_STORED)
    return min(dyn, static, stored)


def emit_block_adaptive(sink: BitSink, litlen: np.ndarray, dist: np.ndarray, raw: np.ndarray,
                        last: bool, min_symbols: int = 8192,
                        _known_cost: int | None = None) -> None:
    """Emit tokens as one block, or split them in two halves (each again
    split the same way) where the two trees' estimated cost, plus a
    margin of 1,024 bits, is below one tree's: a text|random transition
    compresses better in two blocks.  Each level reuses its parent's cost
    of the segment."""
    n = len(litlen)
    if n <= 2 * min_symbols:
        emit_block(sink, litlen, dist, raw, last)
        return
    is_match = dist > 0
    lsym = np.where(is_match, he.length_to_code(np.maximum(litlen, 3)), litlen)
    dsym = np.where(is_match, he.dist_to_code(np.maximum(dist, 1)), 0)

    def freqs(lo, hi):
        lf = np.bincount(lsym[lo:hi], minlength=286)[:286].astype(np.int64)
        lf[256] += 1
        seg_m = is_match[lo:hi]
        df = (np.bincount(dsym[lo:hi][seg_m], minlength=30)[:30].astype(np.int64)
              if seg_m.any() else np.zeros(30, np.int64))
        return lf, df

    out_lens = np.where(is_match, litlen, 1).astype(np.int64)
    ends = np.cumsum(out_lens)
    mid = n // 2
    if _known_cost is None:
        lf_w, df_w = freqs(0, n)
        _known_cost = _segment_cost(lf_w, df_w, len(raw))
    lf_a, df_a = freqs(0, mid)
    lf_b, df_b = freqs(mid, n)
    raw_mid = int(ends[mid - 1])
    cost_a = _segment_cost(lf_a, df_a, raw_mid)
    cost_b = _segment_cost(lf_b, df_b, len(raw) - raw_mid)
    if cost_a + cost_b + 1024 < _known_cost:
        emit_block_adaptive(sink, litlen[:mid], dist[:mid], raw[:raw_mid], False, min_symbols,
                            cost_a)
        emit_block_adaptive(sink, litlen[mid:], dist[mid:], raw[raw_mid:], last, min_symbols,
                            cost_b)
    else:
        emit_block(sink, litlen, dist, raw, last)


def emit_block(
    sink: BitSink,
    litlen: np.ndarray,
    dist: np.ndarray,
    raw: np.ndarray,
    last: bool,
) -> None:
    """Emit one block of tokens, choosing the cheapest legal format.

    raw: the original bytes this token slice encodes (for the stored
    option)."""
    lsym, lext_val, lext_bits, dsym, dext_val, dext_bits = he.token_symbols(
        litlen, dist
    )
    is_match = dist > 0
    lit_freq, dist_freq = he.block_histograms(lsym, dsym, is_match)

    # --- dynamic trees ---
    ll = _force_two_codes(he.package_merge(lit_freq, 15))
    dl = _force_two_codes(he.package_merge(dist_freq, 15))
    hlit = max(int(np.flatnonzero(ll > 0).max()) + 1, 257)
    hdist = max(int(np.flatnonzero(dl > 0).max()) + 1, 1)
    all_lengths = np.concatenate([ll[:hlit], dl[:hdist]])
    cl_syms, cl_ev, cl_eb = he.codelen_rle(all_lengths)
    cl_freq = np.bincount(cl_syms, minlength=19)
    cl_len = _force_two_codes(he.package_merge(cl_freq, 7))
    order_pos = np.zeros(19, dtype=np.int64)
    order_pos[CLC_ORDER] = np.arange(19)
    hclen = max(int(order_pos[np.flatnonzero(cl_len > 0)].max()) + 1, 4)

    dyn_header = (
        5 + 5 + 4 + 3 * hclen + int(cl_len[cl_syms].sum()) + int(cl_eb.sum())
    )
    dyn_cost = dyn_header + _body_cost(lit_freq, dist_freq, ll, dl)

    # --- static cost ---
    sl = FIXED_LITLEN_LENGTHS
    sd = FIXED_DIST_LENGTHS[:30]
    static_cost = _body_cost(lit_freq, dist_freq, sl, sd)

    # --- total costs incl. the 3-bit block header ---
    align_pad = (-(sink.total_bits + 3)) % 8
    nblocks_stored = max(1, -(-len(raw) // MAX_STORED))
    stored_total = (
        3 * nblocks_stored + align_pad + 32 * nblocks_stored + 8 * len(raw) + 5 * (nblocks_stored - 1)
    )
    dyn_total = 3 + dyn_cost
    static_total = 3 + static_cost

    if len(raw) and stored_total < min(dyn_total, static_total):
        emit_stored(sink, raw, last)
        return

    sink.push_scalar(1 if last else 0, 1)
    if static_cost <= dyn_cost:
        sink.push_scalar(1, 2)  # BTYPE=01
        lcodes = he.canonical_codes_lsb(sl)
        dcodes = he.canonical_codes_lsb(sd)
        _push_tokens(
            sink, lsym, lext_val, lext_bits, dsym, dext_val, dext_bits,
            is_match, sl, sd, lcodes, dcodes,
        )
        return

    sink.push_scalar(2, 2)  # BTYPE=10
    _push_tree_header(sink, hlit, hdist, hclen, cl_len, cl_syms, cl_ev, cl_eb)
    lcodes = he.canonical_codes_lsb(ll)
    dcodes = he.canonical_codes_lsb(dl)
    _push_tokens(
        sink, lsym, lext_val, lext_bits, dsym, dext_val, dext_bits,
        is_match, ll, dl, lcodes, dcodes,
    )
