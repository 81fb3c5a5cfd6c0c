"""Native block emission for the host deflate engine.

Counterpart of tpuzlib/codec/emit_native.py.  The C tokenizer's
per-stripe symbol histograms feed the C emitter: tokenize_full and
emit_chunk_c are the engine's route (codec/deflate_engine.py), with all
O(tokens) work, the trees and the headers in C.  emit_chunk_native and
_emit_leaf are tpuzlib's numpy splitter and tree construction over
tz_emit_tokens: the plain version that the tests hold tz_emit_chunk
against.  Block splitting works on stripe prefix sums, so a split
decision costs O(symbols), not O(tokens).
"""

from __future__ import annotations

import numpy as np

from ..native import bindings
from ..native.api import NATIVE_LEVELS
from . import huffman_encode as he
from .bitsink import BitSink
from .deflate_blocks import MAX_STORED, _body_cost, build_dynamic_trees, emit_block, emit_stored
from .tables import DIST_EXTRA, FIXED_DIST_LENGTHS, FIXED_LITLEN_LENGTHS, LENGTH_EXTRA

STRIPE_TOKENS = 8192


def tokenize_full(data: np.ndarray, ctx_len: int, level: int):
    """Native tokenize of data[ctx_len:] after its context.  Returns the
    tape (litlen, dist), the stripes' literal/length and distance
    histograms (no EOB) and each stripe's cumulative output end."""
    data = np.ascontiguousarray(data)
    n_new = len(data) - ctx_len
    if n_new <= 0:
        return (np.empty(0, np.int32), np.empty(0, np.int32), np.zeros((1, 286), np.int32),
                np.zeros((1, 30), np.int32), np.zeros(1, np.int64))
    nstripes = (n_new + 1 + STRIPE_TOKENS - 1) // STRIPE_TOKENS
    litlen = np.empty(n_new + 1, dtype=np.int32)
    dist = np.empty(n_new + 1, dtype=np.int32)
    lit_freq = np.zeros((nstripes, 286), dtype=np.int32)
    dist_freq = np.zeros((nstripes, 30), dtype=np.int32)
    stripe_out_end = np.zeros(nstripes, dtype=np.int64)
    chain, lazy_thresh, nice, lazy = NATIVE_LEVELS[level]
    ntok = bindings.lib().tz_deflate_tokenize(
        bindings.ptr(data), len(data), ctx_len, chain, lazy_thresh, nice, lazy,
        bindings.ptr(litlen), bindings.ptr(dist), bindings.ptr(lit_freq), bindings.ptr(dist_freq),
        bindings.ptr(stripe_out_end), STRIPE_TOKENS,
    )
    used = max(1, -(-int(ntok) // STRIPE_TOKENS))
    # stripes with no tokens keep out_end 0; make the prefix monotone
    soe = stripe_out_end[:used]
    np.maximum.accumulate(soe, out=soe)
    return litlen[:ntok], dist[:ntok], lit_freq[:used], dist_freq[:used], soe


def emit_chunk_c(litlen: np.ndarray, dist: np.ndarray, lf: np.ndarray, df: np.ndarray,
                 soe: np.ndarray, raw: np.ndarray, last: bool, sync_flush: bool) -> np.ndarray:
    """Whole-chunk emit in one GIL-free native call (tz_emit_chunk): trees,
    headers, adaptive splitting and bit packing all happen in C; the result
    is byte-aligned (sync flush or final padding), so chunks concatenate
    directly.  emit_chunk_native is its plain version."""
    lib = bindings.lib()
    litlen = np.ascontiguousarray(litlen, np.int32)
    dist = np.ascontiguousarray(dist, np.int32)
    lf = np.ascontiguousarray(lf, np.int32)
    df = np.ascontiguousarray(df, np.int32)
    soe = np.ascontiguousarray(soe, np.int64)
    raw = np.ascontiguousarray(raw, np.uint8)
    cap = len(raw) + (len(raw) >> 8) + 4096
    while True:
        out = np.empty(cap, dtype=np.uint8)
        end_bit = lib.tz_emit_chunk(
            bindings.ptr(litlen), bindings.ptr(dist), len(litlen), bindings.ptr(lf),
            bindings.ptr(df), bindings.ptr(soe), len(lf), STRIPE_TOKENS, bindings.ptr(raw),
            len(raw), int(last), int(sync_flush), bindings.ptr(out), cap,
        )
        if end_bit < 0:
            cap *= 2
            continue
        if end_bit % 8:
            raise RuntimeError("chunk emit must end byte-aligned, ended at bit %d" % end_bit)
        return out[: end_bit >> 3]


def _emit_leaf(sink: BitSink, litlen, dist, lf, df, raw, last) -> None:
    """Emit one block: choose format, write headers (python) + body (C)."""
    lf = lf.astype(np.int64)
    df = df.astype(np.int64)
    ll, dl, push_header = build_dynamic_trees(lf, df)
    dyn_body = _body_cost(lf, df, ll, dl)
    static_body = _body_cost(lf, df, FIXED_LITLEN_LENGTHS, FIXED_DIST_LENGTHS[:30])
    align_pad = (-(sink.total_bits + 3)) % 8
    nstored = max(1, -(-len(raw) // MAX_STORED))
    stored_total = 3 * nstored + align_pad + 32 * nstored + 8 * len(raw) + 5 * (nstored - 1)
    # dynamic header cost via a probe sink
    probe = BitSink()
    push_header(probe)
    dyn_total = 3 + probe.total_bits + dyn_body
    static_total = 3 + static_body

    if len(raw) and stored_total < min(dyn_total, static_total):
        emit_stored(sink, raw, last)
        return

    sink.push_scalar(1 if last else 0, 1)
    if static_total <= dyn_total:
        sink.push_scalar(1, 2)
        use_ll, use_dl = FIXED_LITLEN_LENGTHS, FIXED_DIST_LENGTHS[:30]
        body_bits = static_body
    else:
        sink.push_scalar(2, 2)
        push_header(sink)
        use_ll, use_dl = ll, dl
        body_bits = dyn_body

    cap = (body_bits >> 3) + 16
    buf = np.zeros(cap, dtype=np.uint8)
    ll_pad = np.zeros(288, np.int32)
    ll_pad[: len(use_ll)] = use_ll
    lc_pad = np.zeros(288, np.uint32)
    lc_pad[: len(use_ll)] = he.canonical_codes_lsb(use_ll)
    dl_pad = np.zeros(30, np.int32)
    dl_pad[: len(use_dl)] = use_dl
    dc_pad = np.zeros(30, np.uint32)
    dc_pad[: len(use_dl)] = he.canonical_codes_lsb(use_dl)
    litlen = np.ascontiguousarray(litlen, np.int32)
    dist = np.ascontiguousarray(dist, np.int32)
    end_bit = bindings.lib().tz_emit_tokens(
        bindings.ptr(litlen), bindings.ptr(dist), len(litlen), bindings.ptr(ll_pad),
        bindings.ptr(lc_pad), bindings.ptr(dl_pad), bindings.ptr(dc_pad), bindings.ptr(buf), cap, 0,
    )
    if end_bit < 0:
        raise RuntimeError("native emit overflow (cost model bug)")
    nfull = int(end_bit) >> 3
    if nfull:
        sink.push_bytes(buf[:nfull])
    rem = int(end_bit) & 7
    if rem:
        sink.push_scalar(int(buf[nfull]) & ((1 << rem) - 1), rem)


def emit_chunk_native(sink: BitSink, litlen: np.ndarray, dist: np.ndarray, lf: np.ndarray,
                      df: np.ndarray, soe: np.ndarray, raw: np.ndarray, last: bool,
                      max_stripes_per_block: int = 8) -> None:
    """Emit a chunk's tokens as adaptively-split blocks (stripe granular)."""
    lf_prefix = np.zeros((len(lf) + 1, 286), np.int64)
    np.cumsum(lf, axis=0, out=lf_prefix[1:])
    df_prefix = np.zeros((len(df) + 1, 30), np.int64)
    np.cumsum(df, axis=0, out=df_prefix[1:])

    def seg_freqs(s0, s1):
        lfx = lf_prefix[s1] - lf_prefix[s0]
        lfx[256] += 1  # EOB
        return lfx, df_prefix[s1] - df_prefix[s0]

    def seg_cost(s0, s1):
        """Entropy-based cost estimate (split decisions only; the final
        emit still builds exact package-merge trees)."""
        lfx, dfx = seg_freqs(s0, s1)
        bits = 0.0
        for freq in (lfx, dfx):
            tot = freq.sum()
            if tot:
                nz = freq[freq > 0].astype(np.float64)
                bits += float((nz * np.log2(tot / nz)).sum())
        bits += float((lfx[257:286] * LENGTH_EXTRA).sum())
        bits += float((dfx * DIST_EXTRA).sum())
        nraw = int(soe[s1 - 1]) - (int(soe[s0 - 1]) if s0 else 0)
        stored = 40 + 8 * nraw
        return min(int(bits) + 250, stored)  # +tree header estimate

    def emit_range(s0, s1, seg_last, known=None):
        if s1 - s0 > 1:
            if s1 - s0 > max_stripes_per_block:
                mid = (s0 + s1) // 2
                emit_range(s0, mid, False)
                emit_range(mid, s1, seg_last)
                return
            if known is None:
                known = seg_cost(s0, s1)
            mid = (s0 + s1) // 2
            ca = seg_cost(s0, mid)
            cb = seg_cost(mid, s1)
            if ca + cb + 1024 < known:
                emit_range(s0, mid, False, ca)
                emit_range(mid, s1, seg_last, cb)
                return
        t0 = s0 * STRIPE_TOKENS
        t1 = min(s1 * STRIPE_TOKENS, len(litlen))
        r0 = int(soe[s0 - 1]) if s0 else 0
        r1 = int(soe[s1 - 1])
        lfx, dfx = seg_freqs(s0, s1)
        _emit_leaf(sink, litlen[t0:t1], dist[t0:t1], lfx, dfx, raw[r0:r1], seg_last)

    if len(litlen) == 0:
        if last:
            emit_block(sink, np.empty(0, np.int32), np.empty(0, np.int32),
                       np.empty(0, np.uint8), True)
        return
    emit_range(0, len(lf), last)
