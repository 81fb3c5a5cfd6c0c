"""Batched dynamic-Huffman device deflate encoder (the port's main path).

Counterpart of tpuzlib/kernels/deflate_device3.py.  The function that
`make_encode_batch_v3` returns encodes a whole batch of chunks, dynamic
trees included, and gives (words, total_bits, ok) with the same values
as tpuzlib's program on the same input:

  1. match search over the flat batch's bytes: the near-band screen and
     two hash-probe screens (stable sort by chunk-tagged hash, then the
     far screen, which writes each row's key back by position in place),
     then the d-chain recurrence and the residual extension of
     chain-broken >= 16-byte matches;
  2. the lazy rule, the SEG-forced token breaks and the segment parse;
  3. token compaction to (B, T_CAP), histograms, package-merge trees,
     canonical codes and the RLE'd dynamic header;
  4. per-token bit fields and the bit pack of head3 | header | tokens into
     each chunk's words (pack_words: one kernel for both).

The four kernels (near / far screen, segment parse, pack words) run on
a CUDA tensor; on a CPU tensor each wrapper runs its plain version.  The
device of the input decides; there is no switch and no fallback.  No step
reads a value back to the host or uploads one from it, so a batch is
enqueued without a sync (chip_smoke.py's phase N3 runs one under
torch.cuda.set_sync_debug_mode("error")).

Telemetry (utils/trace.py): while it is on, the encoder adds the count
of chain-broken matches past the extension's cap into the device-resident
counter `deflate.ext_cap_overflow` (tpuzlib counts it through a
jax.debug.callback under TPUZLIB_TRACE_EXT=1), which only
trace.get_counters() reads back; while it is off, the encoder's ops are
unchanged.  deflate_device_v3 runs its phases as the stages
deflate.layout (batch layout and upload), deflate.encode_batch (one a
batch: the encoder's enqueue, split into the stages deflate.encode.match,
.parse, .trees and .pack), deflate.pull (the results' read back) and
deflate.join (the host bit join; the last one holds deflate.flush, the
final flush of the bit sink), and counts the bytes it uploads and reads
back as copy.h2d_bytes and copy.d2h_bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.bitsink import BitSink
from ..codec.tables import CLC_ORDER, LEVELS, MAX_MATCH, MIN_MATCH, TOO_FAR, WINDOW_SIZE
from ..common import u8_view
from ..utils import trace
from . import _build
from .deflate_device import CTX, SEG, _push_words, sym_fields_v2
from .huffman_device import canonical_codes_device, package_merge_device
from .parse import segment_parse
from .screen import _prefix16, far_screen, near_screen, window_words

# per-level knobs: near-band depth, 4-byte probe depth, 6-byte probe depth
LEVELS_V3 = {
    1: dict(nd=8, k4=6, k6=0),
    2: dict(nd=8, k4=8, k6=0),
    3: dict(nd=12, k4=12, k6=0),
    4: dict(nd=16, k4=12, k6=0),
    5: dict(nd=16, k4=16, k6=0),
    6: dict(nd=24, k4=24, k6=8),
    7: dict(nd=24, k4=24, k6=8),
    8: dict(nd=32, k4=32, k6=16),
    9: dict(nd=32, k4=48, k6=24),
}

_M32 = 0xFFFFFFFF
NUM_LIT = 286
NUM_DIST = 30
# the token cap is a multiple of this; it decides `ok`, so it is kept as
# tpuzlib sizes it
T_CAP_ALIGN = 4096
HDRF = 338  # 3 + 19 + 316 header fields
PACK_TILE = 2048  # fields a block of pack_words' kernels takes (csrc/pack_fields.cu: kTile)
# the extension loop walks 16 bytes a step from offset 16 up to MAX_MATCH
_EXT_STEPS = -(-MAX_MATCH // 16)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) and c < 2^32, with every
    partial product below 2^48."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _M32


def _hash_k(w0: torch.Tensor, w1: torch.Tensor, nbytes: int, bits: int) -> torch.Tensor:
    """Multiplicative hash of the next 4 or 6 bytes, `bits` wide (int32)."""
    C1, C2 = 0x9E3779B1, 0x85EBCA77
    v = _mul32(w0.to(torch.int64) & _M32, C1)
    if nbytes == 6:
        v = (v + (w1.to(torch.int64) & 0xFFFF) * C2) & _M32
    return (_mul32(v, C1) >> (32 - bits)).to(torch.int32)


# hash probes: (bytes hashed, hash bits); their depths are LEVELS_V3's k4 / k6
PROBES = ((4, 16), (6, 18))


def probe_rows(ws, mincand, chid, nbytes: int, bits: int):
    """The far screen's rows for one hash probe: the positions stably
    sorted by chunk-tagged hash.  Returns (sorted hash int32, permutation
    int64)."""
    pos = torch.arange(ws[0].shape[0], dtype=torch.int32, device=ws[0].device)
    # invalid candidate positions (unfilled context) take a unique sentinel
    # hash: they never match, so the far screen needs no validity input
    hc = torch.where(pos >= mincand, _hash_k(ws[0], ws[1], nbytes, bits) | (chid << bits),
                     (1 << 28) + pos)
    return torch.sort(hc, stable=True)


def match_lengths_v3(data, lim16, limit, mincand, chid, level: int):
    """Flat-batched match search over `total = B*(ctx+N)` positions.

    data: (total,) uint8; lim16/limit: per-position caps (16 / MAX_MATCH);
    mincand: lowest valid candidate position per position; chid:
    per-position chunk id.  Returns (length, dist) int32 arrays over all
    positions."""
    params = LEVELS_V3[level]
    ws = window_words(data)
    best = near_screen(data, mincand, lim16, params["nd"])
    for nbytes, bits in PROBES:
        k = params["k%d" % nbytes]
        if k:
            sh, perm = probe_rows(ws, mincand, chid, nbytes, bits)
            far_screen(sh, perm, data, best, k)  # in place, by position
    return lengths_from_keys(best, ws, lim16, limit, chid)


def lengths_from_keys(best, ws, lim16, limit, chid):
    """(length, dist) from the screens' best keys by position: the d-chain
    recurrence over 16-byte links and the residual extension of
    chain-broken >= 16-byte matches."""
    total = best.shape[0]
    dev = best.device

    def zeros(n):
        return torch.zeros(n, dtype=torch.int32, device=dev)

    pos = torch.arange(total, dtype=torch.int32, device=dev)
    sc = torch.minimum(best >> 16, lim16)
    d = torch.where((best > 0) & (sc >= MIN_MATCH), 0xFFFF - (best & 0xFFFF), 0)
    sc = torch.where(d > 0, sc, 0)

    # --- d-chain: segmented suffix scan over stride-16 links ---------------
    d16 = torch.cat([d[16:], zeros(16)])
    ch16 = torch.cat([chid[16:], torch.full((16,), -1, dtype=chid.dtype, device=dev)])
    link = (sc >= 16) & (d > 0) & (d16 == d) & (ch16 == chid)

    # --- residual extension: >= 16 screens whose chain breaks --------------
    # The first ext_cap such positions in position order are extended; the
    # rest keep their 16-byte chain value.  The cap changes the bytes.
    need = (sc >= 16) & (d > 0) & ~link & (limit > 16)
    ext_cap = max(1024, total // 256)
    if trace.telemetry_enabled():
        # positions past the cap: a ratio regression is attributable
        trace.count_on_device("deflate.ext_cap_overflow",
                              torch.clamp(need.sum() - ext_cap, min=0))
    rank = torch.cumsum(need, 0) - 1
    slot = torch.where(need & (rank < ext_cap), rank, ext_cap)
    epos = torch.full((ext_cap + 1,), total, dtype=torch.int64, device=dev)
    epos.scatter_(0, slot, pos.to(torch.int64))  # slot ext_cap collects the rest
    epos = epos[:ext_cap]
    evalid = epos < total
    epos_c = torch.where(evalid, epos, 0)
    edist = torch.where(evalid, d[epos_c], 1)
    elim = torch.where(evalid, limit[epos_c], 0)

    # a bounded loop with a done mask: once done, an entry never changes
    off = 16
    done = ~evalid
    elen = torch.full_like(edist, 16)
    for _ in range(_EXT_STEPS):
        p = torch.clamp(epos_c + off, max=total - 1)
        c = torch.clamp(epos_c - edist + off, max=total - 1)
        pl16 = _prefix16([w[p] for w in ws], [w[c] for w in ws])
        pl16 = torch.minimum(torch.clamp(pl16, min=0), elim - off)
        elen = torch.where(done, elen, off + pl16)
        done = done | (pl16 < 16) | (off + 16 >= elim) | (off + 16 > MAX_MATCH)
        off += 16
    elen = torch.where(evalid, torch.minimum(elen, torch.clamp(elim, max=MAX_MATCH)), 16)
    base = torch.where(sc >= 16, 16, sc)
    base = base.scatter_reduce(0, epos_c, torch.where(evalid, elen, 0), "amax")

    # segmented suffix recurrence: ml[i] = base[i] + link[i] * ml[i+16],
    # clipped to MAX_MATCH; every linked step adds >= 16, so 17 steps
    # saturate any chain (16 + 16*17 > 258)
    gi = link.to(torch.int32)
    ml = base
    for _ in range(17):
        ml = torch.clamp(base + gi * torch.cat([ml[16:], zeros(16)]), max=MAX_MATCH)
    length = torch.minimum(ml, torch.clamp(limit, max=MAX_MATCH))
    length = torch.where((d > 0) & (length >= MIN_MATCH), length, 0)
    length = torch.where((length == MIN_MATCH) & (d > TOO_FAR), 0, length)
    return length, d


def batch_layout(B, ctx, N, ctx_valids, n_valids):
    """Per-position metadata of the flat batch of B rows of ctx+N bytes:
    (lim16, limit, mincand, chid) as flat int32 arrays, in the order
    match_lengths_v3 takes them."""
    stride = ctx + N
    total = B * stride
    i32 = dict(dtype=torch.int32, device=ctx_valids.device)
    gpos = torch.arange(total, **i32).reshape(B, stride)
    cb = gpos[:, :1]  # first position of each row
    ev2 = cb + ctx + n_valids[:, None]  # end of valid data per row
    lim16 = torch.clamp(ev2 - gpos, 0, 16).reshape(total)
    limit = torch.clamp(ev2 - gpos, 0, MAX_MATCH).reshape(total)
    mincand = (cb[:, 0] + ctx - ctx_valids).repeat_interleave(stride)
    chid = torch.arange(B, **i32).repeat_interleave(stride)
    return lim16, limit, mincand, chid


def match_tape(B, ctx, N, data, ctx_valids, n_valids, level):
    """The match search over the flat batch: (length, dist) int32 over all
    B*(ctx+N) positions."""
    return match_lengths_v3(
        data.reshape(B * (ctx + N)), *batch_layout(B, ctx, N, ctx_valids, n_valids), level)


def parse_tape(B, ctx, N, data, ctx_valids, n_valids, level, match=None):
    """Match search, the lazy rule and the forced token breaks over the flat
    batch: (eff, step, dist) as (B, N) int32, where eff is each position's
    match length (0: a literal) and step the segment parse's step tape.
    match: match_tape's result, where the caller has run it."""
    stride = ctx + N
    i32 = dict(dtype=torch.int32, device=data.device)
    length, dist = match or match_tape(B, ctx, N, data, ctx_valids, n_valids, level)

    # new-position domain (B, N)
    length = length.reshape(B, stride)[:, ctx:]
    dist = dist.reshape(B, stride)[:, ctx:]

    eff = length
    if LEVELS[level].lazy:
        nxt = torch.cat([length[:, 1:], torch.zeros(B, 1, **i32)], 1)
        defer = (eff >= MIN_MATCH) & (eff < LEVELS[level].max_lazy) & (nxt > eff)
        eff = torch.where(defer, 0, eff)

    room = SEG - torch.arange(N, **i32) % SEG
    effT = torch.minimum(eff, room[None, :])
    eff = torch.where(effT >= MIN_MATCH, effT, 0)
    step = torch.where(eff >= MIN_MATCH, eff, 1)
    return eff, step, dist


def _tokens_v3(B, ctx, N, data, ctx_valids, n_valids, level, match=None):
    """Match + lazy + segment parse over the flat batch (match: as
    parse_tape's).

    data: (B, ctx+N) uint8.  Returns (starts bool, litlen, dist) as (B, N)."""
    i32 = dict(dtype=torch.int32, device=data.device)
    eff, step, dist = parse_tape(B, ctx, N, data, ctx_valids, n_valids, level, match)
    # the parse treats the flat array as one stream; SEG divides N, so
    # segment starts align with chunk starts, and per-chunk n_valid masking
    # happens here
    starts = segment_parse(step.reshape(B * N), B * N, seg=SEG).reshape(B, N)
    starts = starts & (torch.arange(N, **i32)[None, :] < n_valids[:, None])
    is_tok = starts & (eff >= MIN_MATCH)
    litlen = torch.where(is_tok, eff, data[:, ctx:].to(torch.int32))
    dists = torch.where(is_tok, dist, 0)
    return starts, litlen, dists


# ---------------------------------------------------------------------------
# pack: token -> field (lo, hi, nb), and the fields -> packed words
# ---------------------------------------------------------------------------


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_fields_plain(tok, lcodes, lbits, dcodes, dbits):
    tok = tok.to(torch.int64)
    litlen = tok & 0x1FF
    is_match = ((tok >> 9) & 1) == 1
    dist = torch.where(is_match, (tok >> 10) + 1, 0)
    lsym, lext, lext_val, dsym, dext, dext_val = sym_fields_v2(litlen, dist, is_match)
    # symbols outside the tables (pad token 511) take code 0, length 0
    lin = lsym < NUM_LIT
    lsym_c = torch.where(lin, lsym, 0)
    lc = torch.where(lin, lcodes.to(torch.int64).gather(1, lsym_c), 0)
    lb = torch.where(lin, lbits.to(torch.int64).gather(1, lsym_c), 0)
    din = is_match & (dsym < NUM_DIST)
    dsym_c = torch.where(din, dsym, 0)
    dc = torch.where(din, dcodes.to(torch.int64).gather(1, dsym_c), 0)
    db = torch.where(din, dbits.to(torch.int64).gather(1, dsym_c), 0)
    f = lc | (lext_val << lb) | (dc << (lb + lext)) | (dext_val << (lb + lext + db))
    nb = lb + lext + db + dext
    return _as_i32(f & _M32), _as_i32(f >> 32), nb.to(torch.int32)


def pack_words_plain(tok, lcodes, lbits, dcodes, dbits, eob_at, hdr_vals, hdr_bits, lasts,
                     out_words: int):
    """The plain version of pack_words: the token fields (pack_fields_plain)
    and the bit pack of the field stream head3 | header | tokens."""
    B, T = tok.shape
    dev = tok.device
    i64 = dict(dtype=torch.int64, device=dev)
    tok = torch.where(torch.arange(T, device=dev)[None, :] > eob_at[:, None], 511, tok)
    lo_t, hi_t, nb_t = pack_fields_plain(tok, lcodes, lbits, dcodes, dbits)
    all_lo = torch.cat([(4 | lasts.to(torch.int64))[:, None], hdr_vals, lo_t.to(torch.int64) & _M32], 1)
    all_hi = torch.cat([torch.zeros(B, 1 + HDRF, **i64), hi_t.to(torch.int64) & _M32], 1)
    all_nb = torch.cat([torch.full((B, 1), 3, **i64), hdr_bits, nb_t.to(torch.int64)], 1)
    offsets = torch.cumsum(all_nb, 1) - all_nb
    total_bits = offsets[:, -1] + all_nb[:, -1]

    # each field lands in up to three words; pieces in one word are
    # disjoint, so their sum is their OR.  Indices are clipped to the
    # out_words window, as in tpuzlib.
    idx = offsets >> 5
    sh = offsets & 31
    p0 = (all_lo << sh) & _M32
    p1 = (torch.where(sh > 0, all_lo >> (32 - sh), 0) | (all_hi << sh)) & _M32
    p2 = torch.where(sh > 0, all_hi >> (32 - sh), 0)
    wb = torch.arange(B, **i64)[:, None] * out_words
    widx = torch.cat([wb + torch.clamp(idx + s, max=out_words - 1) for s in range(3)], 1)
    words = torch.zeros(B * out_words, **i64)
    words.index_add_(0, widx.reshape(-1), torch.cat([p0, p1, p2], 1).reshape(-1))
    return (words & _M32).reshape(B, out_words), total_bits


def pack_words(tok, lcodes, lbits, dcodes, dbits, eob_at, hdr_vals, hdr_bits, lasts,
               out_words: int):
    """Each chunk's packed bits: head3 (3 bits: 4 | last), the dynamic
    header's fields, then its tokens' LSB-first Huffman fields, one after
    another from bit 0 of word 0.

    tok: (B, T) int32 tokens `litlen | is_match << 9 | (dist - 1) << 10`,
    the EOB (256) at eob_at (B,) int64 and pads (511) after it, which are
    taken as pads whatever they hold; lcodes/lbits: (B, 286) and
    dcodes/dbits: (B, 30) int32 per-chunk code tables (bit-reversed codes,
    lengths <= 15); hdr_vals/hdr_bits: (B, 338) int64 header fields, each
    value below 2^32 and its width at most 64; lasts: (B,) int32, 0 or 1.
    Returns (words int64 (B, out_words) holding u32 values, total_bits
    int64 (B,)); the pieces of bits past the last word are added into it,
    mod 2^32.  On a CUDA tensor it launches csrc/pack_fields.cu's two
    kernels, on a CPU tensor it runs pack_words_plain."""
    if _build.on_cpu(tok):
        return pack_words_plain(tok, lcodes, lbits, dcodes, dbits, eob_at, hdr_vals, hdr_bits,
                                lasts, out_words)
    B, T = tok.shape
    dev = tok.device
    _build.check_inputs("pack_words", (B, T), tok)
    _build.check_inputs("pack_words", (B, NUM_LIT), lcodes, lbits, device=dev)
    _build.check_inputs("pack_words", (B, NUM_DIST), dcodes, dbits, device=dev)
    _build.check_inputs("pack_words", (B, HDRF), hdr_vals, hdr_bits, dtype=torch.int64, device=dev)
    _build.check_inputs("pack_words", (B,), eob_at, dtype=torch.int64, device=dev)
    _build.check_inputs("pack_words", (B,), lasts, device=dev)
    if out_words < 1 or (1 + HDRF + T) * 64 >= 1 << 31:
        raise ValueError("pack_words: out_words must be >= 1 and a row's bits below 2^31"
                         " (out_words %d, T %d)" % (out_words, T))
    words = torch.empty((B, out_words), dtype=torch.int64, device=dev)
    total_bits = torch.empty(B, dtype=torch.int64, device=dev)
    if B == 0:
        return words, total_bits
    # each row's tiles' widths (the kernel pads the header to a multiple of
    # 8 fields, so a row has at most T // PACK_TILE + 2 tiles)
    sums = torch.empty(B * (T // PACK_TILE + 2), dtype=torch.int32, device=dev)
    _build.launch(
        "pack_words", "tz_pack_words", dev,
        *(t.data_ptr() for t in (tok, lcodes, lbits, dcodes, dbits, eob_at, hdr_vals, hdr_bits,
                                 lasts, words, total_bits, sums)),
        T, B, out_words,
    )
    return words, total_bits


# ---------------------------------------------------------------------------
# the full batched encoder
# ---------------------------------------------------------------------------


def token_cap(chunk: int) -> int:
    return max(T_CAP_ALIGN, (chunk // 2 // T_CAP_ALIGN) * T_CAP_ALIGN)


def out_words_for(chunk: int) -> int:
    return min(chunk + 4, (chunk * 10) // 32 + 64)


def _const_rows(vals, rows: int, **kw) -> torch.Tensor:
    """A (rows, len(vals)) tensor whose every row is `vals`, filled on
    its device: the encoder uploads nothing, since a copy from pageable
    host memory makes the host wait until the card has drained."""
    return torch.stack([torch.full((rows,), v, **kw) for v in vals], 1)


def make_encode_batch_v3(level: int, chunk: int, batch: int, out_words: int,
                         ctx: int = CTX, stage: str = "full"):
    """encode(data u8[B, ctx+chunk], ctx_valid i32[B], n_valid i32[B],
    last i32[B], nbytes=0) -> (words int64[B, out_words], total_bits
    i32[B], ok i32[B])

    `words` holds u32 values.  ok[b] == 0 when chunk b overflowed the token
    or output cap (the caller then writes that chunk as stored blocks).
    The phases run as the telemetry stages deflate.encode.match (the
    layout and the match search), .parse (the lazy rule, the segment parse
    and the compaction), .trees (histograms, trees, codes and the header)
    and .pack (pack_words), each with `nbytes`, the batch's input bytes.

    stage: truncate the program after 'tokens' | 'compact' | 'trees' |
    'header' | 'fields' to compare it stage by stage; 'full' (default) is
    the encoder."""
    B, N = batch, chunk
    T_CAP = token_cap(N)

    def encode(data, ctx_valids, n_valids, lasts, nbytes=0):
        dev = data.device
        i64 = dict(dtype=torch.int64, device=dev)
        with trace.timed_stage("deflate.encode.match", nbytes):
            match = match_tape(B, ctx, N, data, ctx_valids, n_valids, level)
        with trace.timed_stage("deflate.encode.parse", nbytes):
            starts, litlen, dist = _tokens_v3(B, ctx, N, data, ctx_valids, n_valids, level, match)
            if stage == "tokens":
                return starts.to(torch.int32), litlen, dist

            # ---- compact tokens to (B, T_CAP) --------------------------------
            # the first T_CAP tokens of each chunk in order, then the EOB
            # (literal-field 256) at min(M, T_CAP-1), then pads of 511
            rank = torch.cumsum(starts, 1) - 1
            M = starts.sum(1)
            pay = (
                litlen
                | ((dist > 0).to(torch.int32) << 9)
                | (torch.clamp(dist - 1, 0, WINDOW_SIZE - 1) << 10)
            )
            rows = torch.arange(B, **i64)[:, None] * T_CAP
            slot = torch.where(starts & (rank < T_CAP), rows + rank, B * T_CAP)
            tok = torch.full((B * T_CAP + 1,), 511, dtype=torch.int32, device=dev)
            tok.scatter_(0, slot.reshape(-1), pay.reshape(-1))  # the last slot collects the rest
            tok = tok[:-1].reshape(B, T_CAP)
            eob_at = torch.clamp(M, max=T_CAP - 1)
            tok.scatter_(1, eob_at[:, None], 256)
            ok = (M + 1 < T_CAP).to(torch.int32)
            if stage == "compact":
                return tok, M.to(torch.int32), ok

        with trace.timed_stage("deflate.encode.trees", nbytes):
            # ---- histograms --------------------------------------------------
            tlit = tok & 0x1FF
            tmatch = (tok >> 9) & 1
            tdist = ((tok >> 10) + 1) * tmatch
            lsym, _, _, dsym, _, _ = sym_fields_v2(tlit, tdist, tmatch == 1)
            lcount = (tlit != 511) & (lsym < NUM_LIT)
            lit_freq = torch.zeros(B, NUM_LIT, **i64).scatter_add_(
                1, torch.where(lcount, lsym, 0).to(torch.int64), lcount.to(torch.int64))
            dcount = (tmatch == 1) & (dsym < NUM_DIST)
            dist_freq = torch.zeros(B, NUM_DIST, **i64).scatter_add_(
                1, torch.where(dcount, dsym, 0).to(torch.int64), dcount.to(torch.int64))

            # ---- trees: one combined (2B, 286) package-merge, the distance
            # rows zero-padded so the force-two rule sees the same width ------
            both = torch.cat([lit_freq, torch.nn.functional.pad(dist_freq, (0, NUM_LIT - NUM_DIST))], 0)
            lens = package_merge_device(both, 15)
            codes = canonical_codes_device(lens)
            ll, dl = lens[:B], lens[B:, :NUM_DIST]
            lcodes, dcodes = codes[:B], codes[B:, :NUM_DIST]
            if stage == "trees":
                return ll, dl, lcodes, dcodes

            # ---- dynamic header fields with RLE (per chunk) ------------------
            # the code-length sequence is RLE'd with symbols 16/17/18; runs
            # never cross the lit/dist tree boundary
            v = torch.cat([ll, dl], 1).to(torch.int64)  # (B, 316)
            P = NUM_LIT + NUM_DIST
            pidx = torch.arange(P, **i64)[None, :]
            prev = torch.cat([torch.full((B, 1), -1, **i64), v[:, :-1]], 1)
            change = (v != prev) | (pidx == 0) | (pidx == NUM_LIT)
            run_start = torch.cummax(torch.where(change, pidx, -1), 1).values
            nxt = torch.cummin(torch.where(change, pidx, P).flip(1), 1).values.flip(1)
            next_change = torch.cat([nxt[:, 1:], torch.full((B, 1), P, **i64)], 1)
            L = next_change - run_start
            j = pidx - run_start
            # zero runs: k full 18x138 pieces, then 18/17/plain by remainder
            kz = L // 138
            rz = L % 138
            n18 = kz + (rz >= 11).to(torch.int64)
            is18 = (v == 0) & (j % 138 == 0) & (j // 138 < n18)
            size18 = torch.clamp(L - j, max=138)
            is17 = (v == 0) & (rz >= 3) & (rz <= 10) & (j == kz * 138)
            isp0 = (v == 0) & (rz >= 1) & (rz <= 2) & (j >= kz * 138)
            # nonzero runs: the first emits the value, the rest are covered by 16s
            m = L - 1
            k6 = m // 6
            r6 = m % 6
            n16 = k6 + (r6 >= 3).to(torch.int64)
            j1 = j - 1
            is16 = (v != 0) & (j >= 1) & (j1 % 6 == 0) & (j1 // 6 < n16)
            size16 = torch.clamp(m - j1, max=6)
            ispv = (v != 0) & ((j == 0) | ((j >= 1) & (r6 >= 1) & (r6 <= 2) & (j1 >= k6 * 6)))
            emit = is18 | is17 | is16 | isp0 | ispv
            sym = torch.where(is18, 18, torch.where(is17, 17,
                              torch.where(is16, 16, torch.where(isp0, 0, v))))
            extra_bits = torch.where(is18, 7, torch.where(is17, 3, torch.where(is16, 2, 0)))
            extra_val = torch.where(
                is18, size18 - 11, torch.where(is17, rz - 3, torch.where(is16, size16 - 3, 0)))

            sym_c = torch.where(emit, sym, 0)
            cl_freq = torch.zeros(B, 19, **i64).scatter_add_(1, sym_c, emit.to(torch.int64))
            cl_len = package_merge_device(cl_freq, 7).to(torch.int64)
            cl_codes = canonical_codes_device(cl_len)
            fbits = cl_len.gather(1, sym_c)
            fval = cl_codes.gather(1, sym_c) | (extra_val << fbits)
            hdr_vals = torch.cat([
                _const_rows((29, 29, 15), B, **i64),  # HLIT, HDIST, HCLEN
                torch.stack([cl_len[:, i] for i in CLC_ORDER], 1),
                torch.where(emit, fval, 0),
            ], 1)  # (B, 338)
            hdr_bits = torch.cat([
                _const_rows((5, 5, 4), B, **i64),
                torch.full((B, 19), 3, **i64),
                torch.where(emit, fbits + extra_bits, 0),
            ], 1)
            if stage == "header":
                return hdr_vals, hdr_bits, ok

        with trace.timed_stage("deflate.encode.pack", nbytes):
            # ---- per-token fields and the bit pack (kernel) -----------------
            tables = (tok, lcodes.to(torch.int32), ll, dcodes.to(torch.int32).contiguous(),
                      dl.contiguous())
            if stage == "fields":
                lo_t, hi_t, nb_t = pack_fields_plain(*tables)
                return lo_t.to(torch.int64) & _M32, hi_t.to(torch.int64) & _M32, nb_t
            words, total_bits = pack_words(*tables, eob_at, hdr_vals, hdr_bits, lasts, out_words)
            ok = ok & (total_bits <= out_words * 32 - 64).to(torch.int32)
            return words, total_bits.to(torch.int32), ok

    return encode


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------


def _push_chunk(sink, words, total_bits, ok, chunk_bytes, is_last, block_bits) -> None:
    """Emit one encoded chunk, or stored blocks when the chunk overflowed
    a cap or is larger than 8 bits a byte plus `block_bits` a stored block
    (plus 8).  tpuzlib's one-shot encoder counts 35 bits a stored block and
    its streaming encoder 40; both are kept, since the choice decides the
    bytes."""
    nv = len(chunk_bytes)
    if ok and int(total_bits) <= 8 * nv + max(1, -(-nv // 65535)) * block_bits + 8:
        _push_words(sink, words, int(total_bits))
    else:
        _push_stored(sink, chunk_bytes, is_last)


def batch_arrays(data: np.ndarray, group, chunk: int, batch: int):
    """The encoder's numpy inputs (bufs, ctx_valid, n_valid, last) for the
    chunks `group` of `data`: each row holds up to CTX bytes of history
    before its chunk; rows past the group are empty."""
    n = len(data)
    nchunks = max(1, -(-n // chunk))
    bufs = np.zeros((batch, CTX + chunk), dtype=np.uint8)
    cv = np.zeros(batch, dtype=np.int32)
    nv = np.zeros(batch, dtype=np.int32)
    lv = np.zeros(batch, dtype=np.int32)
    for bi, ci in enumerate(group):
        lo, hi = ci * chunk, min(ci * chunk + chunk, n)
        ctxb = data[max(0, lo - CTX) : lo]
        bufs[bi, CTX - len(ctxb) : CTX] = ctxb
        bufs[bi, CTX : CTX + hi - lo] = data[lo:hi]
        cv[bi] = len(ctxb)
        nv[bi] = hi - lo
        lv[bi] = ci == nchunks - 1
    return bufs, cv, nv, lv


def deflate_device_v3(data: np.ndarray, level: int = 6, chunk: int = 1 << 18,
                      batch: int = 8, device="cuda") -> np.ndarray:
    """Raw DEFLATE bytes of `data`: the batched encoder on `device`, then
    the host bit join.  Chunks that overflow the encoder's caps, or that
    stored blocks write smaller, become stored blocks."""
    n = len(data)
    nchunks = max(1, -(-n // chunk))
    batch = min(batch, nchunks)
    enc = make_encode_batch_v3(level, chunk, batch, out_words_for(chunk))

    # enqueue every batch, then read the results back
    # (each stage's bytes: the batch's input, or, for the pull, its results)
    results = []
    for g in range(0, nchunks, batch):
        group = range(g, min(g + batch, nchunks))
        nin = min(g * chunk + len(group) * chunk, n) - g * chunk
        with trace.timed_stage("deflate.layout", nin):
            host = batch_arrays(data, group, chunk, batch)
            args = [torch.from_numpy(a).to(device) for a in host]
            trace.count_copy("h2d", device, host)
        with trace.timed_stage("deflate.encode_batch", nin):
            results.append((group, nin, enc(*args, nbytes=nin)))

    sink = BitSink()
    for group, nin, res in results:
        with trace.timed_stage("deflate.pull", res):
            words, total_bits, ok = (t.cpu().numpy() for t in res)
            trace.count_copy("d2h", device, res)
        with trace.timed_stage("deflate.join", nin):
            for bi, ci in enumerate(group):
                lo, hi = ci * chunk, min(ci * chunk + chunk, n)
                _push_chunk(sink, words[bi], total_bits[bi], ok[bi], data[lo:hi],
                            ci == nchunks - 1, 3 + 32)
    with trace.timed_stage("deflate.join"), trace.timed_stage("deflate.flush", n):
        out, _, _ = sink.flush(final=True)
    return out


def _push_stored(sink, chunk_bytes: np.ndarray, is_last: bool) -> None:
    """Emit byte-aligned stored blocks for one chunk."""
    nv = len(chunk_bytes)
    off = 0
    while True:
        blk = min(65535, nv - off)
        final = is_last and (off + blk == nv)
        sink.push_scalar(1 if final else 0, 1)
        sink.push_scalar(0, 2)
        sink.align_byte()
        sink.push_scalar(blk | ((~blk & 0xFFFF) << 16), 32)
        sink.push_bytes(np.asarray(chunk_bytes[off : off + blk]))
        off += blk
        if off >= nv:
            break


class DeviceDeflater:
    """Streaming deflate whose match window stays on the device.

    The last CTX bytes of input live on `device` as a uint8 tensor and are
    carried across append() calls; input is staged into fixed-size chunk
    buffers, and the only host state is the pending input and the
    sub-byte remainder of the emitted stream.

    append(data) -> compressed bytes ready so far (byte-aligned);
    finish() -> final bytes (BFINAL block + padding).

    append keeps its own copy of the input that waits for a later call, so
    a caller may reuse its buffer between calls.  This departs from
    tpuzlib's DeviceDeflater, which keeps a view of the caller's buffer and
    so compresses whatever the buffer holds when the bytes are encoded; the
    bytes written for callers that do not reuse buffers are the same.
    """

    def __init__(self, level: int = 6, chunk: int = 1 << 18, batch: int = 4, device="cuda"):
        self.level = level
        self.chunk = chunk
        self.batch = batch
        self.device = torch.device(device)
        self.out_words = out_words_for(chunk)
        self._enc = make_encode_batch_v3(level, chunk, batch, self.out_words)
        self._ctx = torch.zeros(CTX, dtype=torch.uint8, device=self.device)
        self._ctx_valid = 0
        self._pending = np.empty(0, np.uint8)
        self._sink = BitSink()
        self._finished = False

    def _encode(self, chunks, lasts) -> None:
        """Encode up to `batch` chunks (each `chunk` long, except a final
        short one) in one call and push their bits."""
        B = self.batch
        # built in place on the device: the window rows are copies of the
        # carried context, the data rows one upload per chunk
        bufs = torch.zeros((B, CTX + self.chunk), dtype=torch.uint8, device=self.device)
        cv = np.zeros(B, np.int32)
        nv = np.zeros(B, np.int32)
        lv = np.zeros(B, np.int32)
        for bi, ch in enumerate(chunks):
            bufs[bi, :CTX] = self._ctx
            bufs[bi, CTX : CTX + len(ch)] = torch.from_numpy(np.array(ch)).to(self.device)
            cv[bi] = self._ctx_valid
            nv[bi] = len(ch)
            lv[bi] = lasts[bi]
            # next chunk's context: the tail of (ctx | data)
            self._ctx = bufs[bi, len(ch) : CTX + len(ch)].clone()
            self._ctx_valid = min(CTX, self._ctx_valid + len(ch))
        words, total_bits, ok = (
            t.cpu().numpy()
            for t in self._enc(bufs, *(torch.from_numpy(a).to(self.device) for a in (cv, nv, lv)))
        )
        for bi, ch in enumerate(chunks):
            _push_chunk(self._sink, words[bi], total_bits[bi], ok[bi], ch, bool(lasts[bi]), 40)

    def append(self, data) -> np.ndarray:
        if self._finished:
            raise RuntimeError("DeviceDeflater instances cannot be reused")
        data = np.ascontiguousarray(u8_view(data))
        buf = np.concatenate([self._pending, data]) if len(self._pending) else data
        cut = max(0, (len(buf) - 1) // self.chunk) * self.chunk
        chunks = [buf[lo : lo + self.chunk] for lo in range(0, cut, self.chunk)]
        # what waits for a later call is copied: `buf` may be the caller's
        # buffer, which the caller may reuse once this call returns (the
        # chunks above are encoded before it does)
        self._pending = buf[cut:].copy()
        for i in range(0, len(chunks), self.batch):
            group = chunks[i : i + self.batch]
            self._encode(group, [0] * len(group))
        out, _, _ = self._sink.flush(final=False)
        return out

    def finish(self) -> np.ndarray:
        if self._finished:
            raise RuntimeError("DeviceDeflater instances cannot be reused")
        self._finished = True
        # the (possibly empty) final chunk, masked by n_valid
        self._encode([self._pending], [1])
        self._pending = np.empty(0, np.uint8)
        out, _, _ = self._sink.flush(final=True)
        return out
