"""Device inflate: cursor-parallel speculative decode of a raw DEFLATE stream.

Counterpart of tpuzlib/kernels/inflate_device2.py on its Pallas-tokenizer
path, and its mesh= branch (mesh_decode: the cursors shared among the
ranks of a parallel/mesh.Mesh).  `inflate_device_v2(data, ...)` decodes
a raw DEFLATE stream:

  pass 1          discover the block headers (on a card its header scan,
                  kernels/header_scan.py, whose few candidates the host
                  confirms; on the CPU the host's native scan, or its
                  numpy twin with the native library switched off; then
                  a python walk over the blocks) and lay K cursors
                  over each block's data, one per stride (plan_cursors);
  pass 2 (device) every cursor decodes its own bit range into a token
                  tape (kernels/inflate_cuda.py, one CUDA kernel); a
                  speculative cursor starts one OVERLAP early and self-
                  synchronizes onto the true symbol chain; the splice
                  (splice_compact, torch) cuts each pair of neighbouring
                  tapes at their first common symbol, checks the chain
                  from each block's anchored first cursor, and compacts
                  the kept tokens;
  repair (host)   where the splice cannot prove the chain (ok == 0), the
                  host walks the cursors and decodes only the broken
                  spans with the native bridge decoder (_repair_splice),
                  or with the native library switched off with the
                  vectorized decoder (codec/tokenize.decode_segment), as
                  tpuzlib does;
  pass 3          the compacted tape is expanded to bytes on the host
                  (codec/expand.expand_host: native, or numpy with the
                  library off; the default) or on the device by pointer
                  doubling (expand_v2, device_expand=True).

Between blocks the host walks the gaps (walk_blocks): sync-flush
markers, and stored runs no header scan can see, whose bytes splice in as
literals.  A stream the device path cannot decode raises DeviceDeclined
from `decode`; `inflate_device_v2` returns None for it, as tpuzlib does.

tpuzlib's names map as: make_splice_compact -> splice_compact,
make_compact_bounds / _compact_bounds -> compact_bounds, make_expand_v2
-> expand_v2 (torch functions on any device); its environment knobs are
keyword arguments (force_repair, bridge_chunk, max_bridges,
max_row_batches).  Deliberate differences from tpuzlib: the splice
declines (ok = 0) when ANY kept token is a flagged EOB, not only a
cursor's first, and the repair's early-EOB test finds the first flagged
token at or after the cursor's keep_lo (tpuzlib's first-flag rule can
keep a real early EOB behind a spurious one); the overlap the words
slice is sized for comes from OVERLAP, not a literal; a Huffman block
the header scan cannot see between two planned blocks (a fixed block
after a sync flush) is decoded on the host, where tpuzlib declines the
stream; and device_expand expands on the device also where the repair or
the gap walk added host-decoded tokens (they are packed and spliced into
the tape there), where tpuzlib expands on the host.

Telemetry (utils/trace.py): decode_stream runs its pieces as stages named
after tpuzlib's `_tick` keys: inflate.plan (the full-stream header scan
inside it as the port's stage inflate.plan.scan, on a card after the
stream words' upload, and the blocks planned counted as
inflate.plan_blocks while the telemetry is on; the stream bytes a scan
covers count as inflate.scan_card or inflate.scan_host, and the card's
candidates as inflate.scan_candidates), inflate.tokenize_dispatch
(tables, the stream words' upload where the plan made none, and the
decode launches),
inflate.pre_splice, inflate.splice_pull (the meta read),
inflate.repair_walk and inflate.compact (where the repair runs),
inflate.token_splice (the gap walk and the token pieces),
inflate.comp_pull and inflate.host_expand
(the token assembly and the native expansion), or inflate.device_expand.
tpuzlib's `last_stage_ms` and its TPUZLIB_TIME_INFLATE print have no
counterpart: these stages in the telemetry take their place.  The
counters inflate.splice_repair, inflate.repair_bridge (bridges decoded)
and inflate.repair_cap_exceeded (a repair cap declined the stream) are
tpuzlib's; the host<->card copies of the decode, its splice and its
repair count as copy.h2d_bytes and copy.d2h_bytes.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

import numpy as np
import torch

from ..codec import huffman
from ..codec import tokenize as tk
from ..codec.expand import expand_host
from ..codec.tables import FIXED_DIST_LENGTHS, FIXED_LITLEN_LENGTHS
from ..native import bindings
from ..parallel.speculative import _tokenize_range, find_all_block_starts
from ..utils import trace
from . import header_scan, inflate_cuda
from .inflate_cuda import SENT_BP, ST_EOB, ST_ERR, ST_OOB, ST_STRIDE_END

STRIDE_BITS = 1 << 13  # default cursor stride, before it adapts to the stream
MAX_CURSORS = 8192
OVERLAP = 1024  # bits a cursor decodes past its stop, and starts early by
# tape rows hold absolute bit positions below SENT_BP; the splice needs
# every real position, plus a cursor's overlap, to stay below it
MAX_STREAM_BITS = SENT_BP >> 1
WINDOW = 1 << 15
C0 = 192  # boundary-intersection candidates (overlap bits / min symbol bits)

# splice meta vector: meta[0] = ok, meta[1] = M, then vector i of K entries
# at [2 + i * K : 2 + (i + 1) * K]
META_CNT, META_END, META_ST, META_JSTOP, META_ANYC = 0, 1, 2, 3, 4
META_FIRSTC, META_JENTRY, META_BP0, META_BPCUT, META_KCNT = 5, 6, 7, 8, 9
META_EOB = 10


class DeviceDeclined(RuntimeError):
    """The device path cannot decode this stream; the message says why."""


class Block(NamedTuple):
    """One planned block.  stop_bit is the next discovered header (the
    block's symbols end at or before it, with only empty stored markers
    between); open_end: discovery saw no header past this block, so the
    rest of the stream is tokenized on the host from its real end."""

    header_bit: int
    data_start: int
    stop_bit: int
    bfinal: bool
    open_end: bool
    is_stored: bool
    lens_info: tuple  # ("stored",), ("fixed",) or ("dyn", litlens, distlens)


class CursorPlan(NamedTuple):
    """Cursors over the planned blocks, in stream order (K of them)."""

    starts: list
    stops: list
    block_of: list
    first: list
    last: list
    bstart: list
    stored: list
    plan: list
    K: int
    Kpad: int


def _meta_vec(meta_np: np.ndarray, K: int, i: int) -> np.ndarray:
    return meta_np[2 + i * K : 2 + (i + 1) * K]


# ---------------------------------------------------------------------------
# pass 1: block plan and cursor layout (host)
# ---------------------------------------------------------------------------


def _parse_gap(buf: np.ndarray, bit: int, avail_bits: int):
    """Parse zero or more EMPTY stored blocks (sync-flush markers) from
    `bit`.  Returns (next_bit, final), final when a BFINAL marker ended
    the stream, or None if the gap holds anything else."""
    final = False
    while True:
        reader = tk.BitReader(buf, bit, avail_bits)
        try:
            last = reader.bits(1)
            btype = reader.bits(2)
            if btype != 0:
                return bit, final
            reader.align_byte()
            length = reader.bits(16)
            nlen = reader.bits(16)
            if length != (~nlen & 0xFFFF):
                return None
            if length != 0:
                # a non-empty stored block: the planner decodes it
                return bit, final
            bit = reader.pos
            if last:
                return bit, True
        except (tk.DataError, tk.NeedMoreInput):
            return None


def _walk_gap(buf: np.ndarray, bit: int, avail_bits: int, stop_at: int | None = None):
    """Walk a run of sync markers AND non-empty stored blocks from `bit`.

    Returns (next_bit, final, ranges): ranges lists (byte_start, length)
    of the stored payloads crossed, next_bit is the first non-stored
    header (or where the walk ended, when final); None on malformed data.
    Stored runs that the header scan cannot see are decoded this way
    (reference inline handling: infblocks.ts:243-333)."""
    ranges = []
    while True:
        if stop_at is not None and bit == stop_at:
            return bit, False, ranges
        reader = tk.BitReader(buf, bit, avail_bits)
        try:
            last = reader.bits(1)
            btype = reader.bits(2)
            if btype != 0:
                return bit, False, ranges
            reader.align_byte()
            length = reader.bits(16)
            nlen = reader.bits(16)
            if length != (~nlen & 0xFFFF):
                return None
            byte_pos = reader.pos >> 3
            if byte_pos + length > len(buf):
                return None
            if length:
                ranges.append((byte_pos, length))
            bit = (byte_pos + length) * 8
            if last:
                return bit, True, ranges
        except (tk.DataError, tk.NeedMoreInput):
            return None


def _scan(buf: np.ndarray, words: torch.Tensor | None, from_bit: int) -> list:
    """The full-stream header scan from from_bit: on the card where
    `words`, buf's stream words there, is given (header_scan.block_starts),
    else on the host (find_all_block_starts)."""
    if trace.telemetry_enabled():
        trace.count("inflate.scan_host" if words is None else "inflate.scan_card",
                    len(buf) - (from_bit >> 3))
    if words is None:
        return find_all_block_starts(buf, from_bit=from_bit, allow_final=True)
    return header_scan.block_starts(buf, words, from_bit, allow_final=True)


def _plan_blocks(buf: np.ndarray, words: torch.Tensor | None = None):
    """Discover the block headers: a list of Block, or None when the first
    block does not parse.  The headers after the first come from one
    full-stream scan (_scan; on the card where buf's stream words there
    are given), consumed by bisection."""
    headers = None  # computed lazily: single-block streams never need it
    avail_bits = len(buf) * 8
    blocks = []
    bit = 0
    while True:
        gap = _parse_gap(buf, bit, avail_bits)
        if gap is None:
            return blocks or None
        bit, final = gap
        if final:
            break
        header_bit = bit
        reader = tk.BitReader(buf, bit, avail_bits)
        try:
            last = reader.bits(1)
            btype = reader.bits(2)
            if btype == 0:
                # a non-empty stored block: its bytes decode through the
                # transparent table; the next header position is exact
                reader.align_byte()
                length = reader.bits(16)
                nlen = reader.bits(16)
                if length != (~nlen & 0xFFFF):
                    return blocks or None
                data_start = reader.pos
                end = data_start + 8 * length
                if end > avail_bits:
                    return blocks or None
                blocks.append(Block(header_bit, data_start, end, bool(last), False, True,
                                    ("stored",)))
                if last:
                    break
                bit = end
                continue
            if btype == 1:
                lens_info = ("fixed",)
            elif btype == 2:
                litlens, distlens = tk.parse_dynamic_lengths(reader)
                lens_info = ("dyn", litlens, distlens)
            else:
                return blocks or None
        except (tk.DataError, tk.NeedMoreInput):
            return blocks or None
        data_start = reader.pos
        if last:
            blocks.append(Block(header_bit, data_start, avail_bits, True, False, False, lens_info))
            break
        if headers is None:
            with trace.timed_stage("inflate.plan.scan", buf):
                headers = _scan(buf, words, (data_start >> 3) * 8)
        hi = bisect.bisect_right(headers, data_start)
        nxt = headers[hi] if hi < len(headers) else None
        if nxt is None or nxt <= data_start:
            blocks.append(Block(header_bit, data_start, avail_bits, False, True, False, lens_info))
            break
        blocks.append(Block(header_bit, data_start, nxt, False, False, False, lens_info))
        bit = nxt
    return blocks or None


def _cursor_plan(buf: np.ndarray, stride_bits: int, max_cursors: int,
                 words: torch.Tensor | None = None):
    """One cursor per stride of every block's data (stored blocks on byte
    boundaries), or None when the blocks do not plan or need more than
    max_cursors cursors.  words: _plan_blocks'."""
    plan = _plan_blocks(buf, words)
    if plan is None:
        return None
    if trace.telemetry_enabled():
        trace.count("inflate.plan_blocks", len(plan))
    return lay_cursors(plan, stride_bits, max_cursors)


def lay_cursors(plan: list, stride_bits: int, max_cursors: int):
    """_cursor_plan's cursors over a block plan already made (the blocks
    of many streams too: each block's first cursor is anchored at its own
    data start), or None past max_cursors cursors."""
    starts, stops, block_of = [], [], []
    first, last, bstart, stored = [], [], [], []
    for b, p in enumerate(plan):
        ds, stop = p.data_start, p.stop_bit
        span = max(1, stop - ds)
        nseg = max(1, min(-(-span // stride_bits), max_cursors))
        bounds = [ds + (span * i) // nseg for i in range(nseg)]
        if p.is_stored:
            # stored data is byte-aligned: cursor starts must be too
            bounds = sorted({ds + (((bb - ds) >> 3) << 3) for bb in bounds})
            nseg = len(bounds)
        for i, s in enumerate(bounds):
            starts.append(s)
            stops.append(bounds[i + 1] if i + 1 < nseg else stop)
            block_of.append(b)
            first.append(i == 0)
            last.append(i == nseg - 1)
            bstart.append(ds)
            stored.append(p.is_stored)
    K = len(starts)
    if K > max_cursors:
        return None
    return CursorPlan(starts, stops, block_of, first, last, bstart, stored, plan, K,
                      1 << max(5, (K - 1).bit_length()))


class Layout(NamedTuple):
    """The device pass's cursor arrays (Kpad of them; rows past K are
    inactive padding) and shapes."""

    plan: list
    K: int
    Kpad: int
    cap: int  # tape rows per cursor
    stride_bits: int
    starts: np.ndarray  # decode start bits (speculative ones one OVERLAP early); -1 inactive
    stops: np.ndarray  # planned stops (the next cursor's planned start)
    stops_dec: np.ndarray  # where decoding stops: the planned stop + OVERLAP
    block: np.ndarray
    first: np.ndarray
    last: np.ndarray
    bstart: np.ndarray
    active: np.ndarray
    stored: np.ndarray
    expect_eob: np.ndarray  # the cursors that stop at an EOB: block-last, not stored
    words: torch.Tensor | None = None  # the stream words uploaded for the card's header scan

    def decode_args(self, buf: np.ndarray, device) -> inflate_cuda.DecodeArgs:
        """The decode's inputs on `device` (inflate_cuda.prepare), with the
        stream words the plan uploaded to the device it was given, if it
        uploaded them."""
        return inflate_cuda.prepare(buf, self.starts, self.stops_dec, self.block, self.plan,
                                    self.stride_bits, 2 * OVERLAP, self.cap, self.expect_eob,
                                    device, self.words)


def _scans_on_card(device) -> bool:
    """The header scan runs on `device` where it is a CUDA device."""
    return device is not None and torch.device(device).type == "cuda"


def plan_cursors(buf: np.ndarray, stride_bits: int | None = None,
                 max_cursors: int | None = None, kpad_multiple: int = 1,
                 device=None) -> Layout:
    """Pass 1: the block plan and the cursor layout of `buf`, its Kpad
    cursors a multiple of `kpad_multiple` (a mesh's ranks).  device: the
    decode's device; on a CUDA device the stream words are uploaded
    first, the header scan runs there, and the words come back in the
    layout for the decode; otherwise (default) it runs on the host.
    Raises DeviceDeclined when the stream reaches MAX_STREAM_BITS (2^29 bits,
    64 MiB: the tapes' bit positions would pass their sentinel), or when
    the blocks do not plan or need too many cursors."""
    stride_bits = STRIDE_BITS if stride_bits is None else stride_bits
    max_cursors = MAX_CURSORS if max_cursors is None else max_cursors
    avail_bits = len(buf) * 8
    if avail_bits >= MAX_STREAM_BITS:
        raise DeviceDeclined("the stream has %d bits; the device decode takes fewer than 2^29"
                             % avail_bits)
    # adapt the stride so the whole stream fits the cursor budget, then
    # round it up to a power of two
    stride_bits = max(stride_bits, -(-avail_bits // max(1, max_cursors - 64)))
    stride_bits = 1 << max(12, (stride_bits - 1).bit_length())
    words = (inflate_cuda.stream_words(buf, stride_bits, 2 * OVERLAP, device)
             if _scans_on_card(device) else None)
    cp = _cursor_plan(buf, stride_bits, max_cursors, words)
    if cp is None:
        raise DeviceDeclined("the block headers do not plan, or need more than %d cursors"
                             % max_cursors)
    return layout(cp, stride_bits, kpad_multiple, words)


def layout(cp: CursorPlan, stride_bits: int, kpad_multiple: int = 1,
           words: torch.Tensor | None = None) -> Layout:
    """The device pass's Layout of a cursor plan: Kpad cursors in whole
    128-cursor groups (a multiple of kpad_multiple), speculative starts one
    OVERLAP early, each cursor's tape rows from the stride."""
    K = cp.K
    # whole 128-cursor groups, a power of two of them
    groups = -(-cp.Kpad // 128)
    Kpad = 128 * (1 << max(0, (groups - 1).bit_length()))
    Kpad = kpad_multiple * -(-Kpad // kpad_multiple)
    # non-first cursors also start one OVERLAP early, inside the previous
    # cursor's span: self-sync then has 2 * OVERLAP bits to land inside the
    # candidate window instead of one
    cap = max(64, (stride_bits + 3 * OVERLAP) // 6)
    cap = -(-cap // 8) * 8

    def padded(values, fill, dtype):
        a = np.full(Kpad, fill, dtype)
        a[:K] = values
        return a

    starts = padded(cp.starts, -1, np.int32)
    stops = padded(cp.stops, 0, np.int32)
    # padding rows count as block-firsts (and lasts), so a real block-last
    # cursor followed by padding is not taken for an intra-block boundary
    first = padded(cp.first, True, bool)
    last = padded(cp.last, True, bool)
    bstart = padded(cp.bstart, 0, np.int32)
    active = padded(True, False, bool)
    stored = padded(cp.stored, False, bool)
    # stored block-last cursors stop exactly at the block end (overlap would
    # read the next header as literals); all others decode OVERLAP past it
    stops_dec = np.where(last & stored, stops, stops + OVERLAP).astype(np.int32)
    expect_eob = last & ~stored
    early = active & ~first & ~stored
    starts = np.where(early, np.maximum(bstart, starts - OVERLAP), starts).astype(np.int32)
    return Layout(cp.plan, K, Kpad, cap, stride_bits, starts, stops, stops_dec,
                  padded(cp.block_of, 0, np.int32), first, last, bstart, active, stored,
                  expect_eob, words)


# ---------------------------------------------------------------------------
# pass 2: decode, splice and compaction (device)
# ---------------------------------------------------------------------------


def _keep_mask(K: int, CAP: int, keep_lo, keep_hi, device) -> torch.Tensor:
    col = torch.arange(CAP, dtype=torch.int32, device=device)[None, :]
    return (col >= keep_lo[:, None]) & (col < keep_hi[:, None])


def compact_bounds(tok_pack: torch.Tensor, keep_lo: torch.Tensor, keep_hi: torch.Tensor):
    """Compact tape rows [keep_lo, keep_hi) of every cursor: (M, comp,
    kcnt), comp the kept tokens in order, then zeros.  The splice and the
    repair share it."""
    K = keep_lo.numel()
    CAP = tok_pack.numel() // K
    mask = _keep_mask(K, CAP, keep_lo, keep_hi, tok_pack.device)
    return _compact(tok_pack, mask, keep_lo, keep_hi)


def _compact(tok_pack, mask, keep_lo, keep_hi):
    K, CAP = mask.shape
    kept = tok_pack.view(K, CAP)[mask]
    comp = torch.cat([kept, kept.new_zeros(K * CAP - kept.numel())])
    M = mask.sum(dtype=torch.int32)
    kcnt = (keep_hi - keep_lo).clamp(0, CAP).to(torch.int32)
    return M, comp, kcnt


def _rows_at(x2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x2[k, idx[k]] per row."""
    return x2.gather(1, idx.long()[:, None])[:, 0]


def splice_compact(toks, stops, block_starts, is_block_first, is_block_last, expect_eob, active):
    """Splice the cursors' tapes `toks` (inflate_cuda.cursor_decode's six
    outputs) and compact the kept tokens.  The per-cursor vectors (a
    Layout's stops, bstart, first, last, expect_eob, active) may be numpy
    arrays; they move to the tapes' device.

    Cursors decode OVERLAP bits past their stop, so neighbouring cursors'
    chains share positions once the speculative one self-synchronizes.
    Per boundary k -> k+1 the FIRST common symbol start at or after
    stop_k is the cut: cursor k keeps tokens before it, k+1 from it.  An
    induction from each block's anchored first cursor proves every kept
    token is on the true chain; ok = 0 where it cannot.

    Returns (meta int32, comp, kcnt): meta = [ok, M] followed by the
    vectors META_* (cnt, end_pos, status, jstop, any_common, first_c,
    jentry_next, bp0, bp_cut, kcnt, eob_idx) that the host repair reads."""
    tok_pack, tok_bp, cnt, end_pos, status, eob_idx = toks
    K = cnt.numel()
    CAP = tok_pack.numel() // K
    dev = tok_pack.device
    host = [np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v
            for v in (stops, block_starts, is_block_first, is_block_last, expect_eob, active)]
    trace.count_copy("h2d", dev, [v for v in host if isinstance(v, np.ndarray)])
    stops, block_starts, is_block_first, is_block_last, expect_eob, active = (
        torch.as_tensor(v, device=dev) for v in host)
    i32 = torch.int32
    bp2 = tok_bp.view(K, CAP)
    # candidate cuts: cursor k's recorded starts >= stop_k
    jstop = torch.searchsorted(bp2, stops.to(i32)[:, None])[:, 0].to(i32)
    span = jstop[:, None] + torch.arange(C0, dtype=i32, device=dev)[None, :]
    cand = bp2.gather(1, span.clamp(max=CAP - 1).long())
    cand_valid = span < cnt[:, None]
    # membership of k's candidates in k+1's row
    bp_next = torch.cat([bp2[1:], bp2.new_full((1, CAP), SENT_BP)])
    cnt_next = torch.cat([cnt[1:], cnt.new_zeros(1)])
    mloc = torch.searchsorted(bp_next, cand).to(i32)
    mhit = bp_next.gather(1, mloc.clamp(max=CAP - 1).long())
    common = cand_valid & (mloc < cnt_next[:, None]) & (mhit == cand)
    # early in-block EOB: the block really ended before this cursor's span
    # (an invisible stored run follows; the host walks it).  Cursors after
    # the first EOB within a block decoded garbage: drop them entirely.
    eobf = active & (status == ST_EOB)
    eobi = eobf.to(i32)
    c = torch.cumsum(eobi, 0, dtype=i32)
    base = torch.cummax(torch.where(is_block_first, c - eobi, 0), 0).values
    garbage = active & ((c - eobi - base) > 0)
    efflast = ~garbage & (eobf | is_block_last)
    # boundary k -> k+1 only within a block, between live cursors (an
    # efflast cursor keeps everything it decoded)
    next_first = torch.cat([is_block_first[1:], is_block_first.new_ones(1)])
    boundary = active & ~garbage & ~efflast & ~next_first
    any_common = common.any(dim=1)
    first_c = common.to(i32).argmax(dim=1).to(i32)  # first True; 0 on an all-False row
    linked = boundary & any_common
    jcut = torch.where(linked, jstop + first_c, cnt)
    jentry_next = _rows_at(mloc, first_c)
    # entry row per cursor: 0 when anchored at its block's start, else the
    # boundary's position in ITS row
    prev_entry = torch.cat([jentry_next.new_zeros(1), jentry_next[:-1]])
    prev_boundary_ok = torch.cat([linked.new_ones(1), linked[:-1]])
    jlo = torch.where(is_block_first, 0, prev_entry)
    bp0 = bp2[:, 0]
    anchored = is_block_first & ((cnt == 0) | (bp0 == block_starts))
    good_status = garbage | eobf | ((status == ST_STRIDE_END) & ~(is_block_last & expect_eob))
    live = active & ~garbage
    keep_lo = torch.where(live, jlo, CAP).to(i32)
    keep_hi = torch.where(live, torch.minimum(jcut, cnt), 0).to(i32)
    mask = _keep_mask(K, CAP, keep_lo, keep_hi, dev)
    # a KEPT flagged-EOB token means the block really ended inside a
    # non-last cursor's span (early EOB / hidden stored run): decline, so
    # the repair cuts at the flag and bridges to the true block end.  Any
    # kept flag counts, not only the cursor's first.
    kept_eob = (((tok_pack.view(K, CAP) >> 26) & 1).bool() & mask).any(dim=1)
    ok = torch.all(
        (good_status & (anchored | (~is_block_first & prev_boundary_ok) | garbage)
         & (~boundary | any_common) & ~kept_eob)
        | ~active
    )
    M, comp, kcnt = _compact(tok_pack, mask, keep_lo, keep_hi)
    bp_cut = _rows_at(bp2, jstop.clamp(max=CAP - 1))
    meta = torch.cat([
        torch.stack([ok.to(i32), M]),
        *(v.to(i32) for v in (cnt, end_pos, status, jstop, any_common, first_c, jentry_next,
                              bp0, bp_cut, kcnt, eob_idx)),
    ])
    return meta, comp, kcnt


# ---------------------------------------------------------------------------
# repair: host walk and bridge decode where the splice declined
# ---------------------------------------------------------------------------


def _native_midblock(p: Block, lib):
    """The native bridge decoder for Huffman block p: fn(buf, bit, cap) ->
    (litlen, dist, hit_eob, end_bit) of up to cap tokens from bit, or None
    on a decode error."""
    if p.lens_info[0] == "fixed":
        ll_arr = np.ascontiguousarray(FIXED_LITLEN_LENGTHS, dtype=np.int32)
        dd_arr = np.ascontiguousarray(FIXED_DIST_LENGTHS, dtype=np.int32)
    else:
        ll_arr = np.ascontiguousarray(p.lens_info[1], dtype=np.int32)
        dd_arr = np.ascontiguousarray(p.lens_info[2], dtype=np.int32)

    def run(buf, bit, cap):
        lit_buf = np.empty(cap, np.int32)
        dist_buf = np.empty(cap, np.int32)
        end_bit, hit_eob, status = bindings.out_scalars(np.int64, np.int32, np.int32)
        ntok = lib.tz_tokenize_midblock(
            bindings.ptr(buf), len(buf), int(bit), bindings.ptr(ll_arr), len(ll_arr),
            bindings.ptr(dd_arr), len(dd_arr), bindings.ptr(lit_buf), bindings.ptr(dist_buf),
            cap, bindings.ptr(end_bit), bindings.ptr(hit_eob), bindings.ptr(status))
        if status[0] != 0:
            return None
        return lit_buf[:ntok].copy(), dist_buf[:ntok].copy(), hit_eob[0] != 0, int(end_bit[0])

    return run


def _numpy_midblock(p: Block, buf: np.ndarray, bit: int, guard_end: int):
    """The bridge decoder for Huffman block p with the native library off
    (tpuzlib's vectorized fallback): _native_midblock's contract, 4,096
    bits a call whatever cap, over bit windows of buf local to a bridge
    from `bit` (to guard_end and 64 bytes past it).  None at a decode
    error and where the windows or the input run out."""
    if p.lens_info[0] == "fixed":
        lut_lit, lut_dist = huffman.fixed_litlen_lut(), huffman.fixed_dist_lut()
    else:
        lut_lit = huffman.build_lut(p.lens_info[1], "litlen")
        lut_dist = huffman.build_lut(p.lens_info[2], "dist")
    byte0 = bit >> 3
    span = min(len(buf) - byte0, (guard_end - bit) // 8 + 64)
    w64 = tk.byte_windows64(buf[byte0 : byte0 + span])
    base = byte0 * 8
    avail = min(len(buf) * 8 - base, span * 8)

    def run(buf, bit, cap):
        try:
            litl, dist, kind, end = tk.decode_segment(w64, bit - base, avail, lut_lit, lut_dist,
                                                      4096)
        except tk.DataError:
            return None
        if kind == tk.EXIT_MORE:
            return None
        return litl, dist, kind == tk.EXIT_EOB, end + base

    return run


def flagged_rows(tok_pack: torch.Tensor, Kpad: int) -> dict:
    """cursor -> sorted rows of its flagged EOB tokens (bit 26), for the
    cursors that have any."""
    nz = ((tok_pack.view(Kpad, -1) >> 26) & 1).nonzero().cpu().numpy()
    trace.count_copy("d2h", tok_pack.device, nz)
    out: dict[int, np.ndarray] = {}
    if len(nz):
        ks, at = np.unique(nz[:, 0], return_index=True)
        for k, rows in zip(ks, np.split(nz[:, 1], at[1:])):
            out[int(k)] = rows
    return out


def _repair_splice(buf, lay: Layout, meta_np, tok_bp, flagged, *, bridge_chunk=1024,
                   max_bridges=64, max_row_batches=64, failed: set | None = None):
    """Host repair where the speculative splice fails (ok == 0).

    Speculation breaks in two data-dependent ways: a cursor's garbage
    prefix decodes a spurious EOB, or a cursor fails to self-sync inside
    the overlap window.  Both leave every other cursor's work intact, so
    this walks the cursors of each block left to right, trusts exactly the
    validated chain (the splice's induction), and decodes only the broken
    spans with the bridge decoder (native, or numpy with the library
    off), re-entering the next cursor whose tape holds a decoded chain
    position.

    Returns (keep_lo, keep_hi, bridge_ins, block_end_bits); raises
    DeviceDeclined on real data errors, truncation, unparseable structure,
    a bridge inside a stored block, or past max_bridges bridges or
    max_row_batches lazy tape-row pulls.  Given a set `failed` (the
    blocks of many independent streams), a block that would raise is
    added to it instead, keeps no token and ends at None, and the other
    blocks are repaired."""
    Kpad, CAP, K, plan = lay.Kpad, lay.cap, lay.K, lay.plan
    cnt_np = _meta_vec(meta_np, Kpad, META_CNT)
    st_np = _meta_vec(meta_np, Kpad, META_ST)
    end_np = _meta_vec(meta_np, Kpad, META_END)
    eob_np = _meta_vec(meta_np, Kpad, META_EOB)
    jstop, anyc, firstc, jentry, bp0, bp_cut = (
        _meta_vec(meta_np, Kpad, i)
        for i in (META_JSTOP, META_ANYC, META_FIRSTC, META_JENTRY, META_BP0, META_BPCUT))
    keep_lo = np.full(Kpad, CAP, np.int32)
    keep_hi = np.zeros(Kpad, np.int32)
    bridge_ins: dict[int, tuple] = {}
    block_end_bits: list[int] = []
    rows2 = tok_bp.view(Kpad, CAP)
    row_cache: dict[int, np.ndarray] = {}
    nbridge = nrows = 0
    RG = 16  # rows per lazy pull

    def pull(idxs):
        at = torch.as_tensor(idxs, device=rows2.device)
        rows = rows2[at].cpu().numpy()
        trace.count_copy("h2d", at.device, at)
        trace.count_copy("d2h", at.device, rows)
        for i, kk in enumerate(idxs):
            row_cache[int(kk)] = rows[i]

    # one pull up front of the rows the bridges will plausibly read: the
    # suspect cursors' own rows and their 32 successors.  Block-last cursors
    # are no suspects: their any_common is false by design.
    suspects = np.flatnonzero(
        lay.active[:K] & ~lay.last[:K]
        & (~anyc[:K].astype(bool) | (st_np[:K] == ST_EOB) | (eob_np[:K] >= 0)))
    want = sorted({int(k) for s in suspects for k in range(int(s), min(int(s) + 33, K))})
    if want:
        pull(want)

    def get_row(k):
        nonlocal nrows
        if k not in row_cache:
            if nrows >= max_row_batches:
                trace.count("inflate.repair_cap_exceeded")
                raise DeviceDeclined("the splice repair exceeded its row-batch cap (%d)"
                                     % max_row_batches)
            base = min(k, Kpad - RG)
            pull(list(range(base, base + RG)))
            nrows += 1
        return row_cache[k]

    def first_flag(k, lo):
        """The first flagged EOB row of cursor k at or after row lo, or -1."""
        rows = flagged.get(k)
        if rows is None:
            return -1
        i = int(np.searchsorted(rows, lo))
        return int(rows[i]) if i < len(rows) else -1

    blk_np = lay.block[:K]

    def repair_block(b, p, idxs):
        """The repair of block b: its cursors' keep bounds and bridges,
        and its end bit."""
        nonlocal nbridge
        if len(idxs) == 0:
            raise DeviceDeclined("block %d has no cursor" % b)
        current = int(idxs[0])
        if not (cnt_np[current] == 0 or bp0[current] == lay.bstart[current]):
            raise DeviceDeclined("block %d's first cursor is not anchored at its start" % b)
        keep_lo[current] = 0
        b_end = None
        while True:
            st = st_np[current]
            e_i = first_flag(current, int(keep_lo[current]))
            if 0 <= e_i < int(cnt_np[current]):
                # a kept flagged EOB: the block really ended inside this
                # trusted cursor's span.  Cut before the flag and bridge
                # from its bit position; the bridge decodes the EOB at once
                # and closes the block (stored runs after it follow through
                # the host gap walk).
                cut_idx = e_i
                bridge_pos = int(get_row(current)[e_i])
            elif st == ST_EOB:
                # trusted EOB (current is entry-validated): the block's end
                keep_hi[current] = cnt_np[current]
                b_end = int(end_np[current])
                break
            elif st in (ST_ERR, ST_OOB):
                raise DeviceDeclined("a trusted cursor of block %d hit %s" % (
                    b, "a bad code" if st == ST_ERR else "the end of the input"))
            elif current == idxs[-1] and not lay.expect_eob[current]:
                keep_hi[current] = cnt_np[current]
                b_end = int(end_np[current])
                break
            else:
                nxt = current + 1
                if current != idxs[-1] and anyc[current] and cnt_np[nxt] > 0:
                    keep_hi[current] = min(int(jstop[current] + firstc[current]),
                                           int(cnt_np[current]))
                    keep_lo[nxt] = jentry[current]
                    current = nxt
                    continue
                if jstop[current] >= cnt_np[current]:
                    raise DeviceDeclined("cursor %d ends before its stop" % current)
                cut_idx = int(jstop[current])
                bridge_pos = int(bp_cut[current])

            # bridge: decode on the host from current's cut
            keep_hi[current] = cut_idx
            pos = bridge_pos
            if nbridge >= max_bridges:
                trace.count("inflate.repair_cap_exceeded")
                raise DeviceDeclined("the splice repair exceeded its bridge cap (%d)"
                                     % max_bridges)
            nbridge += 1
            targets = [int(k2) for k2 in idxs if k2 > current]
            guard_end = int(lay.stops[int(idxs[-1])]) + 4096
            if p.is_stored:
                raise DeviceDeclined("a splice repair would bridge inside stored block %d" % b)
            lib = bindings.get_lib()
            nat = (_native_midblock(p, lib) if lib is not None
                   else _numpy_midblock(p, buf, pos, guard_end))
            lit_parts, dist_parts = [], []
            sync = None
            while True:
                # about one stride of tokens per chunk: sync is checked at
                # chunk ends, so smaller chunks sync at the first eligible
                # cursor instead of overshooting
                res = nat(buf, pos, bridge_chunk)
                if res is None:
                    raise DeviceDeclined("the bridge decode of block %d hit bad data" % b)
                litl, dst, hit_eob, newpos = res
                lit_parts.append(litl)
                dist_parts.append(dst)
                if hit_eob:
                    b_end = newpos
                    break
                pos = newpos
                hit = None
                for k2 in targets:
                    if cnt_np[k2] == 0 or pos > int(lay.stops[k2]) + 2048:
                        continue
                    row = get_row(k2)[: cnt_np[k2]]
                    ii = int(np.searchsorted(row, pos))
                    # the sync row must lie BEFORE k2's own boundary cut
                    # (jstop): a long chunk can overshoot into k2's overlap
                    # tail, where accepting it would put the next cursor's
                    # entry before the bridge's end (doubled tokens)
                    if ii < cnt_np[k2] and row[ii] == pos and ii < int(jstop[k2]):
                        hit = (k2, ii)
                        break
                if hit is not None:
                    sync = hit
                    break
                if pos > guard_end:
                    raise DeviceDeclined("the bridge of block %d found no cursor to rejoin" % b)
            if lit_parts:
                bridge_ins[current] = (np.concatenate(lit_parts), np.concatenate(dist_parts))
            if b_end is not None:
                break  # the bridge hit the real EOB: block done
            k2, ii = sync
            keep_lo[k2] = ii  # cursors between current and k2 stay dead
            current = k2
        return b_end

    for b, p in enumerate(plan):
        idxs = np.flatnonzero((blk_np == b) & lay.active[:K])
        try:
            b_end = repair_block(b, p, idxs)
        except DeviceDeclined:
            if failed is None:
                raise
            # the block's tokens are dropped; its stream decodes elsewhere
            failed.add(b)
            keep_lo[idxs] = CAP
            keep_hi[idxs] = 0
            for k in idxs:
                bridge_ins.pop(int(k), None)
            b_end = None
        block_end_bits.append(b_end)
    trace.count("inflate.repair_bridge", nbridge)
    return keep_lo, keep_hi, bridge_ins, block_end_bits


# ---------------------------------------------------------------------------
# between blocks, and pass 3
# ---------------------------------------------------------------------------


def fast_block_ends(lay: Layout, meta_np: np.ndarray) -> list:
    """Each block's end bit on the splice's fast path: the end of the FIRST
    cursor that hit an EOB (an early in-block EOB means a stored run
    follows), else of its planned last cursor."""
    st_np = _meta_vec(meta_np, lay.Kpad, META_ST)
    end_np = _meta_vec(meta_np, lay.Kpad, META_END)
    blk = lay.block[: lay.K]
    ends = []
    for b in range(len(lay.plan)):
        idxs = np.flatnonzero(blk == b)
        hits = idxs[st_np[idxs] == ST_EOB]
        ends.append(int(end_np[hits[0] if len(hits) else idxs[-1]]))
    return ends


def _gap_tokens(buf: np.ndarray, bit: int, stop_at: int | None):
    """The tokens between a block's end `bit` and the next planned header
    `stop_at` (None: the stream's end), as a list of (litlen, dist): the
    payloads of stored blocks, and the tokens of Huffman blocks that the
    header scan cannot see (a fixed block, which zlib writes for a small
    flush, or a dynamic one too short to confirm), decoded on the host one
    block at a time.  Returns (that list, the bit where the walk ended:
    stop_at, or the end of the final block).  Raises DeviceDeclined where
    the walk breaks."""
    avail_bits = len(buf) * 8
    parts = []
    while True:
        walk = _walk_gap(buf, bit, avail_bits, stop_at=stop_at)
        if walk is None:
            raise DeviceDeclined("malformed stored block after bit %d" % bit)
        bit, final, ranges = walk
        parts += [(buf[bs : bs + ln].astype(np.int32), np.zeros(ln, np.int32)) for bs, ln in ranges]
        if final or bit == stop_at:
            if final != (stop_at is None):
                raise DeviceDeclined("the stream ends before the header at bit %d" % stop_at)
            return parts, bit
        if stop_at is not None and bit > stop_at:
            raise DeviceDeclined("the blocks after bit %d overrun the header at bit %d"
                                 % (bit, stop_at))
        try:
            litlen, dist, bit, fin = _tokenize_range(buf, bit, bit + 1)  # one block
        except tk.DataError as e:
            raise DeviceDeclined("a block after the planned ones does not decode: %s" % e) from None
        parts.append((litlen, dist))
        if fin:
            if stop_at is not None:
                raise DeviceDeclined("the stream ends before the header at bit %d" % stop_at)
            return parts, bit


def walk_blocks(buf: np.ndarray, lay: Layout, block_end_bits: list):
    """Chain each block's end to the next header, through sync markers,
    stored runs and blocks the header scan cannot see.  Returns
    (insertions, tail, end): insertions maps a block to the (litlen, dist)
    token arrays decoded on the host after it; tail is the host-tokenized
    rest of an open-ended stream, or None; end is the bit after the
    stream's final block, where a container's trailer starts.  Raises
    DeviceDeclined where the chain breaks."""
    avail_bits = len(buf) * 8
    plan = lay.plan
    insertions: dict[int, list] = {}
    tail = None
    end = block_end_bits[-1]
    for bi, p in enumerate(plan):
        if bi < len(plan) - 1:
            parts, _ = _gap_tokens(buf, block_end_bits[bi], plan[bi + 1].header_bit)
        elif p.bfinal:
            parts = []  # the stream ends with this block
        elif p.open_end:
            # discovery stopped here: decode the rest on the host
            try:
                litlen, dist, end, fin = _tokenize_range(buf, block_end_bits[bi], avail_bits)
            except tk.DataError as e:
                raise DeviceDeclined("the stream's tail does not decode: %s" % e) from None
            if not fin:
                raise DeviceDeclined("the stream's tail has no final block")
            tail = (litlen, dist)
            parts = []
        else:
            parts, end = _gap_tokens(buf, block_end_bits[bi], None)
        if parts:
            insertions[bi] = parts
    return insertions, tail, end


def token_pieces(lay: Layout, M: int, kcnt_np, insertions, tail, bridge_ins=None) -> list:
    """The whole stream's token tape as pieces in order: (lo, hi), a
    range of the compacted tape, or (litlen, dist) arrays decoded on the
    host (bridge tokens after their cursors when the repair ran, the
    insertions after their blocks, the open-ended tail)."""
    blk_np = lay.block[: lay.K]
    pieces: list = []
    if bridge_ins is not None:
        # per cursor: its kept slice, then its bridge tokens; per block:
        # its insertions
        cum = np.concatenate([[0], np.cumsum(kcnt_np.astype(np.int64))])
        lo = 0
        for b in range(len(lay.plan)):
            for k in np.flatnonzero((blk_np == b) & lay.active[: lay.K]):
                if int(k) in bridge_ins:
                    pieces += [(lo, int(cum[k + 1])), bridge_ins[int(k)]]
                    lo = int(cum[k + 1])
            if b in insertions:
                hi = int(cum[np.flatnonzero(blk_np <= b)[-1] + 1])
                pieces += [(lo, hi), *insertions[b]]
                lo = hi
        pieces.append((lo, int(cum[-1])))
    else:
        # token count per planned block -> insertion offsets
        per_block = np.bincount(blk_np, weights=kcnt_np.astype(np.int64), minlength=len(lay.plan))
        block_end_tok = np.cumsum(per_block).astype(np.int64)
        lo = 0
        for b in sorted(insertions):
            hi = int(block_end_tok[b])
            pieces += [(lo, hi), *insertions[b]]
            lo = hi
        pieces.append((lo, M))
    if tail is not None:
        pieces.append(tail)
    return [p for p in pieces if not isinstance(p[0], int) or p[1] > p[0]]


def _is_range(piece) -> bool:
    return isinstance(piece[0], int)


def host_tokens(comph: np.ndarray, pieces: list):
    """The whole stream's (litlen, dist) on the host, from the pulled
    compacted tape `comph` (u32) and the pieces."""
    is_m = (comph >> 25) & 1
    litlen = (comph & 0x1FF).astype(np.int32)
    dist = np.where(is_m == 1, (comph >> 9) & 0xFFFF, 0).astype(np.int32)
    parts = [(litlen[p[0] : p[1]], dist[p[0] : p[1]]) if _is_range(p) else p for p in pieces]
    if not parts:
        return litlen[:0], dist[:0]
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


def device_tape(comp: torch.Tensor, M: int, pieces: list):
    """(tape, n): the whole stream's token tape in the compacted tape's
    format (`val | dist << 9 | is_len << 25`) on comp's device, of which
    the first n tokens are the stream; comp itself where it is all of
    it."""
    if pieces == [(0, M)]:
        return comp, M
    parts = []
    for p in pieces:
        if _is_range(p):
            parts.append(comp[p[0] : p[1]])
        else:
            litlen, dist = (np.asarray(a, np.int64) for a in p)
            packed = litlen | (dist << 9) | ((dist > 0).astype(np.int64) << 25)
            parts.append(torch.from_numpy(packed.astype(np.int32)).to(comp.device))
    tape = torch.cat(parts) if parts else comp[:0]
    return tape, tape.numel()


def expand_v2(comp: torch.Tensor, M, window: torch.Tensor, out_cap: int):
    """Expand the first M tokens of a compacted tape on its device by
    pointer doubling: (out uint8[out_cap], total).  window: uint8[32768],
    the history before the output (zeros where there is none).  total >
    out_cap means the output did not fit (the caller retries bigger)."""
    dev = comp.device
    T = comp.numel()
    W = window.numel()
    c = comp.to(torch.int64) & 0xFFFFFFFF
    tid_dom = torch.arange(T, device=dev)
    valid = tid_dom < M
    is_m = valid & (((c >> 25) & 1) == 1)
    ll = c & 0x1FF
    dd = (c >> 9) & 0xFFFF
    out_len = torch.where(valid, torch.where(is_m, ll, 1), 0)
    starts = torch.cumsum(out_len, 0) - out_len
    total = out_len.sum()
    # each output byte's token: the last token starting at or before it
    scatter_idx = torch.where(valid, starts.clamp(max=out_cap - 1), out_cap - 1)
    tid_seed = torch.full((out_cap,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, scatter_idx, torch.where(valid, tid_dom, -1), reduce="amax")
    tid = torch.cummax(tid_seed, 0).values.clamp(0, T - 1)
    i = torch.arange(out_cap, device=dev)
    start_b = starts[tid]
    d = torch.where(is_m[tid], dd[tid], 0)
    jcol = i - start_b
    is_copy_b = (d > 0) & (i < total)
    # a copy byte's immediate source lies strictly before its own token
    src = start_b - d + torch.where(d > 0, jcol % d.clamp(min=1), 0)
    ptr = torch.cat([torch.arange(W, device=dev), torch.where(is_copy_b, src + W, i + W)])
    # where the output is too small (total > out_cap), the last byte's token
    # starts past the end and its source lies there too: clamp it, as a
    # gather in tpuzlib clamps (the caller then retries with a larger output)
    ptr = ptr.clamp(max=W + out_cap - 1)
    vals = torch.cat([window, torch.where(is_copy_b, 0, ll[tid]).to(torch.uint8)])
    while True:  # pointer doubling to the roots: literals and window bytes
        nxt = ptr[ptr]
        if torch.equal(nxt, ptr):
            break
        ptr = nxt
    return vals[ptr[W:]], total


def _window(dictionary) -> np.ndarray:
    """The history a stream's distances may reach before its first byte:
    the dictionary's last 32K-1 bytes (inflate.ts:489-492)."""
    if dictionary is None or not len(dictionary):
        return np.empty(0, np.uint8)
    return np.asarray(dictionary, dtype=np.uint8)[-(WINDOW - 1):]


def decode(data, dictionary=None, stride_bits: int | None = None, max_cursors: int | None = None,
           size_hint: int | None = None, device_expand: bool = False, mesh=None, **kwargs):
    """Decode the raw DEFLATE stream `data` (uint8) with its heavy work on
    `device`.  Returns the bytes as a uint8 ndarray when pass 3 runs on the
    host (the default), or as a 1-D uint8 tensor on `device` with
    device_expand.  Bytes after the stream's final block are ignored.
    Raises DeviceDeclined, with the reason, for a stream the device path
    cannot decode.

    The positional parameters are tpuzlib's, in its order.  dictionary:
    the history before the stream (a zlib preset dictionary); size_hint:
    the output's first capacity in the device expansion (default 8 bytes
    an input byte and 64 KiB), which grows by retry where the output is
    larger, so it changes no byte (the host expansion sizes its output
    from the token tape, as tpuzlib's does); mesh: a parallel/mesh.Mesh
    whose ranks share the decode (on their own devices; see mesh_decode).
    Keywords: device (default "cuda"); force_repair: run the splice repair
    even where the splice validated; bridge_chunk: tokens per native
    bridge call; max_bridges / max_row_batches: the repair's caps."""
    return decode_stream(data, dictionary, stride_bits, max_cursors, size_hint, device_expand,
                         mesh, **kwargs)[0]


def decode_stream(data, dictionary=None, stride_bits: int | None = None,
                  max_cursors: int | None = None, size_hint: int | None = None,
                  device_expand: bool = False, mesh=None, *, device="cuda",
                  force_repair: bool = False, bridge_chunk: int = 1024, max_bridges: int = 64,
                  max_row_batches: int = 64):
    """decode(...) and the bit after the stream's final block: (bytes,
    end bit)."""
    buf = np.ascontiguousarray(np.asarray(data), dtype=np.uint8)
    n_in = len(buf)
    with trace.timed_stage("inflate.plan", n_in):
        lay = plan_cursors(buf, stride_bits, max_cursors, 1 if mesh is None else mesh.size,
                           device if mesh is None else mesh.device)
    with trace.timed_stage("inflate.tokenize_dispatch", n_in):
        if mesh is None:
            toks = inflate_cuda.cursor_decode(lay.decode_args(buf, device))
        else:
            toks = mesh_decode(lay.decode_args(buf, mesh.device), mesh)
    with trace.timed_stage("inflate.pre_splice", toks):
        meta, comp, _ = splice_compact(toks, lay.stops, lay.bstart, lay.first, lay.last,
                                       lay.expect_eob, lay.active)
    with trace.timed_stage("inflate.splice_pull", meta):
        meta_np = meta.cpu().numpy()
        trace.count_copy("d2h", meta.device, meta)
    M = int(meta_np[1])
    kcnt_np = _meta_vec(meta_np, lay.Kpad, META_KCNT)[: lay.K]
    repair = None
    if int(meta_np[0]) != 1 or force_repair:
        tok_pack, tok_bp = toks[0], toks[1]
        with trace.timed_stage("inflate.repair_walk", n_in):
            keep_lo, keep_hi, bridge_ins, block_end_bits = repair = _repair_splice(
                buf, lay, meta_np, tok_bp, flagged_rows(tok_pack, lay.Kpad),
                bridge_chunk=bridge_chunk, max_bridges=max_bridges,
                max_row_batches=max_row_batches)
        trace.count("inflate.splice_repair")
        with trace.timed_stage("inflate.compact", tok_pack):
            dev = tok_pack.device
            M_r, comp, kcnt = compact_bounds(tok_pack, torch.from_numpy(keep_lo).to(dev),
                                             torch.from_numpy(keep_hi).to(dev))
            trace.count_copy("h2d", dev, keep_lo, keep_hi)
            M = int(M_r)
            kcnt_np = kcnt.cpu().numpy()[: lay.K]
            trace.count_copy("d2h", dev, M_r, kcnt)
    else:
        block_end_bits = fast_block_ends(lay, meta_np)
    with trace.timed_stage("inflate.token_splice", n_in):
        insertions, tail, end = walk_blocks(buf, lay, block_end_bits)
        pieces = token_pieces(lay, M, kcnt_np, insertions, tail,
                              repair[2] if repair is not None else None)

    window = _window(dictionary)
    if not device_expand:
        with trace.timed_stage("inflate.comp_pull", 4 * M):
            comph = comp[:M].cpu().numpy().view(np.uint32)
            trace.count_copy("d2h", comp.device, comph)
        with trace.timed_stage("inflate.host_expand", 4 * M):
            return expand_host(*host_tokens(comph, pieces), window), end
    with trace.timed_stage("inflate.device_expand", 4 * M):
        tape, n = device_tape(comp, M, pieces)
        win = np.zeros(WINDOW, np.uint8)
        win[WINDOW - len(window):] = window
        return device_expand_all(tape, n, torch.from_numpy(win).to(comp.device),
                                 size_hint or 8 * len(buf) + (1 << 16)), end


def mesh_decode(a: inflate_cuda.DecodeArgs, mesh):
    """The cursor decode sharded over a mesh (tpuzlib's mesh= tokenize,
    inflate_device2.py:1354-1388): each rank decodes its slice of the
    cursors on its device (the `inflate_decode` kernel on a card, its plain
    version on the CPU), with the stream and the tables replicated; then
    every rank gathers all six outputs in cursor order, as tpuzlib gathers
    before its splice, so the splice, repair and expansion run unchanged
    on every rank."""
    import torch.distributed as dist

    kc = a.cur.shape[1] // mesh.size
    lo = mesh.rank * kc
    mine = inflate_cuda.cursor_decode(a._replace(cur=a.cur[:, lo : lo + kc].contiguous()))
    out = []
    for t in mine:
        parts = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(parts, t.contiguous(), group=mesh.group)
        out.append(torch.cat(parts))
    return tuple(out)


def device_expand_all(tape: torch.Tensor, n: int, window: torch.Tensor, out_cap: int):
    """expand_v2 of the first n tokens of `tape`, retried with a larger
    output until it fits; the bytes as a uint8 tensor on tape's device."""
    if n == 0:
        return window[:0]
    out_cap = -(-out_cap // 1024) * 1024
    while True:
        out, total = expand_v2(tape, n, window, out_cap)
        t = int(total)
        if t <= out_cap:
            return out[:t]
        out_cap = -(-t // 1024) * 1024


def inflate_device_v2(data, dictionary=None, stride_bits: int | None = None,
                      max_cursors: int | None = None, size_hint: int | None = None,
                      device_expand: bool = False, mesh=None, **kwargs):
    """decode(...), or None where it declines the stream (tpuzlib's
    contract: the caller then decodes another way)."""
    try:
        return decode(data, dictionary, stride_bits, max_cursors, size_hint, device_expand, mesh,
                      **kwargs)
    except DeviceDeclined:
        return None
