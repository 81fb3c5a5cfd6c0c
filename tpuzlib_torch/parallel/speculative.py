"""Speculative parallel inflate of one DEFLATE stream with no index and no
sync points, and the header scan of the device inflate's block planner.

Counterpart of tpuzlib/parallel/speculative.py (rapidgzip-style, see
PAPERS.md).  A token tape (literals and (length, distance) pairs) can be
produced for any block without the 32 KiB of output before it, so:

  1. DISCOVER: for each segment boundary, scan bit offsets for a
     plausible dynamic-block header (Kraft-valid code-length sets), then
     confirm it by decoding a short run of symbols (find_block_start);
  2. TOKENIZE: every segment tokenizes on its own, in parallel threads
     (the native tokenizer releases the GIL);
  3. VALIDATE: segment i must end at the bit where segment i+1 was found
     to start; where it does not (a speculation miss), the gap is
     tokenized again sequentially from the true position;
  4. EXPAND: every tape expands on its own thread, the bytes it copies
     from before its segment left as markers into the 32 KiB window
     there; the windows resolve in order and the segments become bytes
     in parallel (codec/expand.expand_segments).  tpuzlib joins the tapes
     and expands them in one serial pass: the bytes are the same.

The native library (native/bindings.py) runs the scans, the tokenizer
and the expansion.  With it switched off, each site takes tpuzlib's
numpy branch where tpuzlib takes it: `_tokenize_range` the vectorized
tokenizer over the stream's bit windows (w64), `find_all_block_starts`
the vectorized Kraft prefilter (`_kraft_prefilter`) with the python probe
and confirm of each survivor, find_block_start's candidates the same
prefilter, and the expansion expand_host a tape after another.
tpuzlib's `_native_probe`, which returns None without its library, has
no counterpart: the numpy scan is the only caller, and runs only with the
library off.  tpuzlib's `SpeculationMiss` is raised by neither package
and has no counterpart.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np

from ..codec import tokenize as tk
from ..codec.deflate_engine import _ncores, get_executor
from ..codec.expand import expand_segments, tape_out_len
from ..codec.huffman import fixed_dist_lut, fixed_litlen_lut
from ..codec.tokenize import DataError
from ..common import u8_view
from ..native import bindings


def _probe_header(buf: np.ndarray, bit_pos: int, avail_bits: int, allow_final: bool = False):
    """Try to parse a block header at bit_pos.  Returns (luts, data_start)
    or None."""
    reader = tk.BitReader(buf, bit_pos, avail_bits)
    try:
        last = reader.bits(1)
        btype = reader.bits(2)
        if last and not allow_final:
            # segment decoding treats final blocks as the tail's job
            return None
        if btype == 2:
            luts = tk.parse_dynamic_header(reader)
            return luts, reader.pos
        if btype == 1:
            return (fixed_litlen_lut(), fixed_dist_lut()), reader.pos
        return None
    except (tk.DataError, tk.NeedMoreInput):
        return None


def _confirm(w64, data_start, avail_bits, luts, probe_syms=48):
    """Decode a short run of symbols; reject if the path hits an invalid
    code quickly (false-positive header)."""
    try:
        litlen, _, _, _ = tk.decode_segment(w64, data_start, avail_bits, luts[0], luts[1], 1 << 12)
    except tk.DataError:
        return False
    return len(litlen) >= min(probe_syms, 8)


def _kraft_prefilter(w64, start_bit: int, nbits: int, allow_final: bool = False) -> np.ndarray:
    """Vectorized candidate filter for dynamic-block headers.

    For every bit offset in [start_bit, start_bit+nbits): BFINAL must be
    0 (unless allow_final), BTYPE 10, HLIT/HDIST in range, and the
    code-length code's Kraft sum exactly 2^7 (a complete tree) with at
    least two codes.  Returns the survivors' offsets from start_bit.  The
    cheap field checks run first, the 19-term Kraft sum on their
    survivors; the bit windows come from a byte-view broadcast."""
    first_byte = start_bit >> 3
    last_byte = (start_bit + nbits - 1) >> 3
    span = last_byte - first_byte + 1
    wbytes = w64[first_byte : first_byte + span]
    if len(wbytes) < span:  # buffer tail: zero-pad the window views
        wbytes = np.concatenate([wbytes, np.zeros(span - len(wbytes), np.uint64)])
    shifts = np.arange(8, dtype=np.uint64)
    # wA_all[b, s] = 64-bit window at bit (first_byte + b) * 8 + s
    wA_all = (wbytes[:, None] >> shifts[None, :]).reshape(-1)
    lo = start_bit - first_byte * 8
    wA = wA_all[lo : lo + nbits]

    btype = ((wA >> np.uint64(1)) & np.uint64(3)).astype(np.int32)
    hlit = ((wA >> np.uint64(3)) & np.uint64(31)).astype(np.int32)
    hdist = ((wA >> np.uint64(8)) & np.uint64(31)).astype(np.int32)
    ok = (btype == 2) & (hlit <= 29) & (hdist <= 29)
    if not allow_final:
        ok &= (wA & np.uint64(1)) == 0
    cand = np.flatnonzero(ok)
    if len(cand) == 0:
        return cand

    wAc = wA[cand]
    posB = cand + np.int64(start_bit) + 40
    wBc = w64[np.minimum(posB >> 3, len(w64) - 1)] >> (posB & 7).astype(np.uint64)
    hclen = ((wAc >> np.uint64(13)) & np.uint64(15)).astype(np.int64) + 4
    kraft = np.zeros(len(cand), dtype=np.int64)
    nzero = np.zeros(len(cand), dtype=np.int64)
    for j in range(19):
        o = 17 + 3 * j
        if o + 3 <= 57:
            lj = ((wAc >> np.uint64(o)) & np.uint64(7)).astype(np.int64)
        else:
            lj = ((wBc >> np.uint64(o - 40)) & np.uint64(7)).astype(np.int64)
        used = (j < hclen) & (lj > 0)
        kraft += np.where(used, 1 << (7 - np.minimum(lj, 7)), 0)
        nzero += used
    return cand[(kraft == 128) & (nzero >= 2)]


def find_all_block_starts(buf: np.ndarray, from_bit: int = 0, allow_final: bool = True) -> list:
    """Bit positions of every confirmed dynamic-block header from
    `from_bit` on: a bit scan with a Kraft prefilter, each candidate
    confirmed by a bounded decode (tz_find_headers); with the native
    library off, the vectorized prefilter a 2^23-bit chunk at a time and
    the python probe and confirm of each survivor."""
    lib = bindings.get_lib()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if lib is None:
        return _scan_block_starts(buf, from_bit, allow_final)
    cap = 4096
    while True:
        pos = np.empty(cap, np.int64)
        n = lib.tz_find_headers(bindings.ptr(buf), len(buf), from_bit, 1 if allow_final else 0,
                                bindings.ptr(pos), cap)
        if n < cap:
            return pos[:n].tolist()
        cap *= 8


def confirm_block_starts(buf: np.ndarray, pos: np.ndarray, allow_final: bool = True) -> list:
    """find_all_block_starts(buf, from_bit, allow_final) from `pos`, the
    sorted start bits in [from_bit, nbits - 81] that pass its scan's field
    and Kraft tests and its header parse (the card scan's candidates,
    kernels/header_scan.py): those its confirmation accepts.  That is the
    native scan's bounded decode (tz_confirm_headers); with the native
    library off, _scan_block_starts' python probe and confirm of each.
    That scan also tests the last 80 start bits, but confirms none there:
    a header's fields, its code lengths (258 or more, a complete code)
    and the 8 symbols the confirmation decodes take more bits."""
    lib = bindings.get_lib()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    if lib is None:
        avail_bits = len(buf) * 8
        w64 = tk.byte_windows64(buf)
        out = []
        for p in pos.tolist():
            pr = _probe_header(buf, p, avail_bits, allow_final=allow_final)
            if pr is not None and _confirm(w64, pr[1], avail_bits, pr[0]):
                out.append(p)
        return out
    out = np.empty(len(pos), np.int64)
    n = lib.tz_confirm_headers(bindings.ptr(buf), len(buf), bindings.ptr(pos), len(pos),
                               bindings.ptr(out))
    return out[:n].tolist()


def _scan_block_starts(buf: np.ndarray, from_bit: int, allow_final: bool) -> list:
    """find_all_block_starts' numpy scan (tpuzlib's)."""
    avail_bits = len(buf) * 8
    w64 = tk.byte_windows64(buf)
    out = []
    chunk = 1 << 23  # bits
    bit = from_bit
    while bit < avail_bits:
        nbits = min(chunk, avail_bits - bit)
        for rel in _kraft_prefilter(w64, bit, nbits, allow_final=allow_final):
            p = bit + int(rel)
            pr = _probe_header(buf, p, avail_bits, allow_final=allow_final)
            if pr is not None and _confirm(w64, pr[1], avail_bits, pr[0]):
                out.append(p)
        bit += nbits
    return out


def _header_candidates(region: np.ndarray, limit_bits: int, allow_final: bool) -> np.ndarray:
    """Bit offsets in [0, limit_bits) of `region` whose dynamic-block
    header passes tpuzlib's Kraft prefilter and parses (native/
    tz_header_candidates): a position dropped here is one _probe_header
    drops too.  With the native library off, the prefilter's survivors
    (tpuzlib's candidates), which _probe_header then parses."""
    lib = bindings.get_lib()
    if lib is None:
        return _kraft_prefilter(tk.byte_windows64(region), 0, limit_bits,
                                allow_final=allow_final)
    cap = 256
    while True:
        pos = np.empty(cap, np.int64)
        n = lib.tz_header_candidates(bindings.ptr(region), len(region), limit_bits,
                                     1 if allow_final else 0, bindings.ptr(pos), cap)
        if n < cap:
            return pos[:n]
        cap *= 8


def find_block_start(buf: np.ndarray, from_byte: int, window_bytes: int = 1 << 15,
                     allow_final: bool = False):
    """Scan forward from from_byte for a confirmed block-header bit
    offset.  Returns bit position or None.

    Reads only the scanned region and a confirmation margin (never the
    whole buffer).  tpuzlib's vectorized Kraft prefilter and the parse
    of its header probe run natively over the region first
    (_header_candidates); the python probe and the confirm then run on
    those candidates alone, so the position is tpuzlib's."""
    region_end = min(len(buf), from_byte + window_bytes + (1 << 13))
    region = np.ascontiguousarray(buf[from_byte:region_end], dtype=np.uint8)
    local_bits = len(region) * 8
    limit_bits = min(local_bits, window_bytes * 8)
    if limit_bits <= 0:
        return None
    local = None
    for lpos in _header_candidates(region, limit_bits, allow_final).tolist():
        got = _probe_header(region, lpos, local_bits, allow_final=allow_final)
        if got is None:
            continue
        if local is None:
            local = tk.byte_windows64(region)
        luts, data_start = got
        if _confirm(local, data_start, local_bits, luts):
            return from_byte * 8 + lpos
    return None


def _tokenize_range(buf: np.ndarray, start_bit: int, stop_bit: int, w64=None):
    """Tokenize blocks from start_bit until a block ends at/after stop_bit
    (or the stream's final block), with the GIL-free native tokenizer, or
    with the native library off the vectorized one over `w64`, the
    stream's bit windows (made here where None).  Returns (litlen, dist,
    end_bit, finished); raises DataError on malformed or truncated
    data."""
    lib = bindings.get_lib()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if lib is None:
        return _tokenize_range_numpy(buf, tk.byte_windows64(buf) if w64 is None else w64,
                                     start_bit, stop_bit)
    # tokens rarely exceed ~0.6 per compressed byte; grow on overflow
    cap = max(1 << 16, max(1, (stop_bit - start_bit) // 8))
    while True:
        litlen = np.empty(cap, np.int32)
        dist = np.empty(cap, np.int32)
        end_bit, finished, status = bindings.out_scalars(np.int64, np.int32, np.int32)
        ntok = lib.tz_inflate_tokenize(
            bindings.ptr(buf), len(buf), start_bit, stop_bit, bindings.ptr(litlen),
            bindings.ptr(dist), cap, bindings.ptr(end_bit), bindings.ptr(finished),
            bindings.ptr(status))
        if status[0] == 3:
            cap *= 4
            continue
        if status[0] != 0:
            raise DataError("invalid compressed data")
        return litlen[:ntok], dist[:ntok], int(end_bit[0]), bool(finished[0])


def _tokenize_range_numpy(buf: np.ndarray, w64: np.ndarray, start_bit: int, stop_bit: int):
    """_tokenize_range's numpy branch (tpuzlib's)."""
    avail_bits = len(buf) * 8
    bit_pos = start_bit
    chunks = []
    finished = False
    while True:
        reader = tk.BitReader(buf, bit_pos, avail_bits)
        try:
            last = reader.bits(1)
            btype = reader.bits(2)
            if btype == 0:
                reader.align_byte()
                length = reader.bits(16)
                nlen = reader.bits(16)
                if length != (~nlen & 0xFFFF):
                    raise DataError("invalid stored block lengths")
                byte_pos = reader.pos >> 3
                chunk = buf[byte_pos : byte_pos + length]
                chunks.append((chunk.astype(np.int32), np.zeros(len(chunk), np.int32)))
                bit_pos = (byte_pos + length) * 8
            else:
                if btype == 1:
                    luts = (fixed_litlen_lut(), fixed_dist_lut())
                elif btype == 2:
                    luts = tk.parse_dynamic_header(reader)
                else:
                    raise DataError("invalid block type")
                bit_pos = reader.pos
                while True:
                    litlen, dist, exit_kind, bit_pos = tk.decode_segment(
                        w64, bit_pos, avail_bits, luts[0], luts[1], 1 << 19)
                    if len(litlen):
                        chunks.append((litlen, dist))
                    if exit_kind == tk.EXIT_EOB:
                        break
                    if exit_kind == tk.EXIT_MORE:
                        raise DataError("unexpected end of stream")
            if last:
                finished = True
                break
        except tk.NeedMoreInput:
            raise DataError("unexpected end of stream")
        if bit_pos >= stop_bit:
            break
    if chunks:
        litlen = np.concatenate([c[0] for c in chunks])
        dist = np.concatenate([c[1] for c in chunks])
    else:
        litlen = np.empty(0, np.int32)
        dist = np.empty(0, np.int32)
    return litlen, dist, bit_pos, finished


def inflate_parallel(data, n_segments: int | None = None, max_workers: int | None = None,
                     dictionary: np.ndarray | None = None) -> np.ndarray:
    """Decode a raw DEFLATE stream with speculative segment parallelism.

    Falls back to sequential tokenization for any segment whose
    speculation misses (wrong discovered boundary).  n_segments defaults
    to the usable cores, at most one a 64 KiB of input; max_workers None
    takes the process-wide pool (codec/deflate_engine.get_executor) and
    the usable cores for the expansion.  The bytes never depend on
    either."""
    buf = np.ascontiguousarray(u8_view(data))
    w64 = None if bindings.native_available() else tk.byte_windows64(buf)
    avail_bits = len(buf) * 8
    if n_segments is None:
        n_segments = max(1, min(_ncores(), len(buf) // (1 << 16)))

    # 1. discover candidate starts
    bounds = [0]
    for s in range(1, n_segments):
        found = find_block_start(buf, len(buf) * s // n_segments)
        if found is not None and found > bounds[-1]:
            bounds.append(found)
    stops = bounds[1:] + [avail_bits]

    # 2. tokenize segments in parallel, each tape with its output length
    def work(args):
        litlen, dist, end_bit, fin = _tokenize_range(buf, *args, w64=w64)
        return litlen, dist, end_bit, fin, tape_out_len(litlen, dist)

    if max_workers is None:
        results = list(get_executor().map(work, zip(bounds, stops)))
    else:
        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            results = list(ex.map(work, zip(bounds, stops)))

    # 3. validate the chain; re-tokenize any mis-speculated gap
    tapes = [results[0]]
    for i in range(1, len(results)):
        prev_end = tapes[-1][2]
        if prev_end == bounds[i]:
            tapes.append(results[i])
        else:
            # speculation miss: decode from the true position up to the
            # next verified boundary (or the end)
            tapes.append(work((prev_end, stops[i])))
    if not tapes[-1][3]:
        # keep decoding to the stream's final block
        tail = work((tapes[-1][2], avail_bits))
        if not tail[3]:
            raise DataError("unexpected end of stream")
        tapes.append(tail)

    # 4. expand the tapes a segment a thread; back-references cross them
    window = (
        # inflate dictionaries clip to the last 32K-1 bytes
        # (inflate.ts:489-492)
        u8_view(dictionary)[-((1 << 15) - 1):]
        if dictionary is not None and len(dictionary)
        else np.empty(0, np.uint8)
    )
    return expand_segments([(t[0], t[1], t[4]) for t in tapes], window,
                           max_workers or _ncores())


class Frame(NamedTuple):
    """A whole stream's container, read from its first bytes and its end
    in tpuzlib's order: the DEFLATE payload is view[start:stop]."""

    kind: str  # "gzip", "zlib" or "raw"
    start: int
    stop: int
    dict_id: int | None  # a zlib header's DICTID (FDICT), else None
    trailer: tuple  # gzip (crc32, isize), zlib (adler32,), raw ()


def container_frame(view: np.ndarray) -> Frame:
    """The container of `view` (zlib, gzip or raw by the first bytes), its
    header read by ContainerInflater's parsers, the one parser of each
    header in the port.  Host only; raises tpuzlib's ValueErrors."""
    from ..containers.inflate_container import ContainerInflater

    if len(view) < 2:
        raise ValueError("data buffer is too small")
    b0, b1 = int(view[0]), int(view[1])
    if b0 == 0x1F and b1 == 0x8B:
        consumed = ContainerInflater(raw=False)._try_parse_gzip_header(view)
        if consumed is None:
            raise ValueError("inflate error: truncated gzip header")
        return Frame("gzip", consumed, len(view) - 8, None,
                     struct.unpack("<II", view[-8:].tobytes()))
    if (b0 & 0x0F) == 8 and (b0 >> 4) <= 7 and ((b0 << 8) + b1) % 31 == 0:
        header = ContainerInflater(raw=False)
        hdr = header._parse_zlib_header(view)
        if hdr is None:
            raise ValueError("data buffer is too small")
        return Frame("zlib", hdr, len(view) - 4, header.dict_id,
                     struct.unpack(">I", view[-4:].tobytes()))
    return Frame("raw", 0, len(view), None, ())


def check_dictionary(frame: Frame, dictionary, device) -> None:
    """A zlib DICTID against `dictionary`, as the standard path checks it
    (inflate.ts:475-503), by the public adler32 on `device`: the parallel
    dispatch must not change NEED_DICT semantics with the core count."""
    from ..api.checksums import adler32

    if frame.dict_id is None:
        return
    if dictionary is None:
        raise ValueError("Custom dictionary required for this data")
    if adler32(np.ascontiguousarray(u8_view(dictionary)), device=device) != frame.dict_id:
        raise ValueError("Custom dictionary is not valid for this data")


def check_trailer(frame: Frame, out: np.ndarray, device) -> None:
    """The trailer's CRC-32 and ISIZE, or Adler-32, against `out`, by the
    public checksum on `device` (one launch on a card)."""
    from ..api.checksums import adler32, crc32

    if frame.kind == "gzip":
        stored_crc, isize = frame.trailer
        ok = crc32(out, device=device) == stored_crc and (len(out) & 0xFFFFFFFF) == isize
    elif frame.kind == "zlib":
        ok = adler32(out, device=device) == frame.trailer[0]
    else:
        ok = True
    if not ok:
        raise ValueError("Data integrity check failed")


def inflate_parallel_container(data, n_segments=None, max_workers=None, dictionary=None,
                               verify=True, *, device="cuda"):
    """Container-aware speculative decompression: zlib, gzip or raw by
    the first bytes (container_frame), a zlib DICTID checked against
    `dictionary` (check_dictionary), and with `verify` the trailer's
    CRC-32 (and ISIZE) or Adler-32 (check_trailer), both by the port's
    public checksums on `device`.  Raises tpuzlib's ValueErrors."""
    view = u8_view(data)
    frame = container_frame(view)
    check_dictionary(frame, dictionary, device)
    out = inflate_parallel(view[frame.start : frame.stop], n_segments, max_workers, dictionary)
    if verify:
        check_trailer(frame, out, device)
    return out
