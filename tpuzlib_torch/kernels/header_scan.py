"""The device inflate's full-stream header scan on the card (csrc/header_scan.cu),
and its plain version.

The block planner (kernels/inflate_device2._plan_blocks) needs every
dynamic-block header of a stream past its first block.  On a card,
`block_starts(buf, words, from_bit, allow_final)` finds them and returns
what parallel/speculative.find_all_block_starts(buf, from_bit,
allow_final) returns: `candidates` tests every start bit on the device,
and the host confirms only the survivors (speculative.confirm_block_starts,
the host scan's own confirmation, native or, with the native library
off, in python).

`candidates(words, nbits, from_bit, allow_final)`: the start bits in
[from_bit, nbits - 81] whose header passes the host scan's field checks
(BTYPE 10, BFINAL 0 unless allow_final, HLIT and HDIST fields <= 29) and
its code-length-code Kraft test, and then parses by read_dynamic_tables'
rules (the code lengths' run-length code, lengths[256] != 0, neither code
over-subscribed, an incomplete one only of a single code), as a sorted
int64 array.  The host confirmation parses the header before it decodes,
so it accepts no position this refuses.  words: the stream as int32
words, zero past its nbits bits, at least 4 words past them (the decode's
padded words, inflate_cuda.stream_words).  On CUDA tensors it launches
both kernels of csrc/header_scan.cu (counted in _build.LAUNCHES as
header_filter and header_parse) and reads back the survivors' count and
positions in one copy; on CPU tensors it runs candidates_plain.

`work_plain` counts what the kernels do on a stream, and `bounds_ms` turns
that into each kernel's floor on a card's rates (chip_smoke.py and
probes/header_scan_breakdown.py report both).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.speculative import confirm_block_starts
from ..utils import trace
from . import _build

LAST_BIT_MARGIN = 81  # the host scan tests a start bit while bit + 81 <= nbits
HEAD = 2048  # positions read back with the counts; more take a second copy
_CLC_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
_KRAFT_ONE = 1 << 15  # a complete code's Kraft sum at build_lut's 15 bits
_PLAIN_CHUNK = 1 << 22  # start bits the plain filter takes at once
# integer operations the kernels take at least, counted from csrc/header_scan.cu
FILTER_OPS_PER_WORD = 32  # the field checks of a stream word's 32 start bits, bit-sliced
FILTER_OPS_PER_FIELD_PASS = 64  # the Kraft sum of a start bit past the field checks
PARSE_OPS_PER_SURVIVOR = 160  # the code-length code: 19 lengths, 7 x 19 compares to rank them
PARSE_OPS_PER_SYMBOL = 32  # a code-length symbol decoded, and its rules
PARSE_CHAIN_PER_SYMBOL = 16  # of those, the loop's chain from one symbol's bits to the next's


def _check(words: torch.Tensor, nbits: int, from_bit: int) -> None:
    _build.check_inputs("header_scan words", tuple(words.shape), words)
    if words.dim() != 1 or not 0 <= nbits < 1 << 31 or from_bit < 0:
        raise ValueError("header_scan: words must be 1-D, nbits in [0, 2^31), from_bit >= 0")
    if words.numel() * 32 < nbits + 128:
        raise ValueError("header_scan: words must reach 4 words past the stream's nbits bits")


def _first_cap(nbits: int) -> int:
    """Filter survivors the first launch keeps room for: one in 256 start
    bits, ~3x what zlib's level-9 text passes."""
    return max(4096, nbits >> 8)


def candidates(words: torch.Tensor, nbits: int, from_bit: int = 0,
               allow_final: bool = True) -> np.ndarray:
    """The start bits whose header passes the filter and parses (module
    docstring): on CUDA tensors from the two kernels, on CPU tensors from
    candidates_plain."""
    if _build.on_cpu(words):
        return candidates_plain(words, nbits, from_bit, allow_final)
    _check(words, nbits, from_bit)
    if nbits - LAST_BIT_MARGIN < from_bit:
        return np.empty(0, np.int64)
    dev = words.device
    cap = _first_cap(nbits)
    while True:
        cand = torch.empty(cap, dtype=torch.int32, device=dev)
        res = torch.empty(2 + cap, dtype=torch.int32, device=dev)
        _build.launch(("header_filter", "header_parse"), "tz_header_scan", dev, words.data_ptr(),
                      words.numel(), nbits, from_bit, int(bool(allow_final)), cand.data_ptr(),
                      cap, res.data_ptr())
        head = res[: 2 + min(cap, HEAD)].cpu().numpy()
        trace.count_copy("d2h", dev, head)
        n_filter, n_parse = int(head[0]), int(head[1])
        if n_filter <= cap:
            break
        cap = n_filter  # survivors past the room: scan again with room for all
    pos = head[2 : 2 + n_parse]
    if n_parse > HEAD:
        rest = res[2 + HEAD : 2 + n_parse].cpu().numpy()
        trace.count_copy("d2h", dev, rest)
        pos = np.concatenate([pos, rest])
    return np.sort(pos.astype(np.int64))


def block_starts(buf: np.ndarray, words: torch.Tensor, from_bit: int = 0,
                 allow_final: bool = True) -> list:
    """find_all_block_starts(buf, from_bit, allow_final): the candidates of
    `words` (buf's words, on the device that scans), confirmed on the host.
    The candidates passed to the host count as inflate.scan_candidates while the telemetry is on."""
    pos = candidates(words, len(buf) * 8, from_bit, allow_final)
    if trace.telemetry_enabled():
        trace.count("inflate.scan_candidates", len(pos))
    return confirm_block_starts(buf, pos, allow_final)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _windows(words: torch.Tensor) -> torch.Tensor:
    """int64 w with w[p >> 3] >> (p & 7) holding the 33 bits from bit p, for
    every p up to the words' last 4 bytes."""
    b = words.view(torch.uint8).to(torch.int64)
    n = b.numel() - 4
    return b[:n] | b[1 : n + 1] << 8 | b[2 : n + 2] << 16 | b[3 : n + 3] << 24 | b[4 : n + 4] << 32


def _bits(W: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return W[p >> 3] >> (p & 7)


def _fields_pass(w: torch.Tensor, allow_final: bool) -> torch.Tensor:
    """header_prefilter on the bits `w` from each start bit: BTYPE 10,
    HLIT and HDIST fields <= 29, BFINAL 0 unless allow_final."""
    ok = (((w >> 1) & 3) == 2) & (((w >> 3) & 31) <= 29) & (((w >> 8) & 31) <= 29)
    return ok if allow_final else ok & ((w & 1) == 0)


def _filter_plain(W: torch.Tensor, p: torch.Tensor, allow_final: bool) -> torch.Tensor:
    """The start bits of p whose fields and code-length code pass
    (tz_scan_headers_range's header_prefilter and clc_complete)."""
    w = _bits(W, p)
    ok = _fields_pass(w, allow_final)
    p, w = p[ok], w[ok]
    hclen = ((w >> 13) & 15) + 4
    kraft = torch.zeros_like(p)
    nz = torch.zeros_like(p)
    for j in range(19):
        lj = _bits(W, p + 17 + 3 * j) & 7
        used = (j < hclen) & (lj > 0)
        kraft += torch.where(used, 128 >> lj, 0)
        nz += used
    return p[(kraft == 128) & (nz >= 2)]


def _clc_decoder(W: torch.Tensor, bit: torch.Tensor, hclen: torch.Tensor):
    """Each header's code-length code as (symbol, length) of every 7-bit
    window, (n, 128) each: the canonical code, bit-reversed, matched
    against the window's low bits as build_lut's table is indexed."""
    n = len(bit)
    clen = torch.zeros((n, 19), dtype=torch.int64, device=bit.device)
    for i, sym in enumerate(_CLC_ORDER):
        clen[:, sym] = torch.where(i < hclen, _bits(W, bit + 17 + 3 * i) & 7, 0)
    lens = torch.arange(8, device=bit.device)
    count = (clen[:, :, None] == lens).sum(1)
    count[:, 0] = 0
    next_code = torch.zeros((n, 8), dtype=torch.int64, device=bit.device)
    for b in range(1, 8):
        next_code[:, b] = (next_code[:, b - 1] + count[:, b - 1]) << 1
    syms = torch.arange(19, device=bit.device)
    before = (clen[:, None, :] == clen[:, :, None]) & (syms[None, None, :] < syms[None, :, None])
    code = next_code.gather(1, clen) + before.sum(2)
    rev = torch.zeros_like(code)
    for b in range(7):
        rev |= torch.where(b < clen, ((code >> b) & 1) << (clen - 1 - b).clamp(min=0), 0)
    x = torch.arange(128, device=bit.device)
    match = (clen[:, None, :] > 0) & ((x[None, :, None] & ((1 << clen) - 1)[:, None, :])
                                     == rev[:, None, :])
    sym = match.to(torch.int8).argmax(2)
    return sym, clen.gather(1, sym)


def _parses_plain(W: torch.Tensor, nbits: int, bit: torch.Tensor) -> tuple:
    """read_dynamic_tables' verdict on the header at each start bit of
    `bit` (its fields and code-length code already passed), vectorized
    over the headers: one code-length symbol of every header a step; and
    the symbols each header's parse decoded."""
    w = _bits(W, bit)
    hlit = ((w >> 3) & 31) + 257
    hdist = ((w >> 8) & 31) + 1
    hclen = ((w >> 13) & 15) + 4
    total = hlit + hdist
    sym_of, len_of = _clc_decoder(W, bit, hclen)
    rows = torch.arange(len(bit), device=bit.device)
    zero = torch.zeros_like(bit)
    pos = bit + 17 + 3 * hclen
    i, prev, len256 = zero, zero, zero
    kraft_lit, kraft_dist, codes_lit, codes_dist = zero, zero, zero, zero
    failed = torch.zeros_like(bit, dtype=torch.bool)
    steps = zero
    for _ in range(286 + 30):  # a step writes one length or more
        live = ~failed & (i < total)
        if not bool(live.any()):
            break
        steps = steps + live
        win = _bits(W, pos)
        sym = sym_of[rows, win & 127]
        nb = len_of[rows, win & 127]
        extra = win >> nb
        need = torch.where(sym == 16, 2, torch.where(sym == 17, 3, torch.where(sym == 18, 7, 0)))
        rep = torch.where(sym < 16, 1, torch.where(
            sym == 16, 3 + (extra & 3), torch.where(sym == 17, 3 + (extra & 7), 11 + (extra & 127))))
        v = torch.where(sym < 16, sym, torch.where(sym == 16, prev, 0))
        nlit = torch.minimum((hlit - i).clamp(min=0), rep)
        weight = torch.where(v > 0, 1 << (15 - v).clamp(min=0), 0)
        new_lit = kraft_lit + nlit * weight
        new_dist = kraft_dist + (rep - nlit) * weight
        bad = ((pos + nb + need > nbits) | ((sym == 16) & (i == 0)) | (i + rep > total)
               | (new_lit > _KRAFT_ONE) | (new_dist > _KRAFT_ONE))
        failed = failed | (live & bad)
        go = live & ~bad
        kraft_lit = torch.where(go, new_lit, kraft_lit)
        kraft_dist = torch.where(go, new_dist, kraft_dist)
        codes_lit = torch.where(go & (v > 0), codes_lit + nlit, codes_lit)
        codes_dist = torch.where(go & (v > 0), codes_dist + rep - nlit, codes_dist)
        len256 = torch.where(go & (i <= 256) & (i + rep > 256), v, len256)
        prev = torch.where(go, v, prev)
        pos = torch.where(go, pos + nb + need, pos)
        i = torch.where(go, i + rep, i)
    return (~failed & (len256 != 0) & ((kraft_lit == _KRAFT_ONE) | (codes_lit == 1))
            & ((kraft_dist == _KRAFT_ONE) | (codes_dist <= 1))), steps


def _plain_chunks(words: torch.Tensor, nbits: int, from_bit: int, allow_final: bool):
    """The plain filter and parse a chunk of start bits at a time: for
    each, (its start bits, the field checks' survivors among them, the
    filter's survivors, the parse's verdict on them, the symbols each
    parse decoded)."""
    _check(words, nbits, from_bit)
    W = _windows(words)
    last = nbits - LAST_BIT_MARGIN
    for lo in range(from_bit, last + 1, _PLAIN_CHUNK):
        p = torch.arange(lo, min(last + 1, lo + _PLAIN_CHUNK), dtype=torch.int64,
                         device=words.device)
        fields = int(_fields_pass(_bits(W, p), allow_final).sum())
        surv = _filter_plain(W, p, allow_final)
        ok, steps = _parses_plain(W, nbits, surv)
        yield len(p), fields, surv, ok, steps


def candidates_plain(words: torch.Tensor, nbits: int, from_bit: int = 0,
                     allow_final: bool = True) -> np.ndarray:
    """candidates on any device in torch: the filter over every start bit,
    a chunk at a time, then the parse of its survivors."""
    out = [np.empty(0, np.int64)]
    for _, _, surv, ok, _ in _plain_chunks(words, nbits, from_bit, allow_final):
        out.append(surv[ok].cpu().numpy())
    return np.concatenate(out)


def work_plain(words: torch.Tensor, nbits: int, from_bit: int = 0,
               allow_final: bool = True) -> dict:
    """What the two kernels do on `words` (as candidates takes them),
    counted by the plain version: the start bits the filter tests, those
    past its field checks (`fields`), its survivors, the code-length
    symbols the parse decodes over them (`symbols`) and the most of one
    header (`longest`), and the parse's passes."""
    work = dict(start_bits=0, fields=0, survivors=0, symbols=0, longest=0, passes=0)
    for n, fields, surv, ok, steps in _plain_chunks(words, nbits, from_bit, allow_final):
        work["start_bits"] += n
        work["fields"] += fields
        work["survivors"] += len(surv)
        work["passes"] += int(ok.sum())
        if len(surv):
            work["symbols"] += int(steps.sum())
            work["longest"] = max(work["longest"], int(steps.max()))
    return work


def bounds_ms(work: dict, mem_rate: float, int_rate: float, clock_hz: float) -> dict:
    """Each kernel's floor in ms on a card that moves mem_rate bytes/s,
    issues int_rate integer operations/s and clocks its SMs at clock_hz,
    from work_plain's counts: {kernel: (ms, what bounds it)}.  The filter
    reads the stream once and takes FILTER_OPS_PER_WORD a word and
    FILTER_OPS_PER_FIELD_PASS a field-check survivor.  The parse reads a
    survivor's position and stores a pass (its header's few words are
    left out), takes PARSE_OPS_PER_SURVIVOR a survivor and
    PARSE_OPS_PER_SYMBOL a symbol, and cannot finish before the longest
    header's chain of PARSE_CHAIN_PER_SYMBOL dependent operations a
    symbol, one a cycle at best."""
    terms = {
        "header_filter": {
            "bytes": work["start_bits"] / 8 / mem_rate,
            "operations": (FILTER_OPS_PER_WORD * work["start_bits"] / 32
                           + FILTER_OPS_PER_FIELD_PASS * work["fields"]) / int_rate},
        "header_parse": {
            "bytes": 4 * (work["survivors"] + work["passes"]) / mem_rate,
            "operations": (PARSE_OPS_PER_SURVIVOR * work["survivors"]
                           + PARSE_OPS_PER_SYMBOL * work["symbols"]) / int_rate,
            "chain": PARSE_CHAIN_PER_SYMBOL * work["longest"] / clock_hz},
    }
    return {k: (1e3 * max(t.values()), max(t, key=t.get)) for k, t in terms.items()}
