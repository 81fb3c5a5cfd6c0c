"""The device inflate's host pieces against tpuzlib's, on the CPU: the
block plan, the cursor layout, the header scan, the gap walk, the range
tokenizer and the native expansion.

tpuzlib plans as its Pallas path does (TPUZLIB_PALLAS_TOK=1).  The layout
it hands its tokenizer is read by replacing pallas_cursor_tokenize with a
recorder that ends the call there.  All comparisons are exact.
"""

import zlib

import numpy as np
import pytest
import torch

from tpuzlib.codec import expand as jexpand
from tpuzlib.codec import tokenize as jtk
from tpuzlib.kernels import inflate_device2 as J
from tpuzlib.kernels import inflate_pallas as JP
from tpuzlib.parallel import speculative as jspec
from tpuzlib_torch import testing
from tpuzlib_torch.codec import tokenize as tk
from tpuzlib_torch.codec.expand import expand_host
from tpuzlib_torch.kernels import header_scan as HS
from tpuzlib_torch.kernels import inflate_cuda as PC
from tpuzlib_torch.kernels import inflate_device2 as P
from tpuzlib_torch.parallel import speculative as pspec
from tpuzlib_torch.utils import trace

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

STREAMS = testing.inflate_streams()
STRIDE, MAXC = 1 << 13, 256


class _Recorded(Exception):
    pass


def _jax_layout(monkeypatch, buf, stride_bits=STRIDE, max_cursors=MAXC):
    """The arguments tpuzlib's inflate_device_v2 hands its Pallas tokenizer."""
    monkeypatch.setenv("TPUZLIB_PALLAS_TOK", "1")
    seen = {}

    def record(buf, starts, stops_dec, block_of, plan, stride_bits, overlap_bits, cap,
               words_dev=None, expect_eob=None):
        seen.update(starts=np.asarray(starts), stops_dec=np.asarray(stops_dec),
                    block=np.asarray(block_of), stride_bits=stride_bits,
                    overlap_bits=overlap_bits, cap=cap, expect_eob=np.asarray(expect_eob))
        raise _Recorded

    monkeypatch.setattr(JP, "pallas_cursor_tokenize", record)
    with pytest.raises(_Recorded):
        J.inflate_device_v2(buf, stride_bits=stride_bits, max_cursors=max_cursors)
    return seen


def _block_ends(buf):
    """Every block's true end bit, by decoding the stream block by block."""
    ends, bit, fin = [], 0, False
    while not fin:
        _, _, bit, fin = pspec._tokenize_range(buf, bit, bit + 1)
        ends.append(bit)
    return ends


def _same_lens_info(a, b):
    return a[0] == b[0] and all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_block_plan_matches(name):
    buf = STREAMS[name][0]
    want = J._plan_blocks(buf, build_luts=False)
    got = P._plan_blocks(buf)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.header_bit, g.data_start, g.stop_bit, g.bfinal, g.open_end, g.is_stored) == (
            w[0], w[1], w[2], w[4], w[5], w[6])
        assert _same_lens_info(g.lens_info, w[7])


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_cursor_layout_matches(monkeypatch, name):
    buf = STREAMS[name][0]
    want = _jax_layout(monkeypatch, buf)
    lay = P.plan_cursors(buf, STRIDE, MAXC)
    assert (lay.stride_bits, lay.cap, 2 * P.OVERLAP) == (
        want["stride_bits"], want["cap"], want["overlap_bits"])
    for key in ("starts", "stops_dec", "block", "expect_eob"):
        assert np.array_equal(getattr(lay, key), want[key]), key
    jcp = J._cursor_plan(buf, lay.stride_bits, MAXC, build_luts=False)
    pcp = P._cursor_plan(buf, lay.stride_bits, MAXC)
    assert (pcp.starts, pcp.stops, pcp.block_of, pcp.K, pcp.Kpad) == (
        jcp.starts, jcp.stops, jcp.block_of, jcp.K, jcp.Kpad)
    first, last, bstart, _, stored = jcp.meta
    assert (pcp.first, pcp.last, pcp.bstart, pcp.stored) == (first, last, bstart, stored)


def test_adapted_stride_matches(monkeypatch):
    """A cursor budget too small for the stride: both adapt it alike."""
    buf = STREAMS["hidden stored"][0]
    want = _jax_layout(monkeypatch, buf, STRIDE, 80)
    lay = P.plan_cursors(buf, STRIDE, 80)
    assert lay.stride_bits == want["stride_bits"] > STRIDE
    assert np.array_equal(lay.starts, want["starts"]) and lay.cap == want["cap"]


def test_too_many_cursors_declines(monkeypatch):
    monkeypatch.setenv("TPUZLIB_PALLAS_TOK", "1")
    buf = STREAMS["L1"][0]  # eight blocks: one cursor each is still too many
    assert J.inflate_device_v2(buf, max_cursors=4) is None
    assert P.inflate_device_v2(buf, max_cursors=4, device="cpu") is None
    with pytest.raises(P.DeviceDeclined):
        P.plan_cursors(buf, STRIDE, 4)


def test_stream_over_two_to_the_29_bits_declines(monkeypatch):
    """Tape bit positions must stay below their sentinel: a stream of 2^29
    bits (64 MiB) or more declines before it is planned."""
    assert P.MAX_STREAM_BITS == 1 << 29 == PC.SENT_BP >> 1
    big = np.zeros(P.MAX_STREAM_BITS // 8, np.uint8)
    with pytest.raises(P.DeviceDeclined, match="2\\^29"):
        P.plan_cursors(big)
    assert P.inflate_device_v2(big, device="cpu") is None
    with pytest.raises(ValueError, match="2\\^29"):
        PC.prepare(big, [0], [8], [0], [P.Block(0, 3, 8, True, False, False, ("fixed",))],
                   STRIDE, 2 * P.OVERLAP, 64, device="cpu")
    # the bound is exact: a stream of one bit less than the limit plans
    buf = STREAMS["L6"][0]
    monkeypatch.setattr(P, "MAX_STREAM_BITS", len(buf) * 8)
    with pytest.raises(P.DeviceDeclined, match="2\\^29"):
        P.plan_cursors(buf, STRIDE, MAXC)
    monkeypatch.setattr(P, "MAX_STREAM_BITS", len(buf) * 8 + 1)
    assert P.plan_cursors(buf, STRIDE, MAXC).K > 1


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_header_scan_matches(name):
    buf = STREAMS[name][0]
    for from_bit in (0, 8 * 1000, 8 * (len(buf) // 2)):
        for allow_final in (True, False):
            assert pspec.find_all_block_starts(buf, from_bit, allow_final) == (
                jspec.find_all_block_starts(buf, from_bit, allow_final))


def _scan_streams() -> dict:
    """Streams for the card's header scan: the plan's zlib streams (levels
    1, 6, 9, sync flushes, stored blocks), random bytes (~0.09% of their
    start bits pass the field and Kraft tests, none parses), level-9 text
    of 27 blocks, that stream cut so its first later header lies 81 bits
    from the end and one byte closer, and cut 4 bits into that block's
    data (its header parses, its decode does not confirm it)."""
    out = {k: STREAMS[k][0] for k in ("L1", "L6", "L9", "sync flush", "stored", "hidden stored")}
    out["random"] = np.random.default_rng(11).integers(0, 256, 1 << 16, dtype=np.uint8)
    text = testing.corpus("text", 3 << 19, 12)
    l9 = np.frombuffer(testing.zlib_stream(text, 9, -15), np.uint8)
    out["text L9"] = l9
    h = pspec.find_all_block_starts(l9, 0, True)[0]
    out["header 81 bits from the end"] = l9[: (h + 81 + 7) // 8]
    out["header 81 bits from the end, less a byte"] = l9[: (h + 81 + 7) // 8 - 1]
    data_start = pspec._probe_header(l9, h, len(l9) * 8)[1]
    out["cut after a header"] = l9[: (data_start + 4 + 7) // 8]
    return out


SCAN_STREAMS = _scan_streams()
SCAN_CASES = [(name, from_bit, allow_final) for name in sorted(SCAN_STREAMS)
              for from_bit in (0, 8 * 1000 + 3) for allow_final in (True, False)]


def _parsed_headers(buf, from_bit, allow_final):
    """The native scan's parse of every start bit it tests, [from_bit,
    nbits - 81]: the field checks, the code-length code's Kraft test and
    read_dynamic_tables (tz_header_candidates)."""
    pos = pspec._header_candidates(buf, len(buf) * 8 - 80, allow_final)
    return pos[pos >= from_bit]


@pytest.mark.parametrize("name,from_bit,allow_final", SCAN_CASES)
def test_card_scan_plain_matches(name, from_bit, allow_final):
    """The card scan's plain twin (its wrapper on CPU tensors) passes
    exactly the start bits whose header the native scan's parse accepts,
    and with the host's confirmation gives find_all_block_starts'
    positions."""
    buf = SCAN_STREAMS[name]
    words = PC.stream_words(buf, STRIDE, 2 * P.OVERLAP, "cpu")
    cands = HS.candidates(words, len(buf) * 8, from_bit, allow_final)
    assert cands.dtype == np.int64 and np.array_equal(cands, _parsed_headers(buf, from_bit,
                                                                             allow_final))
    want = pspec.find_all_block_starts(buf, from_bit, allow_final)
    assert HS.block_starts(buf, words, from_bit, allow_final) == want
    assert set(want) <= set(cands.tolist())


@pytest.mark.parametrize("allow_final", [True, False])
@pytest.mark.parametrize("name", sorted(SCAN_STREAMS))
def test_card_scan_plain_matches_without_native(name, allow_final):
    """With the native library switched off, the card scan's plain twin
    and the host's python confirmation give the numpy scan's positions
    (find_all_block_starts' branch without the native library)."""
    buf = SCAN_STREAMS[name]
    words = PC.stream_words(buf, STRIDE, 2 * P.OVERLAP, "cpu")
    from_bit = 8 * 1000 + 3 if name == "random" else 0
    with testing.no_native():
        want = pspec.find_all_block_starts(buf, from_bit, allow_final)
        assert HS.block_starts(buf, words, from_bit, allow_final) == want


@pytest.mark.parametrize("name", sorted(SCAN_STREAMS))
def test_card_scan_work_counts(name):
    """work_plain counts what the kernels do: every start bit up to 81
    from the end tested, the filter's survivors and the parse's passes as
    the plain version finds them, one code-length symbol a survivor at
    least and HLIT + HDIST (316) a header at most; bounds_ms floors each
    kernel by what bounds it."""
    buf = SCAN_STREAMS[name]
    nbits = len(buf) * 8
    words = PC.stream_words(buf, STRIDE, 2 * P.OVERLAP, "cpu")
    work = HS.work_plain(words, nbits)
    survivors = HS._filter_plain(HS._windows(words), torch.arange(nbits - 80), True)
    assert work["start_bits"] == nbits - 80
    assert work["survivors"] == len(survivors) <= work["fields"] <= work["start_bits"]
    assert work["passes"] == len(HS.candidates(words, nbits))
    assert work["survivors"] <= work["symbols"] <= 316 * work["survivors"]
    assert work["longest"] <= 316 and (work["longest"] > 0) == (work["survivors"] > 0)
    bounds = HS.bounds_ms(work, 3.35e12, 132 * 64 * 1.98e9, 1.98e9)
    assert bounds["header_filter"][1] in ("bytes", "operations")
    assert (bounds["header_filter"][0] > 0) == (work["start_bits"] > 0)
    if work["survivors"]:
        assert bounds["header_parse"][1] in ("operations", "chain")
        assert bounds["header_parse"][0] > 0


@pytest.mark.parametrize("name", sorted(SCAN_STREAMS))
def test_card_filter_never_refuses_a_confirmed_header(name):
    """Every start bit that passes the host scan's field and Kraft tests
    (the filter's survivors) and that the host's confirmation accepts is
    among the card scan's candidates: the parse is a necessary condition
    of the confirmation.  Where the stream is cut after a header, the
    parse passes a start bit that the confirmation refuses."""
    buf = SCAN_STREAMS[name]
    words = PC.stream_words(buf, STRIDE, 2 * P.OVERLAP, "cpu")
    survivors = HS._filter_plain(HS._windows(words), torch.arange(len(buf) * 8 - 80), True)
    confirmed = pspec.confirm_block_starts(buf, survivors.numpy())
    cands = HS.candidates(words, len(buf) * 8, 0, True).tolist()
    assert set(confirmed) <= set(cands)
    assert confirmed == pspec.find_all_block_starts(buf, 0, True)
    if name == "cut after a header":
        assert len(cands) == len(confirmed) + 1


def test_plan_with_the_card_scan(monkeypatch):
    """plan_cursors with the card's header scan (run here by its plain
    twin on CPU tensors): the layout of the host scan, the stream words
    kept for the decode (decode_args hands on the same tensor), the scan
    counters, and the decode's bytes."""
    buf, src = STREAMS["L1"]
    was = trace.telemetry_enabled()
    trace.enable(True)
    try:
        before = trace.get_counters()
        host = P.plan_cursors(buf, STRIDE, MAXC)
        moved_host = testing.counters_since(before)
        monkeypatch.setattr(P, "_scans_on_card", lambda device: True)
        before = trace.get_counters()
        card = P.plan_cursors(buf, STRIDE, MAXC, device="cpu")
        moved_card = testing.counters_since(before)
    finally:
        trace.enable(was)
    assert host.words is None and card.words is not None
    for key in ("starts", "stops", "stops_dec", "block", "expect_eob"):
        assert np.array_equal(getattr(card, key), getattr(host, key)), key
    assert [b.header_bit for b in card.plan] == [b.header_bit for b in host.plan]
    assert card.decode_args(buf, "cpu").words is card.words
    assert torch.equal(card.words, PC.stream_words(buf, card.stride_bits, 2 * P.OVERLAP, "cpu"))
    scanned = len(buf) - (card.plan[0].data_start >> 3)
    assert moved_host["inflate.scan_host"] == moved_card["inflate.scan_card"] == scanned
    assert moved_card["inflate.scan_candidates"] == len(card.plan) - 1
    assert "inflate.scan_card" not in moved_host and "inflate.scan_host" not in moved_card
    out, end = P.decode_stream(buf, None, STRIDE, MAXC, device="cpu")
    monkeypatch.undo()
    assert out.tobytes() == src.tobytes()
    assert end == P.decode_stream(buf, None, STRIDE, MAXC, device="cpu")[1]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_gap_walk_matches(name):
    """_parse_gap and _walk_gap at every block end, at every header, and
    at random bits, with and without a stop."""
    buf = STREAMS[name][0]
    avail = len(buf) * 8
    headers = [p.header_bit for p in P._plan_blocks(buf)]
    rng = np.random.default_rng(1)
    bits = _block_ends(buf) + headers + rng.integers(0, avail, 300).tolist()
    for bit in bits:
        assert P._parse_gap(buf, bit, avail) == J._parse_gap(buf, bit, avail)
        for stop_at in (None, *headers):
            assert P._walk_gap(buf, bit, avail, stop_at) == J._walk_gap(buf, bit, avail, stop_at)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_range_tokenizer_matches(name):
    buf, src = STREAMS[name]
    avail = len(buf) * 8
    ends = _block_ends(buf)
    for start, stop in ((0, avail), (0, 1), *zip([0] + ends[:-1], [e + 1 for e in ends])):
        got = pspec._tokenize_range(buf, start, stop)
        want = jspec._tokenize_range(buf, None, start, stop, avail)
        assert all(np.array_equal(g, w) for g, w in zip(got[:2], want[:2]))
        assert got[2:] == tuple(want[2:])
    litlen, dist, _, fin = pspec._tokenize_range(buf, 0, avail)
    assert fin and expand_host(litlen, dist, np.empty(0, np.uint8)).tobytes() == src.tobytes()
    half = buf[: len(buf) // 2]
    with pytest.raises(jtk.DataError):
        jspec._tokenize_range(half, None, 0, avail, len(half) * 8)
    with pytest.raises(tk.DataError):
        pspec._tokenize_range(half, 0, avail)


def test_expand_host_matches():
    """The native expansion with and without a history window, and its
    error on a distance that reaches before it."""
    data = testing.corpus("text", 1 << 16, 4)
    dictionary = data[:4096]
    c = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=dictionary.tobytes())
    buf = np.frombuffer(c.compress(data[4096:].tobytes()) + c.flush(), np.uint8)
    litlen, dist, _, _ = pspec._tokenize_range(buf, 0, len(buf) * 8)
    for window in (dictionary, dictionary[-100:], np.empty(0, np.uint8)):
        try:
            want = jexpand.expand_host(litlen, dist, window)
        except jtk.DataError as e:
            with pytest.raises(tk.DataError, match=str(e)):
                expand_host(litlen, dist, window)
            continue
        assert np.array_equal(expand_host(litlen, dist, window), want)
    assert expand_host(litlen, dist, dictionary).tobytes() == data[4096:].tobytes()
    assert len(expand_host(litlen[:0], dist[:0], dictionary)) == 0
    with pytest.raises(tk.DataError, match="invalid distance too far back"):
        expand_host(np.array([65, 3], np.int32), np.array([0, 2], np.int32), np.empty(0, np.uint8))
