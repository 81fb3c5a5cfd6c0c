"""The speculative host inflate (tpuzlib_torch.parallel.speculative),
inflate()'s host dispatch to it, and utils/mem.tune_malloc, on the CPU
against tpuzlib.

Seeded streams of 1-3 MiB (testing.corpus / testing.mixed compressed by
python zlib); both packages get the same n_segments and max_workers, so
the boundaries find_block_start finds are the same targets' and are
compared too.  inflate() with the dispatch forced: the port's constants
patched, tpuzlib with TPUZLIB_SPECULATIVE=1; the same bytes or the same
exception type and message, and the port's route asserted by the
inflate.speculative counter.
"""

import gzip
import logging
import zlib

import numpy as np
import pytest
import torch

import tpuzlib
import tpuzlib_torch
from tpuzlib.parallel import speculative as jsp
from tpuzlib_torch import testing
from tpuzlib_torch.api import checksums, deflate_api, inflate_api
from tpuzlib_torch.codec import expand
from tpuzlib_torch.kernels.inflate_device2 import DeviceDeclined
from tpuzlib_torch.parallel import speculative as sp
from tpuzlib_torch.utils import trace
from tpuzlib_torch.utils import mem

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

TEXT = testing.corpus("text", 3 << 20, seed=11)
MIXED = testing.mixed(2 << 20, seed=12)
# tpuzlib's "mixed content" case: text, random bytes, text
SANDWICH = np.concatenate([TEXT[: 1 << 19], testing.corpus("random", 1 << 19, seed=13),
                           TEXT[1 << 19 : 1 << 20]])
DICT = TEXT[-4000:]


def _raw(data, level):
    return np.frombuffer(testing.zlib_stream(data, level, -15), np.uint8)


RAW = {level: _raw(MIXED[: 1 << 20] if level != 6 else MIXED, level) for level in (1, 6, 9)}


def _outcome(fn):
    """("bytes", the bytes) or (exception type name, message)."""
    try:
        return "bytes", np.asarray(fn()).tobytes()
    except Exception as e:  # noqa: BLE001 - both packages' exceptions compared
        return type(e).__name__, str(e)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_find_block_start_matches_tpuzlib(level):
    """The bit positions found from the targets inflate_parallel uses at
    8 segments, and from a few others, equal tpuzlib's; every one found
    starts a run that tokenizes to the stream's end."""
    buf = RAW[level]
    targets = [len(buf) * s // 8 for s in range(1, 8)] + [1, 4093, len(buf) - 100, len(buf)]
    found = 0
    for t in targets:
        got = sp.find_block_start(buf, t)
        assert got == jsp.find_block_start(buf, t), t
        if got is not None:
            found += 1
            litlen, _, end, fin = sp._tokenize_range(buf, got, len(buf) * 8)
            assert fin and end <= len(buf) * 8 and len(litlen) > 100
    assert found >= 6


def test_kraft_prefilter_and_probes_match_tpuzlib():
    """The native candidates of a region (the port's Kraft prefilter and
    header parse) are exactly tpuzlib's _kraft_prefilter survivors that
    its _probe_header accepts, in the middle of a stream and where the
    region ends inside headers; on every prefilter candidate the header
    probe and the confirm give tpuzlib's answers; with and without final
    blocks allowed."""
    buf = RAW[6]
    # a real header 8000 bytes into the first region; the second region
    # ends 20 bytes into it
    at = sp.find_block_start(buf, len(buf) // 3) // 8
    for region, limit in ((buf[at - 8000 : at + 8384], 1 << 16),
                          (buf[at - 3000 : at + 20], 3020 * 8)):
        region = np.ascontiguousarray(region)
        bits = len(region) * 8
        w64 = sp.tk.byte_windows64(region)
        for allow_final in (False, True):
            cand = jsp._kraft_prefilter(w64, 0, limit, allow_final=allow_final)
            assert len(cand) >= 5
            parsed = [int(r) for r in cand
                      if jsp._probe_header(region, int(r), bits, allow_final) is not None]
            assert sp._header_candidates(region, limit, allow_final).tolist() == parsed
            assert parsed or limit < 1 << 16
            for rel in cand[:200].tolist():
                got = sp._probe_header(region, rel, bits, allow_final)
                want = jsp._probe_header(region, rel, bits, allow_final)
                assert (got is None) == (want is None)
                if got is not None:
                    assert got[1] == want[1] and all(np.array_equal(a, b)
                                                     for a, b in zip(got[0], want[0]))
                    assert (sp._confirm(w64, got[1], bits, got[0])
                            == jsp._confirm(w64, want[1], bits, want[0]))


@pytest.mark.parametrize("pieces", [1, 3, 40])
@pytest.mark.parametrize("dictionary", [False, True])
def test_expand_segments_matches_expand_host(pieces, dictionary):
    """The segment-parallel expansion gives expand_host's bytes for a tape
    cut at seeded token boundaries, among them an empty piece and, at 40
    pieces, pieces shorter than the 32 KiB window, so a window resolves
    through several pieces, against a preset dictionary or none."""
    data = TEXT[: 1 << 19]
    window = DICT if dictionary else np.empty(0, np.uint8)
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 8, 0, *([DICT.tobytes()] if dictionary else []))
    wire = np.frombuffer(c.compress(data.tobytes()) + c.flush(), np.uint8)
    litlen, dist, _, fin = sp._tokenize_range(wire, 0, len(wire) * 8)
    assert fin
    cuts = np.sort(np.random.default_rng(pieces).choice(len(litlen), pieces - 1, replace=False))
    if pieces > 1:
        cuts[1] = cuts[0]  # an empty piece
    tapes = [(a, b, expand.tape_out_len(a, b))
             for a, b in zip(np.split(litlen, cuts), np.split(dist, cuts))]
    got = expand.expand_segments(tapes, window, 3)
    assert got.tobytes() == expand.expand_host(litlen, dist, window).tobytes() == data.tobytes()


@pytest.mark.parametrize("window", [0, 1])
def test_expand_segments_too_far_back(window):
    """A distance past the stream's start (and its dictionary) raises
    expand_host's DataError, in the first piece or a later one."""
    litlen = np.array([65, 66, 3, 67, 4], np.int32)
    dist = np.array([0, 0, 2, 0, 7 + window], np.int32)  # one byte too far
    win = np.full(window, 90, np.uint8)
    with pytest.raises(sp.DataError, match="invalid distance too far back"):
        expand.expand_host(litlen, dist, win)
    for cut in (1, 3, 4):
        tapes = [(litlen[:cut], dist[:cut], expand.tape_out_len(litlen[:cut], dist[:cut])),
                 (litlen[cut:], dist[cut:], expand.tape_out_len(litlen[cut:], dist[cut:]))]
        with pytest.raises(sp.DataError, match="invalid distance too far back"):
            expand.expand_segments(tapes, win, 2)


@pytest.mark.parametrize("segments", [1, 2, 5, 8])
@pytest.mark.parametrize("level", [1, 6, 9])
def test_inflate_parallel_matches_tpuzlib(level, segments):
    buf = RAW[level]
    want = MIXED[: 1 << 20] if level != 6 else MIXED
    got = sp.inflate_parallel(buf, n_segments=segments, max_workers=2)
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == np.asarray(jsp.inflate_parallel(buf, n_segments=segments,
                                                            max_workers=2)).tobytes()


@pytest.mark.parametrize("name", ["stored", "mixed content", "dictionary", "default pool"])
def test_inflate_parallel_other_streams(name):
    """Random bytes (stored blocks: discovery finds no dynamic header and
    the chain falls back to sequential), text around random bytes at
    level 9, a raw stream against a preset dictionary, and the process
    pool with the default segment count."""
    dictionary, segments, workers = None, 4, 2
    if name == "stored":
        data = testing.corpus("random", 1 << 20, seed=14)
        wire = testing.zlib_stream(data, 6, -15)
    elif name == "mixed content":
        data = SANDWICH
        wire = testing.zlib_stream(data, 9, -15)
    elif name == "dictionary":
        data = TEXT[: 1 << 20]
        c = zlib.compressobj(6, zlib.DEFLATED, -15, 8, 0, DICT.tobytes())
        wire = c.compress(data.tobytes()) + c.flush()
        dictionary, segments = DICT, 2
    else:
        data, wire, segments, workers = TEXT, testing.zlib_stream(TEXT, 6, -15), None, None
    got = sp.inflate_parallel(wire, segments, workers, dictionary)
    assert got.tobytes() == data.tobytes()
    assert got.tobytes() == np.asarray(jsp.inflate_parallel(wire, segments, workers,
                                                            dictionary)).tobytes()


def _fdict(data, dictionary, level=6) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, 15, 8, 0, dictionary.tobytes())
    return c.compress(data.tobytes()) + c.flush()


def _flip(wire: bytes, i: int) -> bytes:
    return wire[:i] + bytes([wire[i] ^ 0x01]) + wire[i + 1 :]


DATA = MIXED[: 1 << 20]
Z = zlib.compress(DATA.tobytes(), 6)
GZ = gzip.compress(DATA.tobytes(), 6, mtime=3)
FD = _fdict(DATA, DICT)
CONTAINER_CASES = {
    # name -> (wire, dictionary)
    "zlib": (Z, None),
    "zlib, flipped adler": (_flip(Z, len(Z) - 1), None),
    "zlib, cut": (Z[: len(Z) // 2], None),
    "zlib, header only": (Z[:2], None),
    "gzip": (GZ, None),
    "gzip, flipped crc": (_flip(GZ, len(GZ) - 6), None),
    "gzip, flipped isize": (_flip(GZ, len(GZ) - 1), None),
    "gzip, cut": (GZ[: len(GZ) // 3], None),
    "gzip, cut header": (GZ[:9], None),
    "raw": (testing.zlib_stream(DATA, 1, -15), None),
    "raw, cut": (testing.zlib_stream(DATA, 1, -15)[:-20], None),
    "fdict": (FD, DICT),
    "fdict, flipped adler": (_flip(FD, len(FD) - 2), DICT),
    "fdict, no dictionary": (FD, None),
    "fdict, wrong dictionary": (FD, TEXT[:4000]),
    "fdict, cut in the dictid": (FD[:5], DICT),
    "one byte": (Z[:1], None),
}


@pytest.mark.parametrize("name", sorted(CONTAINER_CASES))
def test_inflate_parallel_container_matches_tpuzlib(name):
    wire, dictionary = CONTAINER_CASES[name]
    got = _outcome(lambda: sp.inflate_parallel_container(wire, 3, 2, dictionary, device="cpu"))
    assert got == _outcome(lambda: jsp.inflate_parallel_container(wire, 3, 2, dictionary))
    if "," not in name and name != "one byte":
        assert got == ("bytes", DATA.tobytes())


@pytest.fixture
def forced(monkeypatch):
    """The speculative dispatch forced in both packages, whatever the
    host's cores and the stream's size.  inflate(device="cpu") takes the
    host route directly: the device decode, were it reached, declines
    the stream, as it declines one of 2^29 bits or more, and counts it."""
    monkeypatch.setattr(inflate_api, "SPECULATIVE_MIN_CORES", 1)
    monkeypatch.setattr(inflate_api, "SPECULATIVE_MIN_BYTES", 0)
    monkeypatch.setenv("TPUZLIB_SPECULATIVE", "1")

    def decline(*args, **kwargs):
        raise DeviceDeclined("declined by the test")

    monkeypatch.setattr(inflate_api, "decode_stream", decline)


@pytest.mark.parametrize("name", sorted(CONTAINER_CASES))
def test_inflate_dispatch_matches_tpuzlib(name, forced):
    wire, dictionary = CONTAINER_CASES[name]
    before = trace.get_counters()
    got = _outcome(lambda: tpuzlib_torch.inflate(wire, dictionary, device="cpu"))
    moved = testing.counters_since(before)
    assert got == _outcome(lambda: tpuzlib.inflate(wire, dictionary))
    if got[0] == "bytes":
        # the speculative decode gave the bytes (a failure of it that is
        # not a ValueError would have left the count where it was)
        assert moved.get("inflate.speculative", 0) == len(got[1]) > 0
    assert not any(k.startswith("inflate.device") for k in moved)


def test_dispatch_thresholds(monkeypatch):
    """tpuzlib's thresholds (8 cores, 16 MiB); a stream one byte short of
    the size, or a host one core short, decodes on the Inflater."""
    assert (inflate_api.SPECULATIVE_MIN_CORES, inflate_api.SPECULATIVE_MIN_BYTES) == (8, 16 << 20)
    for cores, min_bytes, routed in ((8, len(Z), True), (8, len(Z) + 1, False),
                                     (7, len(Z), False)):
        monkeypatch.setattr(inflate_api, "_ncores", lambda: cores)
        monkeypatch.setattr(inflate_api, "SPECULATIVE_MIN_BYTES", min_bytes)
        before = trace.get_counters()
        out = inflate_api._inflate_host(np.frombuffer(Z, np.uint8), None, "cpu")
        assert out.tobytes() == DATA.tobytes()
        assert (testing.counters_since(before).get("inflate.speculative", 0)
                == (len(DATA) if routed else 0))


def test_speculative_failure_falls_back_logged(forced, monkeypatch, caplog):
    """An error of the speculative host decode that is not a ValueError
    is logged on the tpuzlib_torch logger and the Inflater decodes; a
    ValueError is the verdict and propagates."""

    def boom(*args, **kwargs):
        raise RuntimeError("a fault of the speculative decode")

    monkeypatch.setattr(inflate_api, "inflate_parallel", boom)
    before = trace.get_counters()
    with caplog.at_level(logging.WARNING, logger="tpuzlib_torch"):
        out = tpuzlib_torch.inflate(Z, device="cpu")
    assert out.tobytes() == DATA.tobytes()
    moved = testing.counters_since(before)
    assert "inflate.speculative" not in moved
    assert not any(k.startswith("inflate.device") for k in moved)
    assert any("speculative inflate failed (RuntimeError: a fault of the speculative decode)"
               in r.getMessage() for r in caplog.records)

    def verdict(*args, **kwargs):
        raise ValueError("a verdict of the speculative decode")

    monkeypatch.setattr(inflate_api, "inflate_parallel", verdict)
    with pytest.raises(ValueError, match="a verdict of the speculative decode"):
        tpuzlib_torch.inflate(Z, device="cpu")


@pytest.mark.parametrize("name, checksum", [("zlib", "adler32"), ("gzip", "crc32"),
                                           ("fdict", "adler32")])
def test_card_errors_of_the_speculative_route_propagate(name, checksum, forced, monkeypatch):
    """A RuntimeError of the trailer's or the DICTID's checksum on
    `device` (a kernel that fails to build or launch, or runs out of
    memory) reaches the caller; the Inflater does not decode the stream
    again."""

    def card_fails(*args, **kwargs):
        raise RuntimeError("the card failed")

    def no_inflater(*args, **kwargs):
        raise AssertionError("the Inflater ran")

    wire, dictionary = CONTAINER_CASES[name]
    monkeypatch.setattr(checksums, checksum, card_fails)
    monkeypatch.setattr(inflate_api, "Inflater", no_inflater)
    with pytest.raises(RuntimeError, match="the card failed"):
        tpuzlib_torch.inflate(wire, dictionary, device="cpu")


def test_tune_malloc(monkeypatch):
    """Idempotent, and off with TPUZLIB_MALLOC_TUNE=0; inflate() and
    deflate() call it before anything else."""
    monkeypatch.setattr(mem, "_done", False)
    monkeypatch.setenv("TPUZLIB_MALLOC_TUNE", "0")
    assert mem.tune_malloc() is False and mem._done is False
    monkeypatch.delenv("TPUZLIB_MALLOC_TUNE")
    assert mem.tune_malloc() is True and mem.tune_malloc() is True and mem._done is True
    monkeypatch.setenv("TPUZLIB_MALLOC_TUNE", "0")
    assert mem.tune_malloc() is True  # once on, it stays on

    class First(Exception):
        pass

    def first():
        raise First

    for module, call in ((inflate_api, lambda: tpuzlib_torch.inflate(b"", device="cpu")),
                         (deflate_api, lambda: tpuzlib_torch.deflate(1.5, device="cpu"))):
        with monkeypatch.context() as m:
            m.setattr(module, "tune_malloc", first)
            with pytest.raises(First):
                call()
