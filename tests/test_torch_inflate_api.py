"""tpuzlib_torch.inflate's device route on the CPU against tpuzlib.inflate
and zlib: zlib, gzip and raw streams, gzip headers with every optional
field, bytes after the stream (garbage, a second gzip member) that both
ignore, and the verdicts: a bad trailer and a truncated stream fall back
to the host engine (counted), which raises tpuzlib's ValueError; a
trailer cut short raises it too; preset dictionaries decode on the host
engine; ValueError on bad input.

inflate(device="cpu") never takes the device route (its route rule), so
the device route runs here as inflate() runs it on a card for a stream
the rule sends there (_card_route): testing.inflate_device_route (the
route at any size, raw streams too), and inflate(device="cpu"), the host
route, where it leaves the stream to the host.
"""

import gzip
import struct
import zlib

import numpy as np
import pytest
import torch

import tpuzlib
import tpuzlib_torch
from tpuzlib.containers.inflate_container import ContainerInflater
from tpuzlib_torch import testing
from tpuzlib_torch.utils import trace
from tpuzlib_torch.containers.inflate_container import ContainerInflater as PortContainer

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

DATA = testing.inflate_streams()["hidden stored"][1]


def _gzip_with_fields(data: np.ndarray) -> bytes:
    """A gzip member with FEXTRA, FNAME, FCOMMENT and FHCRC set."""
    head = bytearray(b"\x1f\x8b\x08\x1e" + struct.pack("<I", 1_700_000_000) + b"\x00\xff")
    head += struct.pack("<H", 5) + b"extra" + b"name.txt\x00" + b"a comment\x00"
    head += struct.pack("<H", zlib.crc32(bytes(head)) & 0xFFFF)
    body = testing.zlib_stream(data, 6, -15)
    return bytes(head) + body + struct.pack("<II", zlib.crc32(data.tobytes()),
                                            len(data) & 0xFFFFFFFF)


STREAMS = {
    "zlib": zlib.compress(DATA.tobytes(), 6),
    "gzip (python)": gzip.compress(DATA.tobytes(), 9, mtime=0),
    "gzip (port)": testing.device_route(DATA, format="gzip").tobytes(),
    "gzip (all header fields)": _gzip_with_fields(DATA),
    "raw": testing.zlib_stream(DATA, 1, -15),
    "raw (port)": testing.device_route(DATA, format="raw", level=9).tobytes(),
}


def _routed(fn):
    """fn()'s result (or its ValueError) and what it moved of the event
    counters: the two fallbacks and the bytes the device route returned."""
    before = trace.get_counters()
    try:
        out = fn()
    except ValueError as e:
        out = e
    moved = testing.counters_since(before)
    return out, {k: moved.get("inflate." + k, 0)
                 for k in ("device_fallback", "device_mismatch_fallback", "device")}


def _card_route(wire):
    """inflate()'s result on a card for a stream its rule sends to the
    device route: that route's bytes, or where it leaves the stream to the
    host route, the host route's.  A zlib stream with FDICT the rule keeps
    on the host route (inflate_api.device_route_applies)."""
    b0, b1 = bytes(wire[:2])
    fdict = b0 == 0x78 and (b0 << 8 | b1) % 31 == 0 and b1 & 0x20
    out = None if fdict else testing.inflate_device_route(wire)
    return out if out is not None else tpuzlib_torch.inflate(wire, device="cpu")


def _on_device(n_bytes: int) -> dict:
    """The counter moves of calls whose `n_bytes` all came from the device
    route, with no fallback."""
    return {"device_fallback": 0, "device_mismatch_fallback": 0, "device": n_bytes}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_inflate_matches_tpuzlib(name):
    """Every stream is decoded by the device route (its plain version on
    the CPU), not by the host engine behind it; inflate(device="cpu")
    decodes it on the host route, with the same bytes."""
    wire = STREAMS[name]
    got, counted = _routed(lambda: _card_route(wire))
    assert counted == _on_device(len(DATA))
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert got.tobytes() == DATA.tobytes() == np.asarray(tpuzlib.inflate(wire)).tobytes()
    for kind in (bytes, bytearray, memoryview):
        again, counted = _routed(lambda: _card_route(kind(wire)))
        assert again.tobytes() == got.tobytes() and counted == _on_device(len(DATA))
    host, counted = _routed(lambda: tpuzlib_torch.inflate(wire, device="cpu"))
    assert host.tobytes() == got.tobytes() and counted == _on_device(0)


def test_headers_match_tpuzlib():
    """The port's one header parser (ContainerInflater's, which the device
    route reads) gives tpuzlib's header sizes, fields and verdicts."""
    for name, wire in STREAMS.items():
        buf = np.frombuffer(wire, np.uint8)
        if name.startswith("gzip"):
            ours, theirs = PortContainer(raw=False), ContainerInflater(raw=False)
            size = ours._parse_header(buf)
            assert size == theirs._try_parse_gzip_header(buf)
            assert (ours.mtime, ours.file_name) == (theirs.mtime, theirs.file_name)
            assert PortContainer(raw=False)._parse_header(buf[: size - 1]) is None
        elif name == "zlib":
            assert PortContainer(raw=False)._parse_header(buf) == 2 == (
                ContainerInflater(raw=False)._try_parse_header(buf))
    named = PortContainer(raw=False)
    named._parse_header(np.frombuffer(STREAMS["gzip (all header fields)"], np.uint8))
    assert named.file_name == "name.txt"
    fdict = np.frombuffer(b"\x78\xbb" + struct.pack(">I", 0xDEADBEEF), np.uint8)
    c = PortContainer(raw=False)
    assert c._parse_header(fdict) == 6 and c.dict_id == 0xDEADBEEF
    assert PortContainer(raw=False)._parse_header(fdict[:5]) is None
    with pytest.raises(Exception, match="required") as ours:
        PortContainer(raw=False)._try_parse_header(fdict)
    with pytest.raises(Exception, match="required") as theirs:
        ContainerInflater(raw=False)._try_parse_header(fdict)
    assert type(ours.value).__name__ == type(theirs.value).__name__ == "NeedDictionary"


def test_device_route_reads_the_container_parser(monkeypatch):
    """The device route takes each stream's header size from
    ContainerInflater._parse_header; a header it refuses (a gzip header
    CRC that does not match) and a zlib header with FDICT leave the
    stream to the host engine, uncounted, which gives tpuzlib's verdict."""
    seen = []
    real = PortContainer._parse_header

    def spy(self, buf):
        seen.append(real(self, buf))
        return seen[-1]

    monkeypatch.setattr(PortContainer, "_parse_header", spy)
    for name in ("zlib", "gzip (all header fields)"):
        got, counted = _routed(lambda: _card_route(STREAMS[name]))
        assert got.tobytes() == DATA.tobytes() and counted == _on_device(len(DATA))
        buf = np.frombuffer(STREAMS[name], np.uint8)
        assert seen == [ContainerInflater(raw=False)._try_parse_header(buf)]
        seen.clear()
    bad_hcrc = bytearray(STREAMS["gzip (all header fields)"])
    bad_hcrc[4] ^= 1  # MTIME, covered by the header CRC
    c = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=DATA[:512].tobytes())
    fdict = c.compress(DATA.tobytes()) + c.flush()
    for wire in (bytes(bad_hcrc), fdict):
        got, counted = _routed(lambda: _card_route(wire))
        want, _ = _routed(lambda: tpuzlib.inflate(wire))
        assert isinstance(got, ValueError) and str(got) == str(want)
        assert not any(counted.values())


def test_bad_trailers_decline():
    """A trailer that fails its check: the device output is decoded again on
    the host engine (one counted mismatch), which gives tpuzlib's verdict."""
    z, gz = STREAMS["zlib"], STREAMS["gzip (port)"]
    flip = lambda w, i: w[:i] + bytes([w[i] ^ 1]) + w[i + 1 :]  # noqa: E731
    for wire, verdict in ((flip(z, len(z) - 1), "Data integrity check failed"),
                          (flip(gz, len(gz) - 5), "Data integrity check failed"),
                          (flip(gz, len(gz) - 1), "Data size check failed")):
        err, counted = _routed(lambda: _card_route(wire))
        assert isinstance(err, ValueError) and str(err) == verdict
        assert counted == {"device_fallback": 0, "device_mismatch_fallback": 1, "device": 0}
        with pytest.raises(ValueError, match=verdict):
            tpuzlib.inflate(wire)


def test_truncated_stream_declines():
    """A stream cut inside its blocks: the device route declines it (one
    counted fallback) and the host engine raises tpuzlib's ValueError; so
    does a trailer cut to two bytes, after the whole stream."""
    z = STREAMS["zlib"]
    for wire in (z[: len(z) // 2], z[:-4] + b"\x00\x00", z[:-2], STREAMS["gzip (port)"][:-3]):
        err, counted = _routed(lambda: _card_route(wire))
        assert isinstance(err, ValueError) and str(err) == "Unexpected EOF during decompression"
        assert counted == {"device_fallback": 1, "device_mismatch_fallback": 0, "device": 0}
        with pytest.raises(ValueError, match="Unexpected EOF"):
            tpuzlib.inflate(wire)


def _after_sync_flush(level: int, tail: bytes) -> bytes:
    """A zlib stream of DATA, a sync flush, then `tail` in the final block:
    at level 6 a dynamic block, then a small fixed final block that the
    header scan does not see (walk_blocks' open tail); at level 0 stored
    blocks, then an empty stored final block after the plan's last block
    (its gap walk)."""
    c = zlib.compressobj(level, zlib.DEFLATED, 15)
    data = DATA.tobytes() if level else DATA[:3000].tobytes()
    return c.compress(data) + c.flush(zlib.Z_SYNC_FLUSH) + c.compress(tail) + c.flush()


AFTER = {  # name -> (wire with bytes after its stream, the stream's bytes)
    "zlib + garbage": (STREAMS["zlib"] + b"GARBAGE TRAILING DATA", DATA.tobytes()),
    "raw + trailing bytes": (STREAMS["raw"] + b"\x01\x02trailing", DATA.tobytes()),
    "two gzip members": (gzip.compress(b"hello ") + gzip.compress(b"world"), b"hello "),
    "two large gzip members": (STREAMS["gzip (port)"] + gzip.compress(DATA[::-1].tobytes()),
                               DATA.tobytes()),
    "open tail + garbage": (_after_sync_flush(6, b"xyz") + b"junkjunk", DATA.tobytes() + b"xyz"),
    "gap walk + garbage": (_after_sync_flush(0, b"") + b"junk", DATA[:3000].tobytes()),
}


@pytest.mark.parametrize("name", sorted(AFTER))
def test_bytes_after_the_stream_are_ignored(name):
    """The trailer is read right after the final block, as tpuzlib reads it,
    and whatever follows it is ignored: by the device route, with no
    fallback to the host engine."""
    wire, want = AFTER[name]
    got, counted = _routed(lambda: _card_route(wire))
    assert counted == _on_device(len(want))
    assert got.tobytes() == want == np.asarray(tpuzlib.inflate(wire)).tobytes()


def test_dictionaries_not_supported():
    """Preset dictionaries go to the host engine, with tpuzlib's bytes and
    messages: a zlib stream with FDICT decodes with its dictionary and
    raises without it or with another; a dictionary given for a stream
    without FDICT is unused; a raw stream refuses one, as tpuzlib's
    Inflater does."""
    c = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=DATA[:512].tobytes())
    fdict = c.compress(DATA.tobytes()) + c.flush()
    cases = [(fdict, DATA[:512]), (fdict, bytearray(DATA[:512].tobytes())), (fdict, None),
             (fdict, DATA[1:513]), (STREAMS["zlib"], DATA[:512]),
             (STREAMS["gzip (python)"], DATA[:512]), (STREAMS["raw"], DATA[:512])]
    for wire, dictionary in cases:
        got, counted = _routed(lambda: tpuzlib_torch.inflate(wire, dictionary, device="cpu"))
        want, _ = _routed(lambda: tpuzlib.inflate(wire, dictionary))
        assert not any(counted.values())
        if isinstance(want, ValueError):
            assert isinstance(got, ValueError) and str(got) == str(want)
        else:
            assert got.tobytes() == np.asarray(want).tobytes()
    assert tpuzlib_torch.inflate(fdict, DATA[:512], device="cpu").tobytes() == DATA.tobytes()
    with pytest.raises(ValueError, match="Custom dictionary required for this data"):
        tpuzlib_torch.inflate(fdict, device="cpu")
    with pytest.raises(ValueError, match="Custom dictionary is not valid for this data"):
        tpuzlib_torch.inflate(fdict, DATA[1:513], device="cpu")


def test_bad_input():
    with pytest.raises(ValueError, match="too small"):
        tpuzlib_torch.inflate(b"\x78", device="cpu")
    gz = bytearray(STREAMS["gzip (python)"])
    gz[2] = 7  # compression method
    with pytest.raises(ValueError, match="unknown compression method"):
        tpuzlib_torch.inflate(bytes(gz), device="cpu")
    with pytest.raises(ValueError, match="Unexpected EOF"):
        tpuzlib_torch.inflate(STREAMS["gzip (python)"][:12], device="cpu")
