"""tpuzlib_torch's Deflater and deflate(dictionary=) against tpuzlib's, on
the CPU.

Both Deflaters run their host engine, whose bytes depend on the core
count: both packages' _ncores are fixed to the same value, and both write
the gzip MTIME from time.time(), which the tests fix.  Every output must
equal tpuzlib's, append by append, decode with python's zlib (with the
dictionary as zdict), and keep the same totals, exceptions and messages.
deflate() on the CPU takes the host engine at every size, as tpuzlib's
deflate() does without its TPUZLIB_DEVICE switch.
"""

import time
import zlib

import numpy as np
import pytest
import torch

import tpuzlib
import tpuzlib_torch
from tpuzlib.codec import deflate_engine as jengine
from tpuzlib_torch import testing
from tpuzlib_torch.api import deflate_api
from tpuzlib_torch.codec import deflate_engine as engine
from tpuzlib_torch.containers import headers
from tpuzlib_torch.utils import trace

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

KB = 1 << 10
MTIME = 1_700_000_123
WBITS = {"raw": -15, "deflate": 15, "gzip": 31}
DATA = testing.mixed(2200 * KB, 21)


@pytest.fixture(autouse=True)
def _fixed(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: MTIME + 0.5)
    monkeypatch.setattr(engine, "_ncores", lambda: 8)
    monkeypatch.setattr(jengine, "_ncores", lambda: 8)


def _run(pkg, data, steps, **options):
    """Each append's buffers and finish's, as bytes, and the totals."""
    d = pkg.Deflater(**options)
    calls, off, k = [], 0, 0
    while True:
        piece = data[off : off + steps[k % len(steps)]]
        calls.append([b.tobytes() for b in d.append(piece)])
        off, k = off + len(piece), k + 1
        if off >= len(data):
            break
    calls.append([b.tobytes() for b in d.finish()])
    return calls, d.total_in, d.total_out


def _decode(wire: bytes, fmt: str, zdict: bytes = b"") -> bytes:
    do = zlib.decompressobj(WBITS[fmt], zdict=zdict) if zdict else zlib.decompressobj(WBITS[fmt])
    out = do.decompress(wire)
    assert do.eof and not do.unused_data
    return out


@pytest.mark.parametrize("fmt", ["raw", "deflate", "gzip"])
@pytest.mark.parametrize("level", range(1, 10))
def test_deflater_one_shot_matches_tpuzlib(level, fmt):
    """One append, at sizes from nothing to past finish's parallel split;
    deflate() gives the same bytes as tpuzlib's host engine."""
    for n in (0, 1, 1000, 300 * KB, len(DATA)):
        data = DATA[:n]
        name = "mixed.bin" if n == 1000 else None
        got = _run(tpuzlib_torch, data, [max(n, 1)], level=level, format=fmt, fileName=name)
        want = _run(tpuzlib, data, [max(n, 1)], level=level, format=fmt, fileName=name)
        assert got == want, n
        wire = b"".join(b for call in got[0] for b in call)
        assert got[1:] == (n, len(wire))
        assert _decode(wire, fmt) == data.tobytes()
    want = np.asarray(tpuzlib.deflate(DATA[: 300 * KB], level=level, format=fmt)).tobytes()
    host = _run(tpuzlib_torch, DATA[: 300 * KB], [300 * KB], level=level, format=fmt)[0]
    assert b"".join(b for call in host for b in call) == want


@pytest.mark.parametrize("fmt", ["raw", "deflate", "gzip"])
@pytest.mark.parametrize("level", [1, 6, 9])
def test_deflate_takes_tpuzlib_default_route(monkeypatch, level, fmt):
    """deflate() with device="cpu" takes the host engine at every size:
    tpuzlib's default deflate()'s bytes (its switch off), and nothing
    counted as deflate.device."""
    monkeypatch.delenv("TPUZLIB_DEVICE", raising=False)
    for n in (0, 1000, 64 * KB):
        data = DATA[:n]
        before = trace.get_counters()
        got = tpuzlib_torch.deflate(data, level=level, format=fmt, device="cpu").tobytes()
        assert "deflate.device" not in testing.counters_since(before)
        assert got == np.asarray(tpuzlib.deflate(data, level=level, format=fmt)).tobytes(), n
        assert _decode(got, fmt) == data.tobytes()


@pytest.mark.parametrize("fmt", ["raw", "deflate", "gzip"])
def test_deflate_at_the_device_floor(monkeypatch, fmt):
    """1 MiB - 1 and 1 MiB + 1 bytes at level 6, either side of the card's
    floor: with device="cpu" the host engine, tpuzlib's default bytes."""
    monkeypatch.delenv("TPUZLIB_DEVICE", raising=False)
    for n in (deflate_api.DEVICE_MIN_BYTES - 1, deflate_api.DEVICE_MIN_BYTES + 1):
        data = DATA[:n]
        before = trace.get_counters()
        got = tpuzlib_torch.deflate(data, level=6, format=fmt, device="cpu").tobytes()
        assert "deflate.device" not in testing.counters_since(before)
        assert got == np.asarray(tpuzlib.deflate(data, level=6, format=fmt)).tobytes(), n
        assert _decode(got, fmt) == data.tobytes()


def test_deflate_route_rule(monkeypatch):
    """The device route runs for a card from DEVICE_MIN_BYTES without a
    dictionary, and for nothing else; below the floor a card's call is
    the host engine's, with no card needed."""
    assert deflate_api.DEVICE_MIN_BYTES == 1 << 20
    seen = []

    def device_route(view, deflater, device):
        seen.append((len(view), deflater.format, device))
        return np.zeros(1, np.uint8)

    monkeypatch.setattr(deflate_api, "_deflate_device", device_route)
    floor = deflate_api.DEVICE_MIN_BYTES
    small = DATA[: floor - 1]
    host = tpuzlib_torch.deflate(small, device="cpu").tobytes()
    for device in ("cuda", torch.device("cuda", 1), "cpu", torch.device("cpu")):
        assert tpuzlib_torch.deflate(small, device=device).tobytes() == host
    tpuzlib_torch.deflate(DATA[:floor], device="cpu")
    tpuzlib_torch.deflate(DATA[:floor], dictionary=b"abc", device="cuda")
    assert seen == []
    for n, fmt, device in ((floor, "deflate", "cuda"), (floor + 1, "gzip", torch.device("cuda", 0))):
        tpuzlib_torch.deflate(DATA[:n], format=fmt, device=device)
    assert seen == [(floor, "deflate", "cuda"), (floor + 1, "gzip", torch.device("cuda", 0))]


@pytest.mark.parametrize("cores", [1, 8])
@pytest.mark.parametrize("fmt", ["raw", "deflate", "gzip"])
def test_deflater_ragged_appends_match_tpuzlib(monkeypatch, fmt, cores):
    """Appends of 1 B, 7 B, 4 KiB and 1 MiB in turn: every call's buffers,
    and the totals, equal tpuzlib's."""
    monkeypatch.setattr(engine, "_ncores", lambda: cores)
    monkeypatch.setattr(jengine, "_ncores", lambda: cores)
    for level in (1, 6, 9):
        got = _run(tpuzlib_torch, DATA, [1, 7, 4 * KB, 1 << 20], level=level, format=fmt)
        assert got == _run(tpuzlib, DATA, [1, 7, 4 * KB, 1 << 20], level=level, format=fmt)
        wire = b"".join(b for call in got[0] for b in call)
        assert got[1:] == (len(DATA), len(wire))
        assert _decode(wire, fmt) == DATA.tobytes()


@pytest.mark.parametrize("size", [3, 409, 40 * KB])
def test_dictionaries_match_tpuzlib(size):
    """The FDICT header with the dictionary's Adler-32, one-shot and
    ragged, through the Deflater and deflate(dictionary=)."""
    zdict = testing.corpus("text", size, 5)
    data = np.concatenate([testing.corpus("text", 500 * KB, 6), DATA[: 700 * KB]])
    for level in (1, 4, 6, 9):
        wires = []
        for steps in ([len(data)], [1, 7, 4 * KB, 1 << 20]):
            got = _run(tpuzlib_torch, data, steps, level=level, dictionary=zdict)
            assert got == _run(tpuzlib, data, steps, level=level, dictionary=zdict)
            wires.append(b"".join(b for call in got[0] for b in call))
            assert wires[-1][:6] == headers.make_zlib_header(level, zlib.adler32(zdict.tobytes()))
            assert wires[-1][1] & 0x20 and int.from_bytes(wires[-1][:2], "big") % 31 == 0
            assert _decode(wires[-1], "deflate", zdict.tobytes()) == data.tobytes()
        one = tpuzlib_torch.deflate(data, level=level, dictionary=zdict, device="cpu").tobytes()
        assert one == wires[0]
        assert one == np.asarray(tpuzlib.deflate(data, level=level, dictionary=zdict)).tobytes()
        assert bytes(tpuzlib_torch.inflate(one, zdict.tobytes(), device="cpu")) == data.tobytes()


def test_deflate_dictionary_of_bytes_and_views():
    """A dictionary as bytes, bytearray, memoryview or an array of another
    dtype gives the same stream."""
    zdict = testing.corpus("text", 4 * KB, 8)
    data = testing.corpus("text", 64 * KB, 9).tobytes()
    want = tpuzlib_torch.deflate(data, dictionary=zdict, device="cpu").tobytes()
    for d in (zdict.tobytes(), bytearray(zdict.tobytes()), memoryview(zdict.tobytes()),
              zdict.view(np.uint32)):
        assert tpuzlib_torch.deflate(data, dictionary=d, device="cpu").tobytes() == want


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type and the message are compared
        return type(e), str(e)
    return None


def test_errors_match_tpuzlib():
    """Bad options, reuse, finish before append, bad data: the same
    exception types and messages."""
    options = [dict(level=0), dict(level=10), dict(level=True), dict(level="6"),
               dict(level=6.0), dict(format="zip"), dict(fileName=5),
               dict(format="gzip", dictionary=b"abc"), dict(format="raw", dictionary=b"abc"),
               dict(dictionary=5), dict(dictionary=object())]
    for kw in options:
        got = _error(lambda: tpuzlib_torch.Deflater(**kw))
        assert got is not None and got == _error(lambda: tpuzlib.Deflater(**kw)), kw
        assert got == _error(lambda: tpuzlib_torch.deflate(b"x", device="cpu", **kw)), kw
    both = dict(options=tpuzlib_torch.DeflaterOptions(), level=6)
    assert _error(lambda: tpuzlib_torch.Deflater(**both)) == (
        TypeError, "pass either an options object or keyword options")

    def lifecycle(pkg, steps):
        d = pkg.Deflater()
        return [_error(lambda s=s: getattr(d, s)(*((b"abc",) if s == "append" else ())))
                for s in steps]

    for steps in (["finish"], ["append", "finish", "append"], ["append", "finish", "finish"]):
        assert lifecycle(tpuzlib_torch, steps) == lifecycle(tpuzlib, steps)
    assert lifecycle(tpuzlib_torch, ["append", "finish", "finish"])[-1] == (
        RuntimeError, "Deflater instances cannot be reused")
    assert lifecycle(tpuzlib_torch, ["finish"])[0] == (
        RuntimeError, "Cannot call finish before at least 1 call to append")
    bad = lambda pkg: _error(lambda: pkg.Deflater().append(12))  # noqa: E731
    assert bad(tpuzlib_torch) == bad(tpuzlib) == (TypeError,
                                                  "data must be an ArrayBuffer or buffer view")


@pytest.mark.parametrize("level", range(1, 10))
def test_size_at_most_zlib(level):
    """At or below zlib's size at every level on the mixed and text
    corpora (on the vertices corpus levels 4 and 5 run a little over,
    as tpuzlib's do)."""
    for data in (testing.mixed(2 << 20, 3), testing.corpus("text", 1 << 20, 2)):
        d = tpuzlib_torch.Deflater(level=level)
        wire = b"".join(b.tobytes() for b in d.append(data) + d.finish())
        assert zlib.decompress(wire) == data.tobytes()
        assert len(wire) <= len(zlib.compress(data.tobytes(), level))
