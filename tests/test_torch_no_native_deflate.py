"""The port's host codec with its native library switched off, on the
CPU: the switch itself, the numpy checksums, and the numpy deflate route
(deflate(device="cpu") and the streamed Deflater), each against tpuzlib
with its library off (as tpuzlib's own tests turn it off), exactly.

The deflate engine's bytes depend on the core count and its chunking:
both packages' _ncores are fixed to the same value, and the gzip MTIME
comes from time.time(), which the tests fix.  Sizes reach both of the
numpy route's paths: _compress (small inputs, and 512 KiB chunks on one
core) and _compress_parallel (a finish() of more than 256 KiB on two
cores).
"""

import time
import zlib

import numpy as np
import pytest
import torch

import tpuzlib
import tpuzlib_torch
from tpuzlib.codec import deflate_engine as jengine
from tpuzlib.kernels import adler32 as jadler
from tpuzlib.kernels import crc32 as jcrc
from tpuzlib.native import bindings as jbindings
from tpuzlib_torch import native, testing
from tpuzlib_torch.codec import deflate_engine as engine
from tpuzlib_torch.kernels import adler32, crc32
from tpuzlib_torch.native import bindings

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

KB = 1 << 10
MTIME = 1_700_000_321
WBITS = {"raw": -15, "deflate": 15, "gzip": 31}
DATA = testing.mixed(600 * KB, 31)
ZDICT = testing.corpus("text", 4 * KB, 32)


@pytest.fixture
def off(monkeypatch):
    """Both packages without their native library, with the same cores and
    gzip MTIME."""
    monkeypatch.setattr(jbindings, "_lib", None)
    monkeypatch.setattr(jbindings, "_tried", True)
    monkeypatch.setattr(time, "time", lambda: MTIME + 0.5)
    with testing.no_native():
        yield


def _cores(monkeypatch, n):
    monkeypatch.setattr(engine, "_ncores", lambda: n)
    monkeypatch.setattr(jengine, "_ncores", lambda: n)


def test_switch():
    """set_native returns the state before; no_native switches off inside
    its block and restores the state on the way out, also after an error;
    the switch is out of the package's exports, which are tpuzlib's."""
    assert native.__all__ == ["get_lib", "native_available"] and "set_native" not in native.__all__
    assert native.get_lib is bindings.get_lib and native.native_available is bindings.native_available
    lib = bindings.lib()
    assert bindings.native_available() and bindings.get_lib() is lib
    with testing.no_native():
        assert bindings.get_lib() is None and not bindings.native_available()
        with pytest.raises(RuntimeError, match="switched off"):
            bindings.lib()
        with testing.no_native():
            pass
        assert bindings.get_lib() is None  # an inner block restores "off"
    assert bindings.lib() is lib
    with pytest.raises(KeyError):
        with testing.no_native():
            raise KeyError("inside")
    assert bindings.native_available()
    assert bindings.set_native(False) is True and bindings.set_native(True) is False


@pytest.mark.parametrize("n", [0, 1, 63, 4096, 100001])
def test_checksums_match_tpuzlib(n, off):
    """adler32_host and crc32_host's numpy bodies: tpuzlib's numbers and
    zlib's, with and without a seed (after tpuzlib's
    test_checksum_numpy_native_parity)."""
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    for seed_a, seed_c in ((1, 0), (zlib.adler32(b"seed material"), zlib.crc32(b"seed material"))):
        a = adler32.adler32_host(data, seed_a)
        c = crc32.crc32_host(data, seed_c)
        assert a == jadler.adler32_host(data, seed_a) == zlib.adler32(data.tobytes(), seed_a)
        assert c == jcrc.crc32_host(data, seed_c) == zlib.crc32(data.tobytes(), seed_c)
    assert crc32.HOST_BLOCK == jcrc.HOST_BLOCK


def test_checksums_leave_the_library_alone(monkeypatch):
    """Switched off, the checksums never reach the library: its entry
    points raise if they are called."""

    def refuse(*args):
        raise AssertionError("the native library was called")

    data = testing.corpus("runs", 3000, 1)
    lib = bindings.lib()
    with monkeypatch.context() as m:
        m.setattr(lib, "tz_adler32", refuse)
        m.setattr(lib, "tz_crc32", refuse)
        with testing.no_native():
            assert adler32.adler32_host(data) == zlib.adler32(data.tobytes())
            assert crc32.crc32_host(data) == zlib.crc32(data.tobytes())


CASES = [  # (format, level, dictionary, bytes, cores): _compress, then _compress_parallel
    ("raw", 1, None, 40 * KB, 2), ("deflate", 6, None, 40 * KB, 2),
    ("gzip", 6, None, 40 * KB, 2), ("deflate", 1, ZDICT, 40 * KB, 2),
    ("raw", 6, None, 300 * KB, 2), ("deflate", 1, None, 300 * KB, 2),
    ("gzip", 1, None, 300 * KB, 2), ("deflate", 6, ZDICT, 300 * KB, 2),
]


@pytest.mark.parametrize("fmt, level, zdict, size, cores", CASES)
def test_deflate_matches_tpuzlib(fmt, level, zdict, size, cores, off, monkeypatch):
    """deflate(device="cpu") gives tpuzlib's deflate() bytes, by the path
    the size picks; zlib decodes them."""
    _cores(monkeypatch, cores)
    ran = []
    for name in ("_compress", "_compress_parallel_numpy"):
        real = getattr(engine.DeflateEngine, name)
        monkeypatch.setattr(engine.DeflateEngine, name,
                            lambda *a, _real=real, _name=name, **k: ran.append(_name) or _real(*a, **k))
    data = DATA[:size]
    got = tpuzlib_torch.deflate(data, level=level, format=fmt, dictionary=zdict,
                                device="cpu").tobytes()
    assert ran == (["_compress"] if size < 256 * KB else ["_compress_parallel_numpy"])
    want = np.asarray(tpuzlib.deflate(data, level=level, format=fmt,
                                      dictionary=zdict)).tobytes()
    assert got == want
    d = zlib.decompressobj(WBITS[fmt], **({"zdict": zdict.tobytes()} if zdict is not None else {}))
    assert d.decompress(got) == data.tobytes() and d.eof


def test_numpy_route_differs_from_the_native_route(monkeypatch):
    """The switch changes the route, so the bytes: the native route's
    stream is tpuzlib's native one, the numpy route's its numpy one."""
    _cores(monkeypatch, 2)
    monkeypatch.setattr(time, "time", lambda: MTIME + 0.5)
    data = ZDICT  # text: the two matchers part at the first match
    on = tpuzlib_torch.deflate(data, level=6, device="cpu").tobytes()
    assert on == np.asarray(tpuzlib.deflate(data, level=6)).tobytes()
    with testing.no_native():
        assert tpuzlib_torch.deflate(data, level=6, device="cpu").tobytes() != on


def _run(pkg, data, steps, **options):
    """Each append's buffers and finish's, as bytes, and the totals."""
    d = pkg.Deflater(**options)
    calls, off, k = [], 0, 0
    while off < len(data):
        piece = data[off : off + steps[k % len(steps)]]
        calls.append([b.tobytes() for b in d.append(piece)])
        off, k = off + len(piece), k + 1
    calls.append([b.tobytes() for b in d.finish()])
    return calls, d.total_in, d.total_out


@pytest.mark.parametrize("fmt, level, zdict, cores", [
    ("gzip", 1, None, 1), ("gzip", 6, None, 2), ("raw", 1, None, 2), ("raw", 6, None, 2),
    ("deflate", 1, None, 2), ("deflate", 6, None, 2), ("deflate", 1, ZDICT, 2),
    ("deflate", 6, ZDICT, 2)])
def test_deflater_random_cuts_match_tpuzlib(fmt, level, zdict, cores, off, monkeypatch):
    """The streamed Deflater, appended at seeded random cuts: every
    append's and finish's buffers are tpuzlib's.  On one core, 600 KiB
    compresses a 512 KiB chunk in an append and the rest in finish()
    (_compress); on two, finish() takes _compress_parallel."""
    _cores(monkeypatch, cores)
    data = DATA if cores == 1 else DATA[: 300 * KB]
    steps = np.random.default_rng(level).integers(1, 96 * KB, 40).tolist()
    got = _run(tpuzlib_torch, data, steps, level=level, format=fmt, dictionary=zdict)
    assert got == _run(tpuzlib, data, steps, level=level, format=fmt, dictionary=zdict)
    assert sum(len(c) > 0 for c in got[0][:-1]) >= (1 if cores == 1 else 0)
    wire = b"".join(b for call in got[0] for b in call)
    d = zlib.decompressobj(WBITS[fmt], **({"zdict": zdict.tobytes()} if zdict is not None else {}))
    assert d.decompress(wire) == data.tobytes() and d.eof
