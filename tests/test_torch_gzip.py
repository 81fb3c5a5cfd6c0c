"""tpuzlib_torch's gzip container against tpuzlib's, on the CPU.

tpuzlib's deflate() takes its device route with TPUZLIB_DEVICE=1 for
inputs of 1 MiB and up, and the port's deflate() on a card from the
same floor: the port's device route (testing.device_route, which runs
deflate()'s _deflate_device at any size and on any device) is held to
tpuzlib's; with device="cpu" the port's deflate() takes the host engine,
as tpuzlib's does without the switch.  Both packages write MTIME from
time.time(), which the tests fix.  Every output must also decode with
python's gzip.
"""

import gzip
import time
import zlib

import numpy as np
import pytest
import torch

import tpuzlib
import tpuzlib_torch
from tpuzlib.containers import headers as jheaders
from tpuzlib_torch import testing
from tpuzlib_torch.containers import headers
from tpuzlib_torch.utils import trace

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

MTIME = 1_700_000_123


@pytest.mark.parametrize("level", [1, 6])
def test_gzip_matches_tpuzlib_device_route(monkeypatch, level):
    monkeypatch.setenv("TPUZLIB_DEVICE", "1")
    monkeypatch.setattr(time, "time", lambda: MTIME + 0.75)
    data = testing.mixed(1 << 20, 11)
    want = np.asarray(tpuzlib.deflate(data, level=level, format="gzip", fileName="mixed.bin"))
    before = trace.get_counters()
    got = testing.device_route(data, level=level, format="gzip", fileName="mixed.bin")
    assert testing.counters_since(before) == {"deflate.device": len(data)}
    assert got.tobytes() == want.tobytes()
    assert gzip.decompress(got.tobytes()) == data.tobytes()


def test_gzip_headers_match():
    for level in range(1, 10):
        for name in (None, "", "a.txt", "héllo.bin"):
            for mtime in (0, MTIME, 1 << 33):
                assert (headers.make_gzip_header(name, mtime, level)
                        == jheaders.make_gzip_header(name, mtime, level))
    for crc, total in ((0, 0), (0xDEADBEEF, 1 << 33), (1 << 32, 12345)):
        assert headers.make_gzip_trailer(crc, total) == jheaders.make_gzip_trailer(crc, total)


SMALL = ((b"tpuzlib_torch gzip " * 500 + bytes(range(256)), "small.txt"), (b"", None))


def _check_small(out: bytes, data: bytes, name) -> None:
    """The header fields and the trailer of a gzip member of `data`."""
    assert gzip.decompress(out) == data
    assert zlib.decompress(out, 31) == data
    assert out[:10] == headers.make_gzip_header(name, MTIME, 9)[:10]
    assert (out[3] & 0x08 != 0) == bool(name)
    assert out[-8:] == headers.make_gzip_trailer(zlib.crc32(data), len(data))


def test_gzip_small_inputs(monkeypatch):
    """One chunk, none, and a name, through deflate() on the CPU (the host
    engine): the header fields and the trailer."""
    monkeypatch.setattr(time, "time", lambda: MTIME)
    for data, name in SMALL:
        before = trace.get_counters()
        out = tpuzlib_torch.deflate(data, format="gzip", fileName=name, level=9,
                                    device="cpu").tobytes()
        assert "deflate.device" not in testing.counters_since(before)
        _check_small(out, data, name)


def test_gzip_small_inputs_device_route(monkeypatch):
    """The same inputs through the device route, which a card takes only
    from 1 MiB: a batch of one chunk, and none."""
    monkeypatch.setattr(time, "time", lambda: MTIME)
    for data, name in SMALL:
        before = trace.get_counters()
        out = testing.device_route(data, format="gzip", fileName=name, level=9).tobytes()
        assert testing.counters_since(before) == ({"deflate.device": len(data)} if data else {})
        _check_small(out, data, name)
