"""tpuzlib_torch's gzip members (parallel/members.py) against tpuzlib's, on
the CPU.

compress_members runs one host Deflater a member: with both packages'
core count and time.time fixed, its bytes and member index must equal
tpuzlib's.  decompress_members must give tpuzlib's output and combined
CRC-32 with and without an index, on the port's members and on python
gzip's, and tpuzlib's errors on a cut member and a wrong CRC.
"""

import gzip
import time
import zlib

import numpy as np
import pytest
import torch

from tpuzlib.codec import deflate_engine as jengine
from tpuzlib.parallel import members as jmembers
from tpuzlib_torch import testing
from tpuzlib_torch.codec import deflate_engine as engine
from tpuzlib_torch.parallel import members

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

KB = 1 << 10
MTIME = 1_700_000_123


@pytest.fixture(autouse=True)
def _fixed(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: MTIME)
    monkeypatch.setattr(engine, "_ncores", lambda: 4)
    monkeypatch.setattr(jengine, "_ncores", lambda: 4)


@pytest.mark.parametrize("level,member_size", [(1, 1 << 20), (6, 700 * KB), (9, 4 << 20)])
def test_compress_members_matches_tpuzlib(level, member_size):
    data = testing.mixed(2300 * KB, 31)
    for n in (0, 5000, len(data)):
        wire, index = members.compress_members(data[:n], level=level, member_size=member_size)
        jwire, jindex = jmembers.compress_members(data[:n], level=level, member_size=member_size)
        assert wire.tobytes() == np.asarray(jwire).tobytes()
        np.testing.assert_array_equal(index, jindex)
        assert len(index) == max(1, -(-n // member_size))
        assert gzip.decompress(wire.tobytes()) == data[:n].tobytes()


def _members_inputs():
    rng = np.random.default_rng(3)
    parts = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (1000, 50000, 7)]
    parts.append(testing.corpus("text", 300 * KB, 4).tobytes())
    stdlib = [gzip.compress(p, 6, mtime=MTIME) for p in parts]
    stdlib_index = np.cumsum([0] + [len(m) for m in stdlib[:-1]])
    own, own_index = members.compress_members(testing.mixed(1200 * KB, 32), member_size=256 * KB)
    return {"python gzip": (b"".join(stdlib), stdlib_index, b"".join(parts)),
            "port": (own.tobytes(), own_index, gzip.decompress(own.tobytes()))}


@pytest.mark.parametrize("source", ["python gzip", "port"])
def test_decompress_members_matches_tpuzlib(source):
    wire, index, whole = _members_inputs()[source]
    for idx in (None, index):
        out, crc = members.decompress_members(wire, idx, verify=True, device="cpu")
        jout, jcrc = jmembers.decompress_members(wire, idx)
        assert out.tobytes() == np.asarray(jout).tobytes() == whole
        assert crc == jcrc == zlib.crc32(whole)


def test_decompress_members_errors_match_tpuzlib():
    """A cut member, and a member whose stored CRC-32 is wrong under
    verify=True, raise tpuzlib's ValueErrors."""
    wire, index, _ = _members_inputs()["port"]
    cut = wire[:-3]
    bad_crc = bytearray(wire)
    bad_crc[-8] ^= 1  # the last member's stored CRC-32
    messages = []
    for args, kwargs in (((cut,), {}), ((cut, index), {}),
                         ((bytes(bad_crc),), {"verify": True})):
        with pytest.raises(ValueError) as got:
            members.decompress_members(*args, device="cpu", **kwargs)
        with pytest.raises(ValueError) as want:
            jmembers.decompress_members(*args, **kwargs)
        assert str(got.value) == str(want.value)
        messages.append(str(got.value))
    assert messages == ["truncated gzip member at offset %d" % index[-1],
                        "truncated gzip member at offset 0", "Data integrity check failed"]
    # without verify the stored CRCs are combined as they are
    _, crc = members.decompress_members(bytes(bad_crc), device="cpu")
    assert crc == jmembers.decompress_members(bytes(bad_crc))[1]
