"""inflate()'s fallback to the host engine, on the CPU.

On a card, inflate() runs the device route first for a stream its route
rule sends there, then the host engine where that route does not give
verified bytes; here the device route runs with the kernels' plain
versions through testing.inflate_device_route (at any size, raw streams
too), then inflate(device="cpu"), the host route, where it leaves the
stream to the host (_card_route).  Held to tpuzlib.inflate (its host route: the
speculative dispatch is switched off with TPUZLIB_SPECULATIVE=0 for the
whole file) on 20 seeded bit flips, byte changes and truncations of raw,
zlib and gzip streams: each pair gives the same bytes or the same
ValueError message, and each call counts at most one fallback.  A stored
stream of 64 MiB + 1 bytes, past the device decode's 2^29 bits, declines
before any upload and decodes on the host, counted once.  An error that
is not a verdict on the data (a RuntimeError from the device decode or
from a checksum) propagates.
"""

import gzip
import zlib

import numpy as np
import pytest
import torch

import tpuzlib
import tpuzlib_torch
from tpuzlib_torch import testing
from tpuzlib_torch.api import inflate_api
from tpuzlib_torch.kernels import inflate_cuda
from tpuzlib_torch.kernels import inflate_device2 as d2
from tpuzlib_torch.utils import trace

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

DATA = testing.inflate_streams(1 << 13, seed=4)["L6"][1]
WIRES = [testing.zlib_stream(DATA, 6, -15), zlib.compress(DATA.tobytes(), 6),
         gzip.compress(DATA.tobytes(), 6, mtime=7)]
FALLBACKS = ("inflate.device_fallback", "inflate.device_mismatch_fallback")


@pytest.fixture(autouse=True)
def _host_route(monkeypatch):
    """tpuzlib.inflate on its sequential host route."""
    monkeypatch.setenv("TPUZLIB_SPECULATIVE", "0")


def _outcome(fn):
    try:
        return "bytes", np.asarray(fn()).tobytes()
    except ValueError as e:
        return "ValueError", str(e)


def _card_route(wire):
    """inflate()'s result on a card for a stream its rule sends to the
    device route: that route's bytes, or where it leaves the stream to the
    host route, the host route's."""
    out = testing.inflate_device_route(wire)
    return out if out is not None else tpuzlib_torch.inflate(wire, device="cpu")


def _corrupt(case: int) -> bytes:
    """Case `case`'s stream: a bit flipped, a byte replaced or a cut, at a
    seeded place of a raw, zlib or gzip stream."""
    rng = np.random.default_rng(case)
    wire = bytearray(WIRES[case % 3])
    i = int(rng.integers(0, len(wire)))
    kind = case // 3 % 3
    if kind == 0:
        wire[i] ^= 1 << int(rng.integers(0, 8))
    elif kind == 1:
        wire[i] = int(rng.integers(0, 256))
    else:
        del wire[i:]
    return bytes(wire)


@pytest.mark.parametrize("case", range(20))
def test_corrupt_streams_match_tpuzlib(case):
    wire = _corrupt(case)
    before = trace.get_counters()
    got = _outcome(lambda: _card_route(wire))
    moved = testing.counters_since(before)
    counted = sum(moved.get(k, 0) for k in FALLBACKS)
    assert got == _outcome(lambda: tpuzlib.inflate(wire))
    assert counted <= 1
    if got[0] == "bytes" and counted == 0:
        assert moved.get("inflate.device", 0) == len(got[1])


def test_stream_past_the_device_limit_decodes_on_the_host(monkeypatch):
    """64 MiB + 1 random bytes stored (zlib level 0): 2^29 bits or more, so
    the device route declines it before any upload (the decode is never
    reached), and the host engine decodes it; one fallback.  The host has
    one core here, so the host route takes the Inflater, not the
    speculative decode (tests/test_torch_speculative.py)."""
    data = np.random.default_rng(64).integers(0, 256, (64 << 20) + 1, dtype=np.uint8)
    wire = zlib.compress(data.tobytes(), 0)
    assert len(wire) * 8 >= 1 << 29

    def refuse(*args, **kwargs):
        raise AssertionError("the device decode was reached")

    monkeypatch.setattr(inflate_cuda, "cursor_decode", refuse)
    monkeypatch.setattr(inflate_api, "_ncores", lambda: 1)
    before = trace.get_counters()
    got = _card_route(wire)
    assert got.tobytes() == data.tobytes()
    assert testing.counters_since(before) == {"inflate.device_fallback": 1}


def test_runtime_errors_propagate(monkeypatch):
    """Only verdicts on the data fall back: a RuntimeError from the device
    decode, or from the trailer's checksum, reaches the caller."""
    before = trace.get_counters()

    def boom(*args, **kwargs):
        raise RuntimeError("a fault of the device path")

    with monkeypatch.context() as m:
        m.setattr(inflate_api, "decode_stream", boom)
        for wire in WIRES:
            with pytest.raises(RuntimeError, match="a fault of the device path"):
                _card_route(wire)
    for name in ("adler32", "crc32"):
        with monkeypatch.context() as m:
            m.setattr(inflate_api, name, boom)
            with pytest.raises(RuntimeError, match="a fault of the device path"):
                _card_route(WIRES[1 if name == "adler32" else 2])
    assert trace.get_counters() == before


def test_counts_keys():
    """The route's counters carry tpuzlib's names, in the one store of
    utils/trace.py (the decode's own dict is gone)."""
    assert not hasattr(d2, "COUNTS")
    # a stream the device route decodes counts its bytes, and no fallback
    before = trace.get_counters()
    assert _card_route(WIRES[1]).tobytes() == DATA.tobytes()
    assert testing.counters_since(before) == {"inflate.device": len(DATA)}
    # a trailer cut short, and a flipped Adler-32: one fallback each
    for wire, name in ((WIRES[1][:-2], "inflate.device_fallback"),
                       (WIRES[1][:-1] + bytes([WIRES[1][-1] ^ 1]),
                        "inflate.device_mismatch_fallback")):
        before = trace.get_counters()
        assert _outcome(lambda: _card_route(wire))[0] == "ValueError"
        assert testing.counters_since(before) == {name: 1}
