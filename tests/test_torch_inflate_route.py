"""inflate()'s route rule on the CPU: tpuzlib's, with `device` in place of
its TPUZLIB_DEVICE switch.  On a CUDA device a gzip stream, or a zlib
stream without FDICT, of at least 256 KiB and given no dictionary takes
the device route first; every other stream, and every stream on
device="cpu", takes the host route, with tpuzlib's default bytes and no
move of the device route's counters.  The rule is held as a predicate
given torch.device("cuda") as a plain value, and in inflate() itself,
with the device route replaced by a spy (this host has no card).
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
from tpuzlib_torch.utils import trace

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

KB = 1 << 10
FLOOR = inflate_api.DEVICE_MIN_BYTES
# random bytes: each stream is about as long as its input, so its length
# is set to either side of the floor by the input's
BIG = testing.corpus("random", FLOOR + 64, 51)
SMALL = testing.corpus("text", 64 * KB, 52)
ZDICT = SMALL[:512]


def _fdict(data):
    c = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=ZDICT.tobytes())
    return c.compress(data.tobytes()) + c.flush()


def _streams(data):
    return {"zlib": zlib.compress(data.tobytes(), 6),
            "gzip": gzip.compress(data.tobytes(), 6, mtime=0),
            "raw": testing.zlib_stream(data, 6, -15),
            "fdict": _fdict(data)}


DATA = {"big": BIG, "small": SMALL}
STREAMS = {(size, kind): wire for size, data in DATA.items()
           for kind, wire in _streams(data).items()}


@pytest.mark.parametrize("size, kind", sorted(STREAMS))
def test_cpu_takes_the_host_route(size, kind, monkeypatch):
    """inflate(x, device="cpu") decodes every container on the host route:
    the device route is never called, its counters never move, and the
    bytes are tpuzlib's default inflate()'s."""

    def refuse(*args, **kwargs):
        raise AssertionError("the device route ran")

    monkeypatch.setattr(inflate_api, "_inflate_device", refuse)
    wire = STREAMS[size, kind]
    dictionary = ZDICT if kind == "fdict" else None
    before = trace.get_counters()
    got = tpuzlib_torch.inflate(wire, dictionary, device="cpu")
    assert not any(k.startswith("inflate.device") for k in testing.counters_since(before))
    assert got.tobytes() == DATA[size].tobytes() == np.asarray(
        tpuzlib.inflate(wire, dictionary)).tobytes()


def test_the_rule_as_a_predicate():
    """device_route_applies with torch.device("cuda") as a plain value:
    gzip and non-FDICT zlib streams of at least 256 KiB with no
    dictionary, and nothing else."""
    assert FLOOR == 1 << 18
    cuda = torch.device("cuda")
    for (size, kind), wire in STREAMS.items():
        buf = np.frombuffer(wire, np.uint8)
        assert (len(buf) >= FLOOR) == (size == "big")
        want = size == "big" and kind in ("zlib", "gzip")
        assert inflate_api.device_route_applies(buf, None, cuda) == want, (size, kind)
        assert inflate_api.device_route_applies(buf, None, "cuda:0") == want
        assert not inflate_api.device_route_applies(buf, ZDICT, cuda)
        for cpu in ("cpu", torch.device("cpu")):
            assert not inflate_api.device_route_applies(buf, None, cpu)
    z = np.frombuffer(STREAMS["big", "zlib"], np.uint8)
    for n, want in ((FLOOR - 1, False), (FLOOR, True)):
        assert inflate_api.device_route_applies(z[:n], None, cuda) == want
    # an empty dictionary is a dictionary, as tpuzlib's `dictionary=` is
    assert not inflate_api.device_route_applies(z, b"", cuda)


@pytest.mark.parametrize("size, kind", sorted(STREAMS))
@pytest.mark.parametrize("with_dictionary", [False, True])
def test_inflate_routes_by_the_rule(size, kind, with_dictionary, monkeypatch):
    """inflate(x, device="cuda") calls the device route exactly where the
    rule says; a route that declines (the spy returns None) leaves the
    stream to the host route, which gives tpuzlib's bytes or verdict."""
    calls = []

    def spy(input_, device):
        calls.append(device)

    monkeypatch.setattr(inflate_api, "_inflate_device", spy)
    wire = STREAMS[size, kind]
    dictionary = ZDICT if with_dictionary else None
    try:
        got = tpuzlib_torch.inflate(wire, dictionary, device="cuda").tobytes()
    except ValueError as e:
        got = str(e)
    try:
        want = np.asarray(tpuzlib.inflate(wire, dictionary)).tobytes()
    except ValueError as e:
        want = str(e)
    assert got == want
    routed = not with_dictionary and size == "big" and kind in ("zlib", "gzip")
    assert calls == (["cuda"] if routed else [])


@pytest.mark.parametrize("kind", ["zlib", "gzip", "raw"])
def test_the_helper_takes_the_device_route_at_any_size(kind):
    """testing.inflate_device_route runs the device route (plain versions
    on the CPU) on a small stream and a raw one, which inflate() keeps
    on the host, and counts its bytes as inflate() would on a card."""
    wire = STREAMS["small", kind]
    before = trace.get_counters()
    out = testing.inflate_device_route(wire)
    assert out.tobytes() == SMALL.tobytes()
    assert testing.counters_since(before) == {"inflate.device": len(SMALL)}
