"""The host deflate engine's streams decoded on the card, and the gzip
members' verify on the card.

Every test here is marked `cuda` and skips without a CUDA card.  The CPU
tests (test_torch_deflate_engine.py, test_torch_deflater.py,
test_torch_members.py) hold the Deflater, deflate(dictionary=) and the
members to tpuzlib's bytes; these take their output through inflate() on
the card and assert its route: every byte from the device decode, no
fallback counted.  A preset dictionary's zlib stream goes to the host
engine (inflate()'s rule for FDICT), and its raw body through the device
decode with the dictionary.  decompress_members(verify=True) on the card
takes one crc32_scalar launch.  deflate()'s route rule on the card: below
1 MiB the host engine (no encoder launch, the CPU's bytes), from 1 MiB
the device encoder (the CPU's device route's bytes).  On a machine with a
card (and no JAX, which tests/conftest.py imports), from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_deflate.py
"""

import zlib

import numpy as np
import pytest
import torch

import tpuzlib_torch
from tpuzlib_torch import testing
from tpuzlib_torch.kernels import _build
from tpuzlib_torch.kernels import inflate_device2 as d2
from tpuzlib_torch.parallel import members
from tpuzlib_torch.utils import trace

pytestmark = pytest.mark.cuda

KB = 1 << 10
FALLBACKS = ("inflate.device_fallback", "inflate.device_mismatch_fallback")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _deflater(data, steps, **options) -> bytes:
    d = tpuzlib_torch.Deflater(**options)
    parts, off, k = [], 0, 0
    while off < len(data):
        parts += d.append(data[off : off + steps[k % len(steps)]])
        off, k = off + steps[k % len(steps)], k + 1
    return b"".join(b.tobytes() for b in parts + d.finish())


def _on_card(wire, want, dev, dictionary=None, device_bytes=None, route=None):
    """inflate() on the card (or `route`, such as the device route alone)
    gives `want`, with no fallback counted, the device route's bytes
    counted as `device_bytes` (all of `want` unless given), and decode
    launches where the device route ran."""
    before = trace.get_counters()
    launches = _build.LAUNCHES["inflate_decode"]
    if route is None:
        out = tpuzlib_torch.inflate(wire, dictionary, device=dev)
    else:
        out = route(wire, device=dev)
    torch.cuda.synchronize()
    assert out.tobytes() == want
    moved = testing.counters_since(before)
    assert {k: moved.get(k, 0) for k in FALLBACKS} == {k: 0 for k in FALLBACKS}
    device = moved.get("inflate.device", 0)
    assert device == (len(want) if device_bytes is None else device_bytes)
    assert (_build.LAUNCHES["inflate_decode"] > launches) == (device > 0)


@pytest.mark.parametrize("fmt", ["raw", "deflate", "gzip"])
@pytest.mark.parametrize("level", [1, 6, 9])
def test_deflater_streams_take_the_device_route(dev, level, fmt):
    """The Deflater's zlib and gzip streams through inflate()'s device
    route; a raw stream, which inflate() keeps on the host engine, through
    the device route alone (testing.inflate_device_route) and through
    inflate()."""
    data = testing.mixed(3 << 20, 40 + level)
    for steps in ([len(data)], [1, 7, 4 * KB, 1 << 20]):
        wire = _deflater(data, steps, level=level, format=fmt)
        if fmt == "raw":
            _on_card(wire, data.tobytes(), dev, route=testing.inflate_device_route)
            _on_card(wire, data.tobytes(), dev, device_bytes=0)
        else:
            _on_card(wire, data.tobytes(), dev)


@pytest.mark.parametrize("size", [3, 409, 40 * KB])
def test_dictionary_streams_on_card(dev, size):
    """deflate(dictionary=)'s FDICT stream through inflate(dictionary=)
    (the host engine, nothing counted), and its raw body through the
    device decode with the dictionary."""
    zdict = testing.corpus("text", size, 5).tobytes()
    data = np.concatenate([testing.corpus("text", 1 << 20, 6), testing.mixed(1 << 20, 7)])
    for level in (1, 6, 9):
        wire = tpuzlib_torch.deflate(data, level=level, dictionary=zdict, device=dev).tobytes()
        assert zlib.decompressobj(zdict=zdict).decompress(wire) == data.tobytes()
        _on_card(wire, data.tobytes(), dev, zdict, device_bytes=0)
        ragged = _deflater(data, [1, 7, 4 * KB, 1 << 20], level=level, dictionary=zdict)
        _on_card(ragged, data.tobytes(), dev, zdict, device_bytes=0)
        raw = np.frombuffer(wire, np.uint8)[6:-4]
        launches = _build.LAUNCHES["inflate_decode"]
        out = d2.decode(raw, np.frombuffer(zdict, np.uint8), device=dev)
        assert out.tobytes() == data.tobytes()
        assert _build.LAUNCHES["inflate_decode"] > launches


def test_decompress_members_verify_on_card(dev):
    data = testing.mixed(5 << 20, 44)
    wire, index = members.compress_members(data, member_size=1 << 20)
    for idx in (None, index):
        before = _build.LAUNCHES["crc32_scalar"]
        out, crc = members.decompress_members(wire, idx, verify=True, device=dev)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["crc32_scalar"] == before + 1
        assert out.tobytes() == data.tobytes() and crc == zlib.crc32(data.tobytes())
    bad = bytearray(wire.tobytes())
    bad[-8] ^= 1
    with pytest.raises(ValueError, match="Data integrity check failed"):
        members.decompress_members(bytes(bad), verify=True, device=dev)


@pytest.mark.parametrize("fmt", ["raw", "deflate", "gzip"])
def test_deflate_route_rule_on_card(dev, monkeypatch, fmt):
    """1 MiB - 1 bytes take the host engine on the card, no kernel
    launched; 1 MiB takes the device encoder and the trailer's checksum
    on the card, with the bytes of the device route run on the CPU."""
    monkeypatch.setattr("time.time", lambda: 1_700_000_000.5)
    data = testing.mixed((1 << 20) + 1, 12)
    for n, on_card in (((1 << 20) - 1, False), (1 << 20, True)):
        part = data[:n]
        before, launches = trace.get_counters(), dict(_build.LAUNCHES)
        wire = tpuzlib_torch.deflate(part, format=fmt, device=dev).tobytes()
        torch.cuda.synchronize()
        moved = {k: v - launches[k] for k, v in _build.LAUNCHES.items() if v != launches[k]}
        assert testing.counters_since(before).get("deflate.device", 0) == (n if on_card else 0)
        if on_card:
            assert moved["near_screen"] > 0 and moved["pack_words"] > 0
            assert wire == testing.device_route(part, format=fmt).tobytes()
        else:
            assert moved == {}
            assert wire == tpuzlib_torch.deflate(part, format=fmt, device="cpu").tobytes()
        assert zlib.decompress(wire, {"raw": -15, "deflate": 15, "gzip": 31}[fmt]) == part.tobytes()
