"""inflate()'s route rule on the card, and the host codec with its native
library switched off around the card's kernels.

Every test here is marked `cuda` and skips without a CUDA card.  The CPU
tests (test_torch_inflate_route.py) hold the rule as a predicate and
with a spy; these run it: on the card a gzip stream and a zlib stream
without FDICT of at least 256 KiB decode by the device route (its bytes
counted as inflate.device, inflate_decode launched); a raw stream, a
zlib stream under the floor, an FDICT stream, a stream given a
dictionary and device="cpu" take the host route (nothing counted, no
decode launch).  Then, with the native library switched off, deflate()
from 1 MiB runs the device encoder and its checksum kernel, and
inflate() of a zlib stream the two decode kernels, with the numpy scan,
repair bridge and expansion around them.  On a machine with a card (and no JAX, which
tests/conftest.py imports), from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_inflate_route.py
"""

import gzip
import zlib

import pytest
import torch

import tpuzlib_torch
from tpuzlib_torch import testing
from tpuzlib_torch.api import inflate_api
from tpuzlib_torch.kernels import _build
from tpuzlib_torch.utils import trace

pytestmark = pytest.mark.cuda

FLOOR = inflate_api.DEVICE_MIN_BYTES
DATA = testing.mixed(3 << 19, 61)
ZDICT = DATA[:4096].tobytes()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _routed(wire, dev, dictionary=None):
    """inflate() on the card: its bytes, the counters it moved and the
    decode's launches."""
    before = trace.get_counters()
    launches = _build.LAUNCHES["inflate_decode"]
    out = tpuzlib_torch.inflate(wire, dictionary, device=dev)
    torch.cuda.synchronize()
    return (out.tobytes(), testing.counters_since(before),
            _build.LAUNCHES["inflate_decode"] - launches)


def _fdict(data):
    c = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=ZDICT)
    return c.compress(data.tobytes()) + c.flush()


def test_device_route_from_the_floor(dev):
    z = zlib.compress(DATA.tobytes(), 6)
    gz = gzip.compress(DATA.tobytes(), 6, mtime=0)
    assert len(z) >= FLOOR and len(gz) >= FLOOR
    for wire in (z, gz):
        out, moved, decodes = _routed(wire, dev)
        assert out == DATA.tobytes()
        assert moved == {"inflate.device": len(DATA)} and decodes >= 1


def test_host_route_for_the_rest(dev):
    """Raw, under the floor, FDICT, a dictionary given, device="cpu":
    the host route, with nothing counted and no decode launched."""
    z = zlib.compress(DATA.tobytes(), 6)
    # the largest prefix of DATA whose zlib stream stays under the floor
    n = len(DATA)
    while len(zlib.compress(DATA[:n].tobytes(), 6)) >= FLOOR:
        n = n * 7 // 8
    small = DATA[:n]
    cases = [(testing.zlib_stream(DATA, 6, -15), None, DATA),
             (zlib.compress(small.tobytes(), 6), None, small),
             (_fdict(DATA), ZDICT, DATA),
             (z, ZDICT, DATA)]
    for wire, dictionary, want in cases:
        out, moved, decodes = _routed(wire, dev, dictionary)
        assert out == want.tobytes()
        assert not any(k.startswith("inflate.device") for k in moved) and decodes == 0
    before = trace.get_counters()
    launches = _build.LAUNCHES["inflate_decode"]
    assert tpuzlib_torch.inflate(z, device="cpu").tobytes() == DATA.tobytes()
    assert testing.counters_since(before) == {}
    assert _build.LAUNCHES["inflate_decode"] == launches


def test_no_native_main_path_on_card(dev):
    """With the native library switched off: deflate() of 1 MiB on the
    card launches the encoder and the Adler-32 kernel; inflate() of a
    zlib stream launches both decode kernels and gives every byte from
    the device route; zlib agrees with each."""
    data = DATA[: 1 << 20]
    with testing.no_native():
        _build.reset_launches()
        wire = tpuzlib_torch.deflate(data, device=dev).tobytes()
        assert zlib.decompress(wire) == data.tobytes()
        assert _build.LAUNCHES["near_screen"] >= 1 and _build.LAUNCHES["adler32_scalar"] == 1
        z = zlib.compress(DATA.tobytes(), 6)
        _build.reset_launches()
        out, moved, _ = _routed(z, dev)
        assert out == DATA.tobytes()
        assert _build.LAUNCHES["inflate_decode"] >= 1 and _build.LAUNCHES["inflate_lut"] >= 1
        assert moved.get("inflate.device", 0) == len(DATA) and not any(
            k.endswith("fallback") for k in moved)
