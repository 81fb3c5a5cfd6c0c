"""The Adler-32 scalar kernel (csrc/adler32.cu) and inflate()'s fallback,
on the card.

Every test here is marked `cuda` and skips without a CUDA card.  The CPU
tests (test_torch_adler_scalar.py) hold the plain version to tpuzlib's
adler32_device_jit and to zlib; these hold adler32_device_scalar to it
and to zlib at lengths around a 2 KiB block and a CUDA block's 16 KiB,
with grids of one, two and many CUDA blocks (and past the grid's cap of
8 an SM, where each warp loops over several blocks), at start offsets
0-15, with seeds, on constant bytes, on inputs that end at their
buffer's last byte, on two streams at once; one launch a call, counted
as adler32_scalar and adler32.  Then inflate() on the card once more:
its counted fallbacks and verdicts, a preset dictionary, and the
Inflater.  Every comparison is exact.  On a machine with a card (and no
JAX, which tests/conftest.py imports), from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_adler.py
"""

import zlib

import numpy as np
import pytest
import torch

import tpuzlib_torch
from tpuzlib_torch import testing
from tpuzlib_torch.kernels import _build, adler32, adler32_cuda
from tpuzlib_torch.utils import trace

pytestmark = pytest.mark.cuda

KB = 1 << 10
BLOCK = adler32_cuda.BLOCK
CTA = BLOCK * adler32_cuda.WARPS  # bytes a CUDA block of the scalar takes at a time
LENGTHS = [1, 31, 32, 33, BLOCK - 1, BLOCK, BLOCK + 1, CTA - 1, CTA, CTA + 1, 2 * CTA - 5,
           2 * CTA, 2 * CTA + 1, 37 * CTA + 1234, 256 * KB + 3, 8 << 20]
SEEDS = [1, 0, 0xDEADBEEF]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _at(data, offset, dev, after=b""):
    """`data` on the card, `offset` bytes into its buffer, `after` behind it."""
    buf = torch.empty(offset + len(data) + len(after), dtype=torch.uint8, device=dev)
    host = np.frombuffer(bytes(offset) + data.tobytes() + after, np.uint8)
    buf.copy_(torch.from_numpy(host.copy()))
    return buf[offset: offset + len(data)]


def _scalar_equal(x, data, seed=1):
    before = {k: _build.LAUNCHES[k] for k in ("adler32_scalar", "adler32")}
    got = adler32_cuda.adler32_device_scalar(x, seed)
    torch.cuda.synchronize()
    # one launch of the scalar's own kernel; row 7's block kernel is not
    # launched
    assert {k: _build.LAUNCHES[k] - before[k] for k in before} == {"adler32_scalar": 1,
                                                                   "adler32": 0}
    assert got.dtype == torch.int64 and got.shape == () and got.device == x.device
    want = zlib.adler32(data.tobytes(), seed)
    assert int(got) == want == int(adler32_cuda.adler32_device_scalar_plain(x, seed))


@pytest.mark.parametrize("n", LENGTHS)
def test_adler32_scalar_lengths(dev, n):
    data = testing.mixed(n + 1, n)[:n]
    for seed in SEEDS:
        _scalar_equal(_at(data, 0, dev), data, seed)


@pytest.mark.parametrize("offset", range(16))
def test_adler32_scalar_offsets(dev, offset):
    for n in (BLOCK + 77, 3 * CTA + 77):
        data = testing.mixed(n + 1, n + offset)[:n]
        _scalar_equal(_at(data, offset, dev), data, SEEDS[offset % 3])


def test_adler32_scalar_past_the_grid_cap(dev):
    """More blocks than 8 CUDA blocks an SM take at once: each warp loops."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 3 * adler32_cuda.CTAS_PER_SM * sms * CTA + 4321
    data = testing.mixed(n + 1, 9)[:n]
    _scalar_equal(_at(data, 3, dev), data, 0xDEADBEEF)


@pytest.mark.parametrize("fill", [0x00, 0xFF])
@pytest.mark.parametrize("n", [BLOCK, CTA + 3, 64 << 20])
def test_adler32_scalar_constant_bytes(dev, n, fill):
    data = np.full(n, fill, np.uint8)
    _scalar_equal(_at(data, 3, dev), data, 1)


@pytest.mark.parametrize("offset", [0, 1, 15])
@pytest.mark.parametrize("n", [33, BLOCK, 2 * CTA + 7])
def test_adler32_scalar_reads_nothing_past_the_end(dev, n, offset):
    data = testing.mixed(n + 1, 3 * n)[:n]
    for x in (_at(data, offset, dev), _at(data, offset, dev, b"\xff" * 40)):
        _scalar_equal(x, data, 1)


def test_adler32_scalar_of_nothing_is_the_seed(dev):
    x = torch.empty(0, dtype=torch.uint8, device=dev)
    before = _build.LAUNCHES["adler32_scalar"]
    got = adler32_cuda.adler32_device_scalar(x, 0xDEADBEEF)
    assert got.device == x.device and int(got) == 0xDEADBEEF
    assert _build.LAUNCHES["adler32_scalar"] == before


def test_adler32_scalar_on_two_streams(dev):
    """Calls on two streams at once, each with its own ticket, and the
    tickets back at 0 after."""
    datas = [testing.mixed(5 * CTA + 99, s)[: 5 * CTA + 99 - s] for s in (1, 2)]
    xs = [_at(d, 0, dev) for d in datas]
    streams = [torch.cuda.Stream(dev) for _ in xs]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, (x, st) in enumerate(zip(xs, streams)):
            with torch.cuda.stream(st):
                outs[i].append(adler32_cuda.adler32_device_scalar(x, i + 1))
    torch.cuda.synchronize()
    for i, d in enumerate(datas):
        assert {int(o) for o in outs[i]} == {zlib.adler32(d.tobytes(), i + 1)}
    for st in streams:
        with torch.cuda.stream(st):
            assert int(_build.ticket(dev)) == 0


def test_public_adler32_on_card_takes_no_plain_path(dev, monkeypatch):
    """No fallback: a CUDA tensor never reaches the plain versions, and the
    public adler32 and deflate()'s zlib trailer take one scalar launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(adler32_cuda, "adler32_blocks_plain", refuse)
    monkeypatch.setattr(adler32_cuda, "adler32_device_scalar_plain", refuse)
    for n in (1, 200 * KB, 3 * CTA + 12345):
        data = testing.mixed(n + 1, n)[:n]
        x = _at(data, 1, dev)
        before = _build.LAUNCHES["adler32_scalar"]
        assert tpuzlib_torch.adler32(x, 7) == zlib.adler32(data.tobytes(), 7)
        assert adler32.adler32_device(x) == zlib.adler32(data.tobytes())
        assert _build.LAUNCHES["adler32_scalar"] == before + 2
    data = testing.mixed(1 << 20, 3)
    before = _build.LAUNCHES["adler32_scalar"]
    wire = tpuzlib_torch.deflate(data, device=dev)
    assert _build.LAUNCHES["adler32_scalar"] == before + 1
    assert zlib.decompress(wire.tobytes()) == data.tobytes()


def test_inflate_fallback_and_inflater_on_card(dev):
    """inflate() on the card: a stream it decodes counts its bytes; a
    truncated stream, a bad Adler-32 and a bad ISIZE each count one
    fallback and give the host engine's verdict; a zlib stream with a
    preset dictionary decodes through inflate(dictionary=) and the
    Inflater."""
    # 1.5 MiB: the stream cut in half is still past inflate()'s 256 KiB
    # floor, so it takes the device route
    data = testing.mixed(3 << 19, 8)
    z = zlib.compress(data.tobytes(), 6)
    gz = testing.device_route(data, device=dev, format="gzip").tobytes()
    flip = lambda w, i: w[:i] + bytes([w[i] ^ 1]) + w[i + 1:]  # noqa: E731
    before = trace.get_counters()
    assert tpuzlib_torch.inflate(z, device=dev).tobytes() == data.tobytes()
    assert testing.counters_since(before).get("inflate.device") == len(data)
    for wire, verdict, counter in (
            (z[: len(z) // 2], "Unexpected EOF during decompression", "device_fallback"),
            (flip(z, len(z) - 1), "Data integrity check failed", "device_mismatch_fallback"),
            (flip(gz, len(gz) - 1), "Data size check failed", "device_mismatch_fallback")):
        before = trace.get_counters()
        with pytest.raises(ValueError, match=verdict):
            tpuzlib_torch.inflate(wire, device=dev)
        moved = testing.counters_since(before)
        assert {k: moved.get("inflate." + k, 0) for k in ("device_fallback",
                                                          "device_mismatch_fallback")} == {
            k: int(k == counter) for k in ("device_fallback", "device_mismatch_fallback")}
    zdict = data[:32 << 10].tobytes()
    c = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=zdict)
    fdict = c.compress(data.tobytes()) + c.flush()
    assert tpuzlib_torch.inflate(fdict, zdict, device=dev).tobytes() == data.tobytes()
    inf = tpuzlib_torch.Inflater(dictionary=zdict)
    out = [b for i in range(0, len(fdict), 4096) for b in inf.append(fdict[i: i + 4096])]
    result = inf.finish()
    assert b"".join(b.tobytes() for b in out) == data.tobytes()
    assert (result.success, result.checksum, inf.total_in, inf.total_out) == (
        True, "match", len(fdict), len(data))
