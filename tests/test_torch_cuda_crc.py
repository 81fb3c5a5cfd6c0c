"""The CRC-32 kernel (csrc/crc32.cu) against its plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA card.  The CPU
tests (test_torch_checksums.py, test_torch_crc_scalar.py) hold the plain
versions to tpuzlib; these hold the kernel's two form modes and its
finished CRC (crc32_device_scalar) to them, and to zlib, at lengths
around every chain piece (128 B), 16-byte word, 1 KiB block, 4 KiB
chunk of a warp, 256 KiB span and 1 MiB of a CUDA block, at every start
offset 0-15, on constant bytes and on inputs that end at their buffer's
last byte.  Every comparison is exact.  On a machine
with a card (and no JAX, which tests/conftest.py imports), from the repo
root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_crc.py
"""

import zlib

import numpy as np
import pytest
import torch

import tpuzlib_torch
from tpuzlib_torch import testing
from tpuzlib_torch.kernels import _build, crc32, crc32_cuda

pytestmark = pytest.mark.cuda

KB = 1 << 10
SPAN = 256 * KB
PIECE = 128  # bytes a lane of the kernel folds as one chain
CHUNK = 4 * KB  # bytes a warp of the kernel stages at a time
LENGTHS = [1, 15, 16, 17, PIECE - 1, PIECE, PIECE + 1, KB - 16, KB - 1, KB, KB + 1,
           3 * KB + PIECE + 17, CHUNK - 1, CHUNK + 1, SPAN - 1, SPAN, SPAN + 1,
           2 * SPAN + PIECE + 16, 4 * SPAN - 1, 4 * SPAN + CHUNK + 3]
SEEDS = [0, 1, 0xDEADBEEF]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _launched(kernels, fn):
    """fn()'s result, checking that it launched each of `kernels` once."""
    before = {k: _build.LAUNCHES[k] for k in kernels}
    out = fn()
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] - before[k] for k in kernels} == {k: 1 for k in kernels}
    return out


def _at(data, offset, dev, after=b""):
    """`data` on the card, `offset` bytes into its buffer, `after` behind it."""
    buf = torch.empty(offset + len(data) + len(after), dtype=torch.uint8, device=dev)
    host = np.frombuffer(bytes(offset) + data.tobytes() + after, np.uint8)
    buf.copy_(torch.from_numpy(host.copy()))
    return buf[offset: offset + len(data)]


def _forms_equal(x, tile):
    n = x.numel()
    pad = (-n) % (KB * tile)
    got = _launched([crc32_cuda._MODE[tile]], lambda: crc32_cuda.crc32_forms(x, pad, tile))
    assert got.dtype == torch.int32 and got.shape == ((n + pad) // (KB * tile),)
    assert torch.equal(got, crc32_cuda.crc32_forms_plain(x, pad, tile))


def _scalar_equal(x, data, seed=0):
    mode = "crc32_spans" if x.numel() >= SPAN else "crc32_forms"
    got = _launched(["crc32_scalar", mode], lambda: crc32_cuda.crc32_device_scalar(x, seed))
    assert got.dtype == torch.int64 and got.shape == () and got.device == x.device
    want = zlib.crc32(data.tobytes(), seed)
    assert int(got) == want == int(crc32_cuda.crc32_device_scalar_plain(x, seed))


@pytest.mark.parametrize("tile", [1, 256])
@pytest.mark.parametrize("n", LENGTHS)
def test_crc32_forms_kernel_lengths(dev, n, tile):
    data = testing.mixed(n + 1, n)[:n]
    _forms_equal(_at(data, 0, dev), tile)
    _scalar_equal(_at(data, 0, dev), data, SEEDS[n % 3])


@pytest.mark.parametrize("tile", [1, 256])
@pytest.mark.parametrize("offset", range(16))
def test_crc32_forms_kernel_offsets(dev, offset, tile):
    for n in (3 * KB + 77, SPAN + 77):
        data = testing.mixed(n + 1, n + offset)[:n]
        x = _at(data, offset, dev)
        _forms_equal(x, tile)
        _scalar_equal(x, data, SEEDS[offset % 3])


@pytest.mark.parametrize("fill", [0x00, 0xFF])
@pytest.mark.parametrize("n", [KB, 5 * KB + 3, SPAN + 5])
def test_crc32_forms_kernel_constant_bytes(dev, n, fill):
    data = np.full(n, fill, np.uint8)
    for tile in (1, 256):
        _forms_equal(_at(data, 3, dev), tile)
    _scalar_equal(_at(data, 3, dev), data, 0xDEADBEEF)


@pytest.mark.parametrize("offset", [0, 1, 15])
@pytest.mark.parametrize("n", [PIECE + 1, KB, 2 * SPAN + 7])
def test_crc32_kernel_reads_nothing_past_the_end(dev, n, offset):
    """An input that ends at its buffer's last byte, and one followed by
    0xFF bytes that must not enter the result."""
    data = testing.mixed(n + 1, 3 * n)[:n]
    for x in (_at(data, offset, dev), _at(data, offset, dev, b"\xff" * 40)):
        for tile in (1, 256):
            _forms_equal(x, tile)
        _scalar_equal(x, data, 1)


@pytest.mark.parametrize("n", [1, 1023, 200 * KB, SPAN - 1, SPAN + 1, 8 << 20])
def test_crc32_device_scalar_matches_zlib_and_plain(dev, n):
    data = testing.mixed(n + 1, n + 11)[:n]
    x = _at(data, 5, dev)
    for seed in SEEDS:
        _scalar_equal(x, data, seed)
        assert tpuzlib_torch.crc32(x, seed) == zlib.crc32(data.tobytes(), seed)


def test_crc32_device_scalar_of_nothing_is_the_seed(dev):
    x = torch.empty(0, dtype=torch.uint8, device=dev)
    before = _build.LAUNCHES["crc32_scalar"]
    got = crc32_cuda.crc32_device_scalar(x, 0xDEADBEEF)
    assert got.device == x.device and int(got) == 0xDEADBEEF
    assert _build.LAUNCHES["crc32_scalar"] == before


def test_crc32_device_scalar_on_two_streams(dev):
    """Calls on two streams at once, each stream with its own ticket, and
    the tickets back at 0 after."""
    datas = [testing.mixed(3 * SPAN + 99, s)[: 3 * SPAN + 99 - s] for s in (1, 2)]
    xs = [_at(d, 0, dev) for d in datas]
    streams = [torch.cuda.Stream(dev) for _ in xs]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, (x, st) in enumerate(zip(xs, streams)):
            with torch.cuda.stream(st):
                outs[i].append(crc32_cuda.crc32_device_scalar(x, i))
    torch.cuda.synchronize()
    for i, d in enumerate(datas):
        assert {int(o) for o in outs[i]} == {zlib.crc32(d.tobytes(), i)}
    for st in streams:
        with torch.cuda.stream(st):
            assert int(_build.ticket(dev)) == 0


def test_public_crc32_on_card_takes_no_plain_path(dev, monkeypatch):
    """No fallback: with the card present, a CUDA tensor never reaches the
    plain versions or the host tree."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version or the host tree")

    monkeypatch.setattr(crc32_cuda, "crc32_forms_plain", refuse)
    monkeypatch.setattr(crc32_cuda, "crc32_device_scalar_plain", refuse)
    monkeypatch.setattr(crc32, "_combine_blocks", refuse)
    monkeypatch.setattr(crc32, "_finish", refuse)
    for n in (1, 200 * KB, 3 * SPAN + 12345):
        data = testing.mixed(n + 1, n)[:n]
        x = _at(data, 1, dev)
        got = _launched(["crc32_scalar"], lambda: tpuzlib_torch.crc32(x, 7))
        assert got == zlib.crc32(data.tobytes(), 7)
