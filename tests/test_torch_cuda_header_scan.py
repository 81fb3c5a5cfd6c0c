"""The device inflate's header scan on the card (kernels/header_scan.py,
csrc/header_scan.cu).

Every test here is marked `cuda` and skips without a CUDA card.  The
kernels' candidates equal the plain version's (run on the card's tensors)
and, confirmed on the host, the native scan's positions
(find_all_block_starts) on zlib streams at levels 1, 6 and 9, sync
flushes, stored blocks, random bytes, level-9 text and a 32 MiB stream of
the benchmark's pylogs-gzip9 kind, from bit 0 and from a later bit, with
and without final blocks; with the native library switched off, the
host's python confirmation gives the numpy scan's positions.
decode_stream decodes with the card scan to the bytes and end bit it
decodes to on the CPU (also without the native library), launches the
scan's two kernels once a stream that needs a scan, and uploads the
stream's words once (the copy.h2d_bytes counter as with the host scan).  On a machine
with a card (and no JAX, which tests/conftest.py imports), from the repo
root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_header_scan.py
"""

import functools
import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch

from tpuzlib_torch import testing
from tpuzlib_torch.kernels import _build
from tpuzlib_torch.kernels import header_scan as HS
from tpuzlib_torch.kernels import inflate_cuda as PC
from tpuzlib_torch.kernels import inflate_device2 as P
from tpuzlib_torch.parallel import speculative as pspec
from tpuzlib_torch.utils import trace

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIDE = 1 << 13
PYLOGS_SEED = 2420000001


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _pylogs():
    """The raw DEFLATE body of a 32 MiB stream of the benchmark's
    pylogs-gzip9 cell (its blend of 1 MiB text pieces, zlib level 9 into
    gzip), and its bytes."""
    sys.path.insert(0, ROOT)
    from zbench.entries import blend
    from zbench.reference import zlib_ref

    with open(os.path.join(ROOT, "zbench", "configs", "pylogs-gzip9.json")) as f:
        config = json.load(f)
    data = np.concatenate(blend(config["data"], 32 << 20, PYLOGS_SEED))
    gz = np.frombuffer(zlib_ref.compress(data, config), np.uint8)
    return gz[10:-8], data  # zlib's gzip header has no optional fields


@functools.lru_cache(maxsize=None)
def _streams() -> dict:
    out = {k: v[0] for k, v in testing.inflate_streams().items()}
    out["random"] = np.random.default_rng(21).integers(0, 256, 1 << 20, dtype=np.uint8)
    text = testing.corpus("text", 3 << 19, 12)
    out["text L9"] = np.frombuffer(testing.zlib_stream(text, 9, -15), np.uint8)
    return out


SCAN_NAMES = ["L1", "L6", "L9", "sync flush", "stored", "hidden stored", "random", "text L9",
              "pylogs 32 MiB"]


def _stream(name):
    return _pylogs()[0] if name == "pylogs 32 MiB" else _streams()[name]


@pytest.mark.parametrize("allow_final", [True, False])
@pytest.mark.parametrize("from_bit", [0, 8 * 1000 + 3])
@pytest.mark.parametrize("name", SCAN_NAMES)
def test_card_scan_matches(dev, name, from_bit, allow_final):
    buf = _stream(name)
    words = PC.stream_words(buf, STRIDE, 2 * P.OVERLAP, dev)
    before = dict(_build.LAUNCHES)
    cands = HS.candidates(words, len(buf) * 8, from_bit, allow_final)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["header_filter"] - before["header_filter"] == 1
    assert _build.LAUNCHES["header_parse"] - before["header_parse"] == 1
    assert np.array_equal(cands, HS.candidates_plain(words, len(buf) * 8, from_bit, allow_final))
    want = pspec.find_all_block_starts(buf, from_bit, allow_final)
    assert HS.block_starts(buf, words, from_bit, allow_final) == want
    assert set(want) <= set(cands.tolist())
    if name == "pylogs 32 MiB":
        assert len(want) > 300 and len(cands) <= 2 * len(want)


@pytest.mark.parametrize("name", ["L9", "text L9", "random"])
def test_card_scan_without_native(dev, name):
    buf = _streams()[name]
    words = PC.stream_words(buf, STRIDE, 2 * P.OVERLAP, dev)
    with testing.no_native():
        want = pspec.find_all_block_starts(buf, 0, True)
        assert HS.block_starts(buf, words, 0, True) == want


def test_decode_stream_without_native(dev):
    """With the native library switched off the card still scans: the
    CPU decode's bytes and end bit, the scan's kernels launched once."""
    buf = _streams()["L1"]
    with testing.no_native():
        out, end, moved, launched = _decode_counted(buf, device=dev)
        want, want_end = P.decode_stream(buf, device="cpu")
    assert out == want.tobytes() and end == want_end
    assert launched == 1 and "inflate.scan_card" in moved


def test_card_scan_grows_its_room(dev, monkeypatch):
    """More filter survivors than the first launch has room for: the scan
    runs again with room for all, and the answer is the same."""
    buf = _streams()["random"]
    words = PC.stream_words(buf, STRIDE, 2 * P.OVERLAP, dev)
    want = HS.candidates(words, len(buf) * 8)
    monkeypatch.setattr(HS, "_first_cap", lambda nbits: 16)
    before = _build.LAUNCHES["header_filter"]
    assert np.array_equal(HS.candidates(words, len(buf) * 8), want)
    assert _build.LAUNCHES["header_filter"] - before == 2


def test_card_scan_refuses_bad_words(dev):
    buf = _streams()["L1"]
    words = PC.stream_words(buf, STRIDE, 2 * P.OVERLAP, dev)
    with pytest.raises(ValueError):
        HS.candidates(words[: (len(buf) + 3) // 4 + 3], len(buf) * 8)
    with pytest.raises(RuntimeError):
        HS.candidates(words[1:], len(buf) * 8)  # one word off a 16-byte boundary
    assert len(HS.candidates(words, 80)) == 0


def _decode_counted(buf, **kw):
    """decode_stream with the telemetry on: (bytes, end bit, counters moved,
    launches of the scan's filter); the bytes are the message where the
    device path declines the stream."""
    was = trace.telemetry_enabled()
    trace.enable(True)
    try:
        before, launches = trace.get_counters(), _build.LAUNCHES["header_filter"]
        try:
            out, end = P.decode_stream(buf, **kw)
            out = out.tobytes()
        except P.DeviceDeclined as e:
            out, end = str(e), None
        torch.cuda.synchronize()
        return out, end, testing.counters_since(before), _build.LAUNCHES["header_filter"] - launches
    finally:
        trace.enable(was)


@pytest.mark.parametrize("name", ["L1", "L6", "L9", "fixed", "stored", "sync flush",
                                  "hidden stored", "port encoder"])
def test_decode_stream_with_the_card_scan(dev, name):
    """The bytes and end bit of the CPU decode; the scan's kernels launched
    once where the plan scans."""
    buf = _streams()[name]
    out, end, moved, launched = _decode_counted(buf, device=dev)
    want, want_end = P.decode_stream(buf, device="cpu")
    assert out == want.tobytes() and end == want_end
    scanned = "inflate.scan_card" in moved
    assert launched == int(scanned) and "inflate.scan_host" not in moved
    if name == "L1":
        assert scanned and moved["inflate.scan_candidates"] == moved["inflate.plan_blocks"] - 1


@functools.lru_cache(maxsize=None)
def _text32():
    """32 MiB of text of one vocabulary at zlib level 9 (raw): a stream the
    device path decodes without a decline."""
    data = testing.corpus("text", 32 << 20, 31)
    return np.frombuffer(testing.zlib_stream(data, 9, -15), np.uint8), data


@pytest.mark.parametrize("name", ["pylogs 32 MiB", "text 32 MiB"])
def test_32_mib_stream_uploads_once(dev, monkeypatch, name):
    """32 MiB streams: the same result through the card scan as through the
    host scan (zlib's bytes; or, where the device path declines the
    pylogs stream in its splice repair, the same decline), the same plan,
    the card's candidates within 2x of the headers the scan confirms, and
    the same bytes copied to the card: the scan's upload is the
    decode's."""
    buf, data = _pylogs() if name == "pylogs 32 MiB" else _text32()
    out, end, moved, launched = _decode_counted(buf, device=dev)
    assert launched == 1
    if name == "text 32 MiB" or end is not None:
        assert out == data.tobytes()
    assert moved["inflate.scan_card"] > len(buf) - 1024 and "inflate.scan_host" not in moved
    headers = pspec.find_all_block_starts(buf, len(buf) * 8 - 8 * moved["inflate.scan_card"], True)
    assert len(headers) <= moved["inflate.scan_candidates"] <= 2 * len(headers)
    monkeypatch.setattr(P, "_scans_on_card", lambda device: False)
    out_h, end_h, moved_h, launched_h = _decode_counted(buf, device=dev)
    assert out_h == out and end_h == end and launched_h == 0
    assert moved_h["inflate.plan_blocks"] == moved["inflate.plan_blocks"]
    assert moved_h["inflate.scan_host"] == moved["inflate.scan_card"]
    assert moved["copy.h2d_bytes"] == moved_h["copy.h2d_bytes"]
    nwpad = PC.words_shape(len(buf), P.plan_cursors(buf).stride_bits, 2 * P.OVERLAP)[1]
    assert 4 * nwpad < moved["copy.h2d_bytes"] < 8 * nwpad
    if end is not None:
        assert zlib.decompress(np.asarray(buf).tobytes(), -15) == out
