"""inflate_members() and the segmented CRC-32 kernel on the card.

Every test here is marked `cuda` and skips without a CUDA card.  The CPU
tests (test_torch_members_bgzf.py) hold both routes and the plain CRC
twin to a plain BGZF reader; these hold, on a card: the benchmark cell's
32 MiB BAM slice (zbench/entries/bgzf.py's records, 515 members and the
EOF member) against the plain reader, byte for byte, every member from
the device route; crc32_segments against crc32_segments_plain and zlib
at ragged bounds; one inflate_decode launch a call whatever the member
count (by the launch counter and by torch.profiler); the check's CUDA
events near its kernel's profiler time; and a member whose
CRC-32 is corrupted ending on the host engine with the host's verdict.
On a machine with a card (and no JAX, which tests/conftest.py imports),
from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_members.py
"""

import os
import sys
import zlib

import numpy as np
import pytest
import torch

import bgzf_plain
import tpuzlib_torch
from tpuzlib_torch import testing
from tpuzlib_torch.api.inflate_api import member_index
from tpuzlib_torch.kernels import _build
from tpuzlib_torch.kernels.crc32_segments import crc32_segments, crc32_segments_plain
from tpuzlib_torch.utils import trace

pytestmark = pytest.mark.cuda

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _slice(n: int, seed: int):
    """n bytes of the benchmark cell's BAM records as BGZF: (records, wire)."""
    from zbench.entries import bgzf

    data = bgzf.records(n, [seed, 0]).tobytes()
    return data, bgzf_plain.write(data)[0]


@pytest.fixture(scope="module")
def cell_slice():
    _card()
    return _slice(32 << 20, 3000000031)


def test_cell_slice_against_the_reference(cell_slice):
    data, wire = cell_slice
    assert len(bgzf_plain.spans(wire)) == 516
    before = trace.get_counters()
    out = tpuzlib_torch.inflate_members(np.frombuffer(wire, np.uint8), device="cuda")
    moved = testing.counters_since(before)
    assert bytes(out) == bgzf_plain.read(wire) == data
    assert moved.get("inflate.members_card") == 516 and not moved.get("inflate.members_host")
    assert moved["inflate.device"] == len(data)


@pytest.mark.parametrize("shift", [0, 1, 3, 15, 128, 129])
def test_segments_against_the_plain_twin(shift):
    _card()
    rng = np.random.default_rng(shift)
    lens = [0, 1, 3, 4, 15, 16, 17, 127, 128, 129, 255, 4096, 65280, 65536, 70000, 32768 + 5,
            300000, 0, 2]
    data = rng.integers(0, 256, sum(lens) + shift + 9, dtype=np.uint8)
    offs = np.concatenate([[shift], shift + np.cumsum(lens)])
    dev = torch.from_numpy(data).cuda()
    got = crc32_segments(dev, offs).cpu()
    assert torch.equal(got, crc32_segments_plain(torch.from_numpy(data), offs))
    want = [zlib.crc32(data[a:b].tobytes()) for a, b in zip(offs[:-1], offs[1:])]
    assert got.numpy().view(np.uint32).tolist() == want
    # bounds that skip bytes, all-0xFF and all-zero bytes, a view off its
    # allocation's start, the segment ending at the buffer's last byte
    for fill in (0, 255):
        flat = torch.full((5000,), fill, dtype=torch.uint8, device="cuda")[shift % 7:]
        offs2 = [1, 700, 700, 1000, 4000, flat.numel()]
        got = crc32_segments(flat, offs2).cpu().numpy().view(np.uint32).tolist()
        host = flat.cpu().numpy()
        assert got == [zlib.crc32(host[a:b].tobytes()) for a, b in zip(offs2[:-1], offs2[1:])]


def test_segments_launch_once_and_time_with_the_telemetry():
    _card()
    data = torch.randint(0, 256, (1 << 20,), dtype=torch.uint8, device="cuda")
    offs = np.arange(0, (1 << 20) + 1, 65280).tolist() + [1 << 20]
    was = trace.telemetry_enabled()
    trace.enable(True)
    before, launches = trace.get_counters(), _build.LAUNCHES["crc32_segments"]
    try:
        crc32_segments(data, offs)
    finally:
        trace.enable(was)
    moved = testing.counters_since(before)
    assert _build.LAUNCHES["crc32_segments"] == launches + 1
    assert moved["crc32.segments_bytes"] == 1 << 20 and moved["crc32.segments"] == len(offs) - 1
    assert moved["crc32.segments_device_ns"] > 0


def _decode_launches(fn):
    """inflate_decode launches of one call of fn: by the launch counter and
    by torch.profiler's kernel events."""
    before = _build.LAUNCHES["inflate_decode"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if "inflate_decode" in e.key)
    return _build.LAUNCHES["inflate_decode"] - before, kernels


def test_one_decode_launch_a_call(cell_slice):
    data, wire = cell_slice
    small = _slice(4 << 20, 3000000032)[1]
    counts = []
    for w in (small, wire):
        view = np.frombuffer(w, np.uint8)
        tpuzlib_torch.inflate_members(view, device="cuda")  # warm
        counts.append(_decode_launches(lambda: tpuzlib_torch.inflate_members(view, device="cuda")))
    assert counts == [(1, 1), (1, 1)], counts  # 66 members and 516 alike


def test_the_check_events_time_the_kernel(cell_slice):
    """In a call, crc32.segments_device_ns brackets the check's kernel:
    its upload is queued ahead of the start event, so the events read
    near the kernel's own time (by torch.profiler, on the same bytes and
    bounds, apart: the profiler slows the host's launch path) and not the
    host's launch path."""
    data, wire = cell_slice
    view = np.frombuffer(wire, np.uint8)
    out = tpuzlib_torch.inflate_members(view, device="cuda")  # warm
    was = trace.telemetry_enabled()
    trace.enable(True)
    before = trace.get_counters()
    try:
        tpuzlib_torch.inflate_members(view, device="cuda")
    finally:
        trace.enable(was)
    events_us = testing.counters_since(before)["crc32.segments_device_ns"] / 1e3
    dev = torch.from_numpy(out).to("cuda")
    bounds = np.concatenate([[0], np.cumsum([m.isize for m in member_index(view)])])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            crc32_segments(dev, bounds)
        torch.cuda.synchronize()
    (kernel,) = [e for e in prof.key_averages() if "crc32_segments_kernel" in e.key]
    kernel_us = (getattr(kernel, "device_time_total", None) or kernel.cuda_time_total) / kernel.count
    assert kernel_us <= events_us <= 2 * kernel_us + 20, (events_us, kernel_us)


def test_a_corrupted_crc_ends_on_the_host(cell_slice):
    data, wire = cell_slice
    spans = bgzf_plain.spans(wire)
    bad = bytearray(wire)
    bad[spans[7][1] - 6] ^= 0x01  # member 7's stored CRC-32
    view = np.frombuffer(bytes(bad), np.uint8)
    before = trace.get_counters()
    with pytest.raises(ValueError) as card:
        tpuzlib_torch.inflate_members(view, device="cuda")
    moved = testing.counters_since(before)
    with pytest.raises(ValueError) as host:
        tpuzlib_torch.inflate_members(view, device="cpu")
    assert str(card.value) == str(host.value) == "Data integrity check failed"
    assert moved.get("inflate.members_card") == 515  # every other member from the card
