"""The CRC-32 of every segment of one buffer in one launch
(csrc/crc32_segments.cu): the check of the members a multi-member
decode returns (api/inflate_api.inflate_members), each member's output
one segment.

The port's own kernel: tpuzlib checks a member's trailer with one
`crc32()` a member.  `crc32_segments(data, offsets)` takes a 1-D uint8
tensor and the segment bounds on the host (segment i is
data[offsets[i]:offsets[i + 1]]) and returns each segment's CRC-32 as
int32 bit patterns on data's device; `crc32_segments_plain` is its plain
torch twin on any device.  On a CUDA tensor the wrapper uploads the
bounds (copy.h2d_bytes), launches the kernel (counted as
`crc32_segments`) and, while the telemetry is on, counts the bytes it
reads as `crc32.segments_bytes`, its segments as `crc32.segments` and
its device time by CUDA events as `crc32.segments_device_ns`, which
utils/trace.get_counters resolves later, so the call never waits for the
card.  The bounds go up from pinned memory without waiting, and the start
event is recorded behind them: where the caller has queued work ahead on
the stream (check_members queues its upload), the events bracket the
kernel alone; on an idle stream they also hold the host's launch path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from . import _build
from .crc32 import _MASK32, _table8
from .crc32_cuda import _constants, _power_tables
from .deflate_device3 import _as_i32

PLAIN_BLOCK = 1024  # bytes a lane of the plain version folds


def _bounds(data: torch.Tensor, offsets) -> np.ndarray:
    """The bounds as int64 on the host; raises unless they are
    non-decreasing and inside data."""
    _build.check_bytes("crc32_segments", data)
    offs = np.ascontiguousarray(np.asarray(offsets, dtype=np.int64).reshape(-1))
    if len(offs) < 1:
        raise ValueError("crc32_segments: offsets need at least one bound")
    if offs[0] < 0 or offs[-1] > data.numel() or (np.diff(offs) < 0).any():
        raise ValueError("crc32_segments: offsets must be non-decreasing within [0, %d]"
                         % data.numel())
    return offs


def _shift(pw: torch.Tensor, k: int, v: torch.Tensor) -> torch.Tensor:
    """A^(2^k) v by the byte lookup tables of crc32_cuda._power_tables."""
    t = pw[k]
    return t[0][v & 0xFF] ^ t[1][(v >> 8) & 0xFF] ^ t[2][(v >> 16) & 0xFF] ^ t[3][v >> 24]


def _shift_by(pw: torch.Tensor, n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A^n[i] v[i] for every i, by the bits of n (int64 tensors)."""
    top = int(n.max()) if n.numel() else 0
    for k in range(top.bit_length()):
        v = torch.where((n >> k) & 1 == 1, _shift(pw, k, v), v)
    return v


def crc32_segments_plain(data: torch.Tensor, offsets) -> torch.Tensor:
    """crc32_segments in torch ops on data's device: each segment cut into
    PLAIN_BLOCK-byte blocks front-padded with zeros, every block folded
    by the table at once, each block's form shifted by A^(bytes after it
    in its segment), the forms XORed per segment (bit by bit, as sums
    mod 2), and the CRC finished with A^n ~0 ^ ~0; exact on any device."""
    offs = _bounds(data, offsets)
    dev = data.device
    segs = len(offs) - 1
    if segs == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    lens = np.diff(offs)
    nblk = -(-lens // PLAIN_BLOCK)
    seg_of = np.repeat(np.arange(segs), nblk)
    # block j of segment s ends (nblk[s] - 1 - j) blocks before its end
    after = np.concatenate([np.arange(n - 1, -1, -1) for n in nblk]) if nblk.sum() else \
        np.zeros(0, np.int64)
    start = torch.from_numpy(offs[1:][seg_of] - (after + 1) * PLAIN_BLOCK).to(dev)
    lo = torch.from_numpy(offs[:-1][seg_of]).to(dev)
    table = torch.from_numpy(_table8().astype(np.int64)).to(dev)
    crc = torch.zeros(len(seg_of), dtype=torch.int64, device=dev)
    for j in range(PLAIN_BLOCK):  # column j of every block; bytes before lo read as 0
        at = start + j
        byte = torch.where(at >= lo, data[at.clamp(min=0)].long(), 0)
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    pw = _power_tables(dev)
    crc = _shift_by(pw, torch.from_numpy(after * PLAIN_BLOCK).to(dev), crc)
    bits = (crc[:, None] >> torch.arange(32, device=dev)) & 1
    per_seg = torch.zeros((segs, 32), dtype=torch.int64, device=dev)
    per_seg.index_add_(0, torch.from_numpy(seg_of).to(dev), bits)
    form = ((per_seg & 1) << torch.arange(32, device=dev)).sum(1)
    n = torch.from_numpy(lens).to(dev)
    raw = _shift_by(pw, n, torch.full((segs,), _MASK32, dtype=torch.int64, device=dev))
    return _as_i32(form ^ raw ^ _MASK32)


def crc32_segments(data: torch.Tensor, offsets) -> torch.Tensor:
    """The CRC-32 of data[offsets[i]:offsets[i + 1]] for every i, as int32
    bit patterns on data's device (mask with 0xFFFFFFFF for the CRC).
    `data`: a 1-D contiguous uint8 tensor starting at any byte; `offsets`:
    the bounds on the host, non-decreasing within [0, len(data)].  One
    launch on a card, the plain version on the CPU."""
    if _build.on_cpu(data):
        return crc32_segments_plain(data, offsets)
    offs = _bounds(data, offsets)
    dev = data.device
    segs = len(offs) - 1
    out = torch.empty(segs, dtype=torch.int32, device=dev)
    if segs == 0:
        return out
    trace.count_copy("h2d", dev, offs)
    bounds = torch.from_numpy(offs).pin_memory().to(dev, non_blocking=True)
    table, cols = _constants(dev)
    timed = trace.telemetry_enabled()
    if timed:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    _build.launch("crc32_segments", "tz_crc32_segments", dev, data.data_ptr(), data.numel(),
                  bounds.data_ptr(), segs, table.data_ptr(), cols.data_ptr(), out.data_ptr())
    if timed:
        end.record()
        trace.count("crc32.segments_bytes", int(offs[-1] - offs[0]))
        trace.count("crc32.segments", segs)
        trace.count_device_ns("crc32.segments_device_ns", start, end)
    return out
