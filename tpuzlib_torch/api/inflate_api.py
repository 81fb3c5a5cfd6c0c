"""Public one-shot decompression: inflate().

Counterpart of tpuzlib/api/inflate_api.py's container detection (lines
237-307) and its device route `_inflate_device_oneshot` (lines 154-234).
The port has no host engine, so inflate() always decodes on the device it
is given: no size floor, raw streams too, and no fallback.  Pass 3 runs
on the host (decode's default), so the output is a host array.  A stream the
device path declines, or whose output fails its container's checksum or
ISIZE, raises DeviceDeclined (tpuzlib re-decodes such streams on its host
engine, which settles whether the data or the device path is at fault);
device and build errors propagate.  The trailer's checksum runs on
`device` through the port's own crc32 / adler32.  The trailer is read
from the first whole byte after the stream's final block, as tpuzlib's
ContainerInflater reads it, and bytes after it are ignored: a second
gzip member, or trailing garbage.  A trailer cut short raises
ValueError("Unexpected EOF during decompression").
"""

from __future__ import annotations

import struct

import numpy as np

from ..codec.tokenize import DataError
from ..common import u8_view
from ..containers.inflate_container import parse_gzip_header, parse_zlib_header
from ..kernels.inflate_device2 import DeviceDeclined, decode, decode_stream
from .checksums import adler32, crc32

_NO_DICTIONARIES = (
    "preset dictionaries are not supported: tpuzlib's device route declines them,"
    " and the host engine that serves them is not ported to tpuzlib_torch"
)
_EOF = "Unexpected EOF during decompression"


def _trailer(input_, start: int, end_bit: int, n: int) -> bytes:
    """The n trailer bytes from the first whole byte after a DEFLATE stream
    that starts at byte `start` and ends at bit `end_bit` of it; raises
    ValueError where the input ends first."""
    at = start + (end_bit + 7) // 8
    if len(input_) < at + n:
        raise ValueError(_EOF)
    return input_[at : at + n].tobytes()


def inflate(data, dictionary=None, *, device="cuda") -> np.ndarray:
    """One-shot decompress `data` on `device`, detecting its container: gzip
    (1F 8B), zlib (first byte exactly 0x78 with a valid header check), else
    raw DEFLATE.  Returns the bytes as a uint8 array."""
    input_ = u8_view(data)
    if len(input_) < 2:
        raise ValueError("data buffer is too small")
    if dictionary is not None:
        raise NotImplementedError(_NO_DICTIONARIES)
    b0, b1 = int(input_[0]), int(input_[1])
    try:
        if b0 == 0x1F and b1 == 0x8B:
            hdr = parse_gzip_header(
                input_, lambda b: crc32(np.ascontiguousarray(b), device=device) & 0xFFFF)
            if hdr is None or len(input_) < hdr.size + 8:
                raise ValueError(_EOF)
            out, end = decode_stream(input_[hdr.size :], device=device)
            stored_crc, isize = struct.unpack("<II", _trailer(input_, hdr.size, end, 8))
            if crc32(out, device=device) != stored_crc:
                raise DeviceDeclined("the device output fails the gzip CRC-32")
            if len(out) & 0xFFFFFFFF != isize:
                raise DeviceDeclined("the device output fails the gzip ISIZE")
            return out
        if b0 == 0x78 and ((b0 << 8) + b1) % 31 == 0:
            hdr = parse_zlib_header(input_)
            if hdr is None or len(input_) < hdr[0] + 4:
                raise ValueError(_EOF)
            if hdr[1] is not None:
                raise NotImplementedError(_NO_DICTIONARIES)
            out, end = decode_stream(input_[hdr[0] :], device=device)
            stored_adler = struct.unpack(">I", _trailer(input_, hdr[0], end, 4))[0]
            if adler32(out, device=device) != stored_adler:
                raise DeviceDeclined("the device output fails the zlib Adler-32")
            return out
        return decode(input_, device=device)
    except DataError as e:
        raise ValueError("inflate error: %s" % e) from None
