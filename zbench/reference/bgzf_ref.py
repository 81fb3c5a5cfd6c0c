"""The plain reference of the BGZF configuration: Python's zlib and
struct, member by member.

BGZF (the SAM/BAM format specification, section 4.1): gzip members of at
most 65,280 input bytes (htslib's BGZF_BLOCK_SIZE, 0xff00), each with a
`BC` extra subfield that holds the member's size less one (BSIZE), raw
deflate at the configuration's level, window bits and memLevel
(htslib's deflateInit2(level, Z_DEFLATED, -15, 8, ...)), and the fixed
28-byte empty member at the end of a file.  It imports no part of
tpuzlib or tpuzlib_torch.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

EOF_MEMBER = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")


def member(data, config: dict) -> bytes:
    """One BGZF member of `data` (at most config["member_input_bytes"])."""
    c = zlib.compressobj(config["level"], zlib.DEFLATED, -config["window_bits"],
                         config["mem_level"])
    body = c.compress(memoryview(data)) + c.flush()
    head = struct.pack("<4BI2BH2sHH", 31, 139, 8, 4, 0, 0, 255, 6, b"BC", 2, len(body) + 25)
    return head + body + struct.pack("<II", zlib.crc32(memoryview(data)), len(data))


def pieces(data: np.ndarray, config: dict) -> list:
    """`data` cut into the members' inputs."""
    step = config["member_input_bytes"]
    return [data[i : i + step] for i in range(0, len(data), step)]


def read(wire) -> bytes:
    """The members' bytes, member by member by BSIZE, each member's CRC-32
    and ISIZE checked; ValueError for a member that fails or a BSIZE past
    the end."""
    wire = memoryview(np.ascontiguousarray(wire)).cast("B")
    out, at = [], 0
    while at < len(wire):
        xlen, si, slen, bsize = struct.unpack("<H2sHH", wire[at + 10 : at + 18])
        end = at + bsize + 1
        if wire[at : at + 2] != b"\x1f\x8b" or si != b"BC" or slen != 2 or end > len(wire):
            raise ValueError("no whole BGZF member at offset %d" % at)
        d = zlib.decompressobj(-15)
        got = d.decompress(wire[at + 12 + xlen : end - 8]) + d.flush()
        crc, isize = struct.unpack("<II", wire[end - 8 : end])
        if not d.eof or d.unused_data or zlib.crc32(got) != crc or len(got) != isize:
            raise ValueError("the BGZF member at offset %d fails its check" % at)
        out.append(got)
        at = end
    return b"".join(out)
