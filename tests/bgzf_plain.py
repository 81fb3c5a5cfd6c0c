"""A plain BGZF writer and reader in Python's zlib and struct, the
reference the port's multi-member decode is held to (SAM/BAM format
specification, section 4.1): gzip members of at most BLOCK input bytes,
each with a `BC` extra subfield holding the member's size less one, raw
deflate at windowBits -15 and memLevel 8, and the 28-byte empty EOF
member at the end.  No part of tpuzlib or tpuzlib_torch is used.
"""

from __future__ import annotations

import struct
import zlib

BLOCK = 0xFF00  # htslib's BGZF_BLOCK_SIZE: input bytes a member at most
EOF_MEMBER = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")


def frame(body: bytes, crc: int, isize: int) -> bytes:
    """A BGZF member around a raw deflate body and its trailer's values."""
    head = struct.pack("<4BI2BH2sHH", 31, 139, 8, 4, 0, 0, 255, 6, b"BC", 2, len(body) + 25)
    return head + body + struct.pack("<II", crc & 0xFFFFFFFF, isize & 0xFFFFFFFF)


def deflate_raw(data: bytes, level: int = 6, strategy: int = zlib.Z_DEFAULT_STRATEGY,
                sync_every: int = 0) -> bytes:
    """zlib's raw deflate of data (windowBits -15, memLevel 8), with a sync
    flush every `sync_every` bytes where it is not 0 (blocks and empty
    stored markers between them)."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    step = sync_every or max(1, len(data))
    out = []
    for i in range(0, len(data), step):
        out.append(c.compress(data[i : i + step]))
        if sync_every:
            out.append(c.flush(zlib.Z_SYNC_FLUSH))
    return b"".join(out) + c.flush()


def member(data: bytes, level: int = 6, **options) -> bytes:
    """One BGZF member of data (at most BLOCK bytes)."""
    return frame(deflate_raw(data, level, **options), zlib.crc32(data), len(data))


def write(data: bytes, level: int = 6, eof: bool = True, **options) -> tuple[bytes, list]:
    """data as BGZF members of BLOCK bytes (the last shorter), then the EOF
    member: (the bytes, each member's first byte)."""
    members = [member(data[i : i + BLOCK], level, **options) for i in range(0, len(data), BLOCK)]
    if eof:
        members.append(EOF_MEMBER)
    starts, at = [], 0
    for m in members:
        starts.append(at)
        at += len(m)
    return b"".join(members), starts


def spans(wire: bytes) -> list:
    """Each member's (first byte, end) by its BSIZE."""
    out, at = [], 0
    while at < len(wire):
        if len(wire) - at < 18 or wire[at : at + 2] != b"\x1f\x8b":
            raise ValueError("not a BGZF member at offset %d" % at)
        xlen, si, slen, bsize = struct.unpack("<H2sHH", wire[at + 10 : at + 18])
        if si != b"BC" or slen != 2:
            raise ValueError("no BC subfield at offset %d" % at)
        if at + bsize + 1 > len(wire):
            raise ValueError("truncated member at offset %d" % at)
        out.append((at, at + bsize + 1))
        at += bsize + 1
    return out


def read(wire: bytes) -> bytes:
    """The members' bytes, member by member by BSIZE, each member's CRC-32
    and ISIZE checked; ValueError for a member that fails."""
    out = []
    for at, end in spans(wire):
        xlen = struct.unpack("<H", wire[at + 10 : at + 12])[0]
        body = wire[at + 12 + xlen : end - 8]
        d = zlib.decompressobj(-15)
        try:
            got = d.decompress(body) + d.flush()
        except zlib.error as e:
            raise ValueError("member at offset %d: %s" % (at, e)) from None
        crc, isize = struct.unpack("<II", wire[end - 8 : end])
        if not d.eof or d.unused_data or zlib.crc32(got) != crc or len(got) & 0xFFFFFFFF != isize:
            raise ValueError("member at offset %d fails its check" % at)
        out.append(got)
    return b"".join(out)
