"""zlib (RFC 1950) and gzip (RFC 1952) header and trailer writers.

Counterpart of tpuzlib/containers/headers.py: the zlib header with an
optional preset-dictionary id, the gzip header with FNAME and MTIME, and
the Adler-32 / CRC-32 + ISIZE trailers.
"""

from __future__ import annotations

import struct
import time


def make_zlib_header(level: int, dict_checksum: int | None = None) -> bytes:
    """RFC 1950 CMF/FLG header (windowBits=15), with FDICT and the DICTID
    (the dictionary's Adler-32) when `dict_checksum` is given.

    FLEVEL encodes the compression-level class: 0 for fastest .. 3 for
    maximum.
    """
    cmf = 0x78  # deflate, 32K window
    if level < 2:
        flevel = 0
    elif level < 6:
        flevel = 1
    elif level == 6:
        flevel = 2
    else:
        flevel = 3
    flg = flevel << 6
    if dict_checksum is not None:
        flg |= 0x20  # FDICT
    rem = (cmf * 256 + flg) % 31
    if rem:
        flg += 31 - rem
    out = bytes([cmf, flg])
    if dict_checksum is not None:
        out += struct.pack(">I", dict_checksum)
    return out


def make_zlib_trailer(adler: int) -> bytes:
    return struct.pack(">I", adler & 0xFFFFFFFF)


def make_gzip_header(file_name: str | None = None, mtime: int | None = None,
                     level: int = 6) -> bytes:
    """RFC 1952 header with MTIME (now, unless given) and, when a name is
    given, FNAME."""
    flg = 0x08 if file_name else 0
    if mtime is None:
        mtime = int(time.time())
    xfl = 2 if level >= 9 else (4 if level <= 2 else 0)
    out = struct.pack("<BBBBIBB", 0x1F, 0x8B, 8, flg, mtime & 0xFFFFFFFF, xfl, 255)
    if file_name:
        out += file_name.encode("utf-8") + b"\0"
    return out


def make_gzip_trailer(crc: int, total_in: int) -> bytes:
    return struct.pack("<II", crc & 0xFFFFFFFF, total_in & 0xFFFFFFFF)
