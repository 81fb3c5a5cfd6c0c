"""zlib (RFC 1950) and gzip (RFC 1952) header parsers for one-shot inflate.

Counterpart of the header checks of tpuzlib/containers/inflate_container.py
(lines 116-182), as plain functions over the whole stream; the streaming
ContainerInflater and the dictionary hand-over are not ported.  Parity with
reference src/inflate.ts: zlib CMF/FLG check (:214-218), DICTID
(:227-270), gzip MTIME/EXTRA/NAME/COMMENT/HCRC (:277-401).
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from ..codec.tokenize import DataError


class GzipHeader(NamedTuple):
    size: int  # header bytes
    mtime: int
    file_name: str


def parse_zlib_header(buf: np.ndarray):
    """(header bytes, DICTID or None) of a zlib stream; None when `buf`
    ends inside the header.  Raises DataError on a malformed header."""
    if len(buf) < 2:
        return None
    cmf, flg = int(buf[0]), int(buf[1])
    if (cmf & 0x0F) != 8:
        raise DataError("unknown compression method")
    if (cmf >> 4) > 7:
        raise DataError("invalid window size")
    if ((cmf << 8) + flg) % 31 != 0:
        raise DataError("incorrect header check")
    if flg & 0x20:  # FDICT
        if len(buf) < 6:
            return None
        return 6, struct.unpack(">I", buf[2:6].tobytes())[0]
    return 2, None


def parse_gzip_header(buf: np.ndarray, header_crc16=None):
    """The GzipHeader of a gzip member; None when `buf` ends inside the
    header.  header_crc16(bytes) -> the low 16 bits of their CRC-32, for a
    header that carries FHCRC.  Raises DataError on a malformed header."""
    if len(buf) < 10:
        return None
    cm, flg = int(buf[2]), int(buf[3])
    if cm != 8:
        raise DataError("unknown compression method")
    if flg & 0xE0:
        raise DataError("unknown header flags set")
    mtime = struct.unpack("<I", buf[4:8].tobytes())[0]
    file_name = ""
    pos = 10
    if flg & 0x04:  # FEXTRA
        if len(buf) < pos + 2:
            return None
        xlen = struct.unpack("<H", buf[pos : pos + 2].tobytes())[0]
        pos += 2
        if len(buf) < pos + xlen:
            return None
        pos += xlen
    if flg & 0x08:  # FNAME
        end = np.flatnonzero(buf[pos:] == 0)
        if len(end) == 0:
            return None
        file_name = buf[pos : pos + end[0]].tobytes().decode("latin-1", "replace")
        pos += int(end[0]) + 1
    if flg & 0x10:  # FCOMMENT
        end = np.flatnonzero(buf[pos:] == 0)
        if len(end) == 0:
            return None
        pos += int(end[0]) + 1
    if flg & 0x02:  # FHCRC
        if len(buf) < pos + 2:
            return None
        stored_hcrc = struct.unpack("<H", buf[pos : pos + 2].tobytes())[0]
        if header_crc16(buf[:pos]) != stored_hcrc:
            raise DataError("header crc mismatch")
        pos += 2
    return GzipHeader(pos, mtime, file_name)
