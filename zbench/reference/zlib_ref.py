"""What the port's answers are judged by: Python's standard zlib module.

It imports no part of tpuzlib or tpuzlib_torch and takes nothing that the
port made but the answers it judges.  A configuration names its container
("raw", "deflate" for zlib, "gzip"), its level, window bits and memLevel
as zlib.h's deflateInit2 takes them.
"""

from __future__ import annotations

import zlib

import numpy as np


def wbits(config: dict) -> int:
    """zlib's windowBits for the configuration's container."""
    w = config["window_bits"]
    return {"raw": -w, "deflate": w, "gzip": 16 + w}[config["container"]]


def compress(data: np.ndarray, config: dict) -> bytes:
    """zlib's stream of `data` at the configuration's settings (a gzip
    header with MTIME 0 and no file name, as zlib writes it)."""
    c = zlib.compressobj(config["level"], zlib.DEFLATED, wbits(config), config["mem_level"])
    return c.compress(memoryview(data)) + c.flush()


def decodes_to(stream, config: dict, want: np.ndarray) -> bool:
    """Whether `stream` is one whole stream of the configuration's
    container that decodes to `want` exactly: header, every block, the
    trailer's checksum and length, and nothing after it."""
    d = zlib.decompressobj(wbits(config))
    try:
        got = d.decompress(memoryview(np.ascontiguousarray(stream))) + d.flush()
    except zlib.error:
        return False
    return d.eof and not d.unused_data and got == memoryview(want)


def equal(got, want: np.ndarray) -> bool:
    """Whether a decoded answer is `want`, byte for byte."""
    got = np.asarray(got)
    return got.dtype == np.uint8 and got.shape == want.shape and np.array_equal(got, want)


def crc32(data: np.ndarray) -> int:
    """The CRC-32 of zlib.crc32 (the IEEE 802.3 polynomial, as gzip and
    torch.save's records use)."""
    return zlib.crc32(memoryview(data))
