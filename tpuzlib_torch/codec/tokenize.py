"""DEFLATE block headers: the bit reader and the dynamic-header parse.

Counterpart of the header half of tpuzlib/codec/tokenize.py (lines
25-166).  The port decodes symbols on the device (kernels/inflate_cuda.py)
and in the native host library (native/), so tpuzlib's numpy
candidate-at-every-bit decoder is not carried here.
"""

from __future__ import annotations

import numpy as np

from . import huffman
from .tables import CLC_ORDER


class NeedMoreInput(Exception):
    """Raised when the buffered input ends mid-structure."""


class DataError(ValueError):
    """Malformed DEFLATE data (parity with reference z.msg DATA_ERROR)."""


class BitReader:
    """Serial small-field reader for headers (cheap, per-block)."""

    def __init__(self, buf: np.ndarray, bit_pos: int, bit_end: int):
        self.buf = buf
        self.pos = bit_pos
        self.end = bit_end

    def bits(self, n: int) -> int:
        if self.pos + n > self.end:
            raise NeedMoreInput
        lo = self.pos >> 3
        hi = (self.pos + n + 7) >> 3
        chunk = int.from_bytes(self.buf[lo:hi].tobytes(), "little")
        val = (chunk >> (self.pos & 7)) & ((1 << n) - 1)
        self.pos += n
        return val

    def align_byte(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _parse_dynamic_rle(reader: BitReader):
    """Dynamic-header field + code-length RLE parse -> (hlit, lengths);
    raises on malformed headers.  Parity with reference
    src/infblocks.ts:334-523 (the DTREE states)."""
    hlit = reader.bits(5) + 257
    hdist = reader.bits(5) + 1
    hclen = reader.bits(4) + 4
    if hlit > 286 or hdist > 30:
        raise DataError("too many length or distance symbols")
    clc_lengths = np.zeros(19, dtype=np.int32)
    for i in range(hclen):
        clc_lengths[CLC_ORDER[i]] = reader.bits(3)
    try:
        clc_lut = huffman.build_lut(clc_lengths, "codelen")
    except huffman.TreeError:
        raise DataError("invalid code lengths set")

    lengths = np.zeros(hlit + hdist, dtype=np.int32)
    i = 0
    while i < hlit + hdist:
        # decode one code-length symbol: peek up to 7 bits (max CLC length)
        avail = reader.end - reader.pos
        peek_n = min(7, avail)
        lo = reader.pos >> 3
        hi = (reader.pos + peek_n + 7) >> 3
        chunk = int.from_bytes(reader.buf[lo:hi].tobytes(), "little")
        w = (chunk >> (reader.pos & 7)) & ((1 << peek_n) - 1)
        ent = int(clc_lut[w])
        if ent & huffman.INVALID:
            if avail < 7:
                raise NeedMoreInput
            raise DataError("invalid code lengths set")
        nb = (ent >> huffman.NB_SHIFT) & huffman.NB_MASK
        if nb > avail:
            raise NeedMoreInput
        sym = ent & huffman.VAL_MASK
        reader.pos += int(nb)
        if sym < 16:
            lengths[i] = sym
            i += 1
            continue
        if sym == 16:
            if i == 0:
                raise DataError("invalid bit length repeat")
            rep = 3 + reader.bits(2)
            fill = lengths[i - 1]
        elif sym == 17:
            rep = 3 + reader.bits(3)
            fill = 0
        else:  # sym == 18
            rep = 11 + reader.bits(7)
            fill = 0
        if i + rep > hlit + hdist:
            raise DataError("invalid bit length repeat")
        if fill:
            lengths[i : i + rep] = fill
        i += rep
    if lengths[256] == 0:
        raise DataError("invalid code -- missing end-of-block")
    return hlit, lengths


def parse_dynamic_lengths(reader: BitReader):
    """The VALIDATED (lit_lengths, dist_lengths) of a dynamic header."""
    hlit, lengths = _parse_dynamic_rle(reader)
    try:
        huffman.check_lengths(lengths[:hlit], "litlen")
        huffman.check_lengths(lengths[hlit:], "dist")
    except huffman.TreeError as e:
        raise DataError(str(e))
    return lengths[:hlit], lengths[hlit:]
