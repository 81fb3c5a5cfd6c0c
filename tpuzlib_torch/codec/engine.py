"""Streaming raw-DEFLATE decode engine (block layer) of the host.

Counterpart of tpuzlib/codec/engine.py.  Capability parity with
reference src/infblocks.ts (block FSM, 32 KiB window) — redesigned:
instead of a bit-level suspend/resume state machine, the engine keeps
unconsumed input buffered from the last committed bit position and
re-drives the vectorized tokenizer, which makes the engine resumable at
arbitrary byte granularity (the behavioral contract of reference
test/index.html:29-53 split-stream decoding).  The native serial decoder
(native/api.py) takes whole blocks first; it hands malformed data back
to the vectorized path, which gives the precise error message.  With the
native library switched off (native/bindings.set_native) the vectorized
path decodes every block, as tpuzlib's does without its library.

One deliberate difference from tpuzlib: while the library is switched
on, a failed build raises instead of leaving the vectorized path alone.
"""

from __future__ import annotations

import numpy as np

from ..native import api as native_api
from ..native import bindings
from . import tokenize
from .expand import expand_host
from .huffman import fixed_dist_lut, fixed_litlen_lut
from .tokenize import BitReader, DataError, NeedMoreInput, byte_windows64

MODE_HEADER = 0
MODE_STORED = 1
MODE_HUFFMAN = 2
MODE_DONE = 3

WINDOW = 1 << 15


class RawInflateEngine:
    """Chunk-streaming raw DEFLATE decoder producing bytes per push."""

    def __init__(self, dictionary: np.ndarray | None = None):
        self.size_hint = None  # decompressed-size hint (gzip ISIZE)
        self._nstream = None  # resumable native decoder state
        self._native_midblock = False
        self.buf = np.empty(0, dtype=np.uint8)
        self.bit_pos = 0
        self.mode = MODE_HEADER
        self.last = False
        self.stored_remaining = 0
        self.lut_lit = None
        self.lut_dist = None
        # inflate dictionaries clip to the last 32K-1 bytes (the largest
        # representable back-reference distance; inflate.ts:489-492)
        self.window = (
            dictionary[-(WINDOW - 1):].astype(np.uint8)
            if dictionary is not None and len(dictionary)
            else np.empty(0, dtype=np.uint8)
        )
        self.total_out = 0
        # adaptive segment size: sized from the previous block so the
        # vectorized decode rarely over-runs the end-of-block
        self._seg_hint = 1 << 16
        self._block_start_bit = 0

    @property
    def finished(self) -> bool:
        return self.mode == MODE_DONE

    def _try_native(self) -> np.ndarray | None:
        """Fast path: the C++ serial decoder handles whole blocks.

        Used whenever we are at a block boundary; incomplete trailing
        blocks stay buffered and are re-decoded (with the window carried
        as a dictionary) once more input arrives.  On malformed data we
        return None so the vectorized path reproduces the precise error
        message."""
        if self.mode != MODE_HEADER and not self._native_midblock:
            return None
        avail_bits = len(self.buf) * 8 - self.bit_pos
        if avail_bits < (1 << 12) and not self._native_midblock:
            return None
        if not bindings.native_available():
            return None
        if self._nstream is None:
            self._nstream = native_api.InflateStream()
        out, consumed, status = self._nstream.push(
            self.buf, self.bit_pos, self.window, size_hint=self.size_hint
        )
        if status == native_api.STATUS_DATA_ERROR:
            if self._native_midblock:
                # the vectorized path cannot re-enter mid-block; surface a
                # terminal error directly
                raise DataError("invalid compressed data")
            return None
        self._native_midblock = status == native_api.STATUS_NEED_MORE
        if status == native_api.STATUS_OK:
            self.mode = MODE_DONE
            self._native_midblock = False
        self.bit_pos = int(consumed)
        if len(out):
            self.total_out += len(out)
            self.window = (
                out[-WINDOW:].copy()
                if len(out) >= WINDOW
                else np.concatenate([self.window, out])[-WINDOW:]
            )
        if self.mode != MODE_DONE:
            drop = self.bit_pos >> 3
            if drop:
                self.buf = self.buf[drop:]
                self.bit_pos &= 7
        # `out` may view the decode buffer; returning the view avoids an
        # O(output) copy (the buffer holds at most 32K extra window bytes)
        return out if len(out) else np.empty(0, dtype=np.uint8)

    def set_dictionary(self, dictionary: np.ndarray) -> None:
        # 32K-1 clip: parity with inflate.ts:489-492
        self.window = dictionary[-(WINDOW - 1):].astype(np.uint8)

    def take_leftover(self) -> np.ndarray:
        """Bytes past the final block (container trailer etc.).  Only valid
        once finished; consumes them."""
        start = (self.bit_pos + 7) >> 3
        out = self.buf[start:]
        self.buf = np.empty(0, dtype=np.uint8)
        self.bit_pos = 0
        return out

    def push(self, data: np.ndarray | None) -> np.ndarray:
        """Feed more compressed bytes; returns newly decoded output."""
        if data is not None and len(data):
            self.buf = (
                np.concatenate([self.buf, data]) if len(self.buf) else data.copy()
            )
        out = self._try_native()
        if out is not None:
            return out
        token_chunks: list[tuple[np.ndarray, np.ndarray]] = []
        w64 = None
        avail_bits = len(self.buf) * 8

        while self.mode != MODE_DONE:
            if self.mode == MODE_HEADER:
                reader = BitReader(self.buf, self.bit_pos, avail_bits)
                try:
                    last = reader.bits(1)
                    btype = reader.bits(2)
                    if btype == 0:
                        reader.align_byte()
                        length = reader.bits(16)
                        nlen = reader.bits(16)
                        if length != (~nlen & 0xFFFF):
                            raise DataError("invalid stored block lengths")
                        self.stored_remaining = length
                        self.mode = MODE_STORED
                    elif btype == 1:
                        self.lut_lit = fixed_litlen_lut()
                        self.lut_dist = fixed_dist_lut()
                        self.mode = MODE_HUFFMAN
                    elif btype == 2:
                        self.lut_lit, self.lut_dist = tokenize.parse_dynamic_header(
                            reader
                        )
                        self.mode = MODE_HUFFMAN
                    else:
                        raise DataError("invalid block type")
                except NeedMoreInput:
                    break
                self.last = bool(last)
                self.bit_pos = reader.pos
                self._block_start_bit = reader.pos

            elif self.mode == MODE_STORED:
                byte_pos = self.bit_pos >> 3  # already aligned
                avail = len(self.buf) - byte_pos
                take = min(self.stored_remaining, avail)
                if take > 0:
                    chunk = self.buf[byte_pos : byte_pos + take]
                    token_chunks.append(
                        (chunk.astype(np.int32), np.zeros(take, dtype=np.int32))
                    )
                    self.bit_pos += take * 8
                    self.stored_remaining -= take
                if self.stored_remaining > 0:
                    break  # need more input
                self.mode = MODE_DONE if self.last else MODE_HEADER

            else:  # MODE_HUFFMAN
                if w64 is None:
                    w64 = byte_windows64(self.buf)
                litlen, dist, exit_kind, next_bit = tokenize.decode_segment(
                    w64,
                    self.bit_pos,
                    avail_bits,
                    self.lut_lit,
                    self.lut_dist,
                    self._seg_hint,
                )
                if len(litlen):
                    token_chunks.append((litlen, dist))
                self.bit_pos = next_bit
                if exit_kind == tokenize.EXIT_EOB:
                    block_bits = next_bit - self._block_start_bit
                    self._seg_hint = max(1 << 14, (block_bits * 5) >> 2)
                    self.mode = MODE_DONE if self.last else MODE_HEADER
                elif exit_kind == tokenize.EXIT_MORE:
                    break
                else:  # EXIT_SEGMENT: same block continues; widen the probe
                    self._seg_hint = min(self._seg_hint * 2, 1 << 22)

        # expand all tokens from this push against the window
        if token_chunks:
            litlen = np.concatenate([t[0] for t in token_chunks])
            dist = np.concatenate([t[1] for t in token_chunks])
            out = expand_host(litlen, dist, self.window)
            self.total_out += len(out)
            if len(out) >= WINDOW:
                self.window = out[-WINDOW:].copy()
            else:
                self.window = np.concatenate([self.window, out])[-WINDOW:]
        else:
            out = np.empty(0, dtype=np.uint8)

        # trim consumed whole bytes (keep buffer bounded in streaming use)
        if self.mode != MODE_DONE:
            drop = self.bit_pos >> 3
            if drop:
                self.buf = self.buf[drop:]
                self.bit_pos &= 7
        return out
