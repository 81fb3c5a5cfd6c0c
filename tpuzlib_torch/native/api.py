"""numpy-friendly wrappers over the native library.

Counterpart of tpuzlib/native/api.py: the serial decoder (STATUS_*,
inflate_raw, InflateStream), the host engine's per-level tokenizer
settings (NATIVE_LEVELS) and the tokenizer's tape (tokenize).  The
library is built on first use (bindings.lib()): a failed build raises,
and so does a call while the library is switched off
(bindings.set_native), where the callers take their numpy branches.
"""

from __future__ import annotations

import weakref

import numpy as np

from . import bindings

# level -> (max_chain, max_lazy, nice_len, lazy); effort chosen so output
# is never larger than zlib's at the same level on the reference corpus
# (deeper chains than zlib's at equal level number)
NATIVE_LEVELS = {
    1: (8, 0, 16, 0),
    2: (16, 0, 32, 0),
    3: (32, 0, 64, 0),
    4: (32, 8, 64, 1),
    5: (64, 16, 128, 1),
    6: (48, 24, 96, 1),
    7: (512, 64, 258, 1),
    8: (1024, 258, 258, 1),
    9: (4096, 258, 258, 1),
}

STATUS_OK = 0
STATUS_NEED_MORE = 1
STATUS_DATA_ERROR = 2
STATUS_OVERFLOW = 3


def inflate_raw(
    data: np.ndarray,
    start_bit: int = 0,
    dictionary: np.ndarray | None = None,
    size_hint: int | None = None,
):
    """Serial native raw-DEFLATE decode.

    Returns (out_bytes, consumed_bits, status); status is STATUS_OK,
    STATUS_NEED_MORE (truncated; out contains what was decodable) or
    STATUS_DATA_ERROR.  Output capacity overflows RESUME from the
    persistent C state (no re-decode) via InflateStream.

    The inflate-side dictionary is clipped to the last 32K-1 bytes
    (reference src/inflate.ts:489-492)."""
    dict_arr = (
        np.ascontiguousarray(dictionary[-((1 << 15) - 1):])
        if dictionary is not None and len(dictionary)
        else np.empty(0, dtype=np.uint8)
    )
    stream = InflateStream()
    return stream.push(data, start_bit, dict_arr, size_hint=size_hint)


class InflateStream:
    """Resumable native decoder: Huffman tables + block mode persist in a
    C-side state so streaming appends continue mid-block at symbol
    granularity (the native analog of the reference's suspend/resume
    contract, infblocks.ts:164-179)."""

    def __init__(self):
        lib = bindings.lib()
        self._lib = lib
        self._ptr = lib.tz_state_new()
        self._finalizer = weakref.finalize(self, lib.tz_state_free, self._ptr)

    def push(
        self,
        data: np.ndarray,
        start_bit: int,
        window: np.ndarray,
        size_hint: int | None = None,
    ):
        """Decode from ``start_bit``; ``window`` preloads lookback context.

        On output-capacity overflow the decode RESUMES from the C state at
        the overflow bit position with a larger buffer (the already-decoded
        prefix is kept, never re-decoded — reference streaming-resume
        contract, infblocks.ts:164-179)."""
        data = np.ascontiguousarray(data)
        cap = max(size_hint or 0, 4 * len(data) + (1 << 16))
        bit = start_bit
        win = window
        pieces: list[np.ndarray] = []
        while True:
            wlen = len(win)
            dst = np.empty(wlen + cap, dtype=np.uint8)
            if wlen:
                dst[:wlen] = win
            out_len, consumed = bindings.out_scalars(np.int64, np.int64)
            status = self._lib.tz_inflate_stream(
                self._ptr, bindings.ptr(data), len(data), bit, bindings.ptr(dst), len(dst),
                wlen, bindings.ptr(out_len), bindings.ptr(consumed),
            )
            produced = dst[wlen : wlen + int(out_len[0])]
            if status == STATUS_OVERFLOW:
                # keep what was decoded, carry the last 32K as window, and
                # resume mid-block from the C state with a larger buffer
                pieces.append(produced.copy())
                win = dst[: wlen + int(out_len[0])][-(1 << 15):].copy()
                bit = int(consumed[0])
                cap *= 2
                continue
            if not pieces:
                return produced, int(consumed[0]), status
            pieces.append(produced)
            return np.concatenate(pieces), int(consumed[0]), status


def tokenize(data: np.ndarray, ctx_len: int, level: int):
    """Native hash-chain LZ77 tokenize of data[ctx_len:] after its context;
    returns the token tape (litlen, dist)."""
    from ..codec.emit_native import tokenize_full

    litlen, dist, _, _, _ = tokenize_full(data, ctx_len, level)
    return litlen, dist
