"""The host deflate engine: chunking, window carry, parallel chunks.

Counterpart of tpuzlib/codec/deflate_engine.py, both its routes.  Each
chunk is tokenized with the previous 32 KiB as context and emitted as
adaptively split blocks; a chunk that is not the stream's last ends with
an empty stored block (a sync flush), so every chunk boundary is
byte-aligned.  The native route tokenizes and emits in C
(codec/emit_native.py), and large inputs compress their chunks on a
process-wide thread pool, since the native calls release the GIL.  With
the native library switched off (native/bindings.set_native), the numpy
route runs where tpuzlib's does without its library: the vectorized
tokenizer (codec/lz77.py), blocks of at most BLOCK_SYMBOLS tokens each
emitted by deflate_blocks.emit_block_adaptive, the chunks of a large
input tokenized and emitted on the same pool and joined at the bit level
through the engine's BitSink.  The two routes give different bytes, each
tpuzlib's of its route.

The bytes depend on the core count: finish() splits what is pending
across the cores it may run on.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from ..native import bindings
from .bitsink import BitSink
from .deflate_blocks import emit_block, emit_block_adaptive, emit_stored
from .emit_native import emit_chunk_c, tokenize_full
from .lz77 import tokenize_chunk
from .tables import WINDOW_SIZE


def _ncores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover
        return os.cpu_count() or 1


_executor = None
_executor_lock = threading.Lock()


def get_executor():
    """Process-wide persistent thread pool for chunk compression.

    One pool sized to the available cores: threads (and therefore the
    native layer's per-thread match tables) are reused across pushes."""
    global _executor
    if _executor is None:
        with _executor_lock:
            if _executor is None:
                from concurrent.futures import ThreadPoolExecutor

                _executor = ThreadPoolExecutor(max_workers=_ncores())
    return _executor


# tokens per Huffman block of the numpy route (zlib flushes every 16K
# symbols; optimal package-merge trees amortize the header over more)
BLOCK_SYMBOLS = 1 << 16
CHUNK = 1 << 19  # input bytes compressed per pass
MIN_PARALLEL_CHUNK = 1 << 16  # smallest chunk worth a thread
HOLDBACK = 320  # bytes withheld during streaming so matches never lose
#                 lookahead at a chunk boundary (MAX_MATCH + hash margin)


class DeflateEngine:
    """Raw-DEFLATE compressor over appended chunks."""

    def __init__(self, level: int = 6, dictionary: np.ndarray | None = None):
        self.level = level
        self.sink = BitSink()  # the numpy route's bits not yet flushed
        # a preset dictionary keeps its last WINDOW_SIZE - 262 bytes (zlib's
        # MAX_DIST, w_size - MIN_LOOKAHEAD), as tpuzlib's engine does
        self.window = (
            dictionary[-(WINDOW_SIZE - 262):].astype(np.uint8)
            if dictionary is not None and len(dictionary)
            else np.empty(0, dtype=np.uint8)
        )
        self.pending = np.empty(0, dtype=np.uint8)

    def push(self, data: np.ndarray) -> np.ndarray:
        """Add input; returns whatever compressed bytes are ready."""
        if len(data):
            self.pending = (np.concatenate([self.pending, data]) if len(self.pending)
                            else data.copy())
        if len(self.pending) < CHUNK + HOLDBACK:
            return np.empty(0, dtype=np.uint8)
        n_process = ((len(self.pending) - HOLDBACK) // CHUNK) * CHUNK
        if n_process >= 2 * CHUNK:
            out = self._compress_parallel(self.pending[:n_process], last=False)
            self.pending = self.pending[n_process:]
            return out
        outs = []
        while len(self.pending) >= CHUNK + HOLDBACK:
            outs.append(self._compress(self.pending[:CHUNK], last=False))
            self.pending = self.pending[CHUNK:]
        return np.concatenate(outs) if outs else np.empty(0, dtype=np.uint8)

    def finish(self) -> np.ndarray:
        ncores = _ncores()
        if ncores > 1 and len(self.pending) > 4 * MIN_PARALLEL_CHUNK:
            # split across available cores (halo costs 32K per extra chunk,
            # so don't over-shard small inputs)
            chunk = min(CHUNK, max(MIN_PARALLEL_CHUNK * 2, -(-len(self.pending) // ncores)))
            out = self._compress_parallel(self.pending, last=True, chunk=chunk)
            self.pending = np.empty(0, dtype=np.uint8)
            return out
        outs = []
        while len(self.pending) > CHUNK:
            outs.append(self._compress(self.pending[:CHUNK], last=False))
            self.pending = self.pending[CHUNK:]
        outs.append(self._compress(self.pending, last=True))
        self.pending = np.empty(0, dtype=np.uint8)
        return np.concatenate(outs)

    def _compress_parallel(self, data: np.ndarray, last: bool, chunk: int = CHUNK) -> np.ndarray:
        """Thread-parallel chunk compression (one-shot / large appends).

        Each chunk tokenizes with its 32 KiB halo of context.  Natively it
        also emits in C without the GIL, and every result is byte-aligned
        (sync flush or final padding), so the pieces concatenate in stream
        order; the numpy route tokenizes and then emits the chunks on the
        pool, each into a BitSink of its own, and joins them in order."""
        nchunks = -(-len(data) // chunk)
        spans = [(ci * chunk, min((ci + 1) * chunk, len(data))) for ci in range(nchunks)]

        def with_context(lo, hi):
            ctx = self.window if lo == 0 else data[max(0, lo - WINDOW_SIZE):lo]
            return (np.concatenate([ctx, data[lo:hi]]) if len(ctx) else data[lo:hi]), len(ctx)

        if not bindings.native_available():
            return self._compress_parallel_numpy(data, last, spans, with_context)

        def process_span(idx):
            lo, hi = spans[idx]
            buf, ctx_len = with_context(lo, hi)
            is_last = last and idx == nchunks - 1
            litlen, dist, lf, df, soe = tokenize_full(buf, ctx_len, self.level)
            return emit_chunk_c(litlen, dist, lf, df, soe, data[lo:hi], is_last, not is_last)

        if nchunks == 1:
            pieces = [process_span(0)]
        else:
            # the first span runs on this thread: the caller would
            # otherwise idle while the pool works
            futs = [get_executor().submit(process_span, i) for i in range(1, nchunks)]
            pieces = [process_span(0)] + [f.result() for f in futs]
        self.window = data[-WINDOW_SIZE:].copy() if len(data) else self.window
        return np.concatenate(pieces)

    def _compress_parallel_numpy(self, data, last, spans, with_context) -> np.ndarray:
        """tpuzlib's numpy route of _compress_parallel."""
        nchunks = len(spans)

        def tokenize_span(span):
            buf, ctx_len = with_context(*span)
            return tokenize_chunk(buf, ctx_len, self.level)

        def emit_span(args):
            """One chunk's blocks in a bitstream of its own, byte-aligned
            at its end (_emit_tape), so a stored block inside any chunk
            stays aligned in the joined stream."""
            (lo, hi), (litlen, dist), is_last = args
            sink = BitSink()
            _emit_tape(sink, litlen, dist, data[lo:hi], is_last)
            return sink.flush(final=is_last)

        ex = get_executor()
        tapes = list(ex.map(tokenize_span, spans))
        jobs = [(spans[i], tapes[i], last and i == nchunks - 1) for i in range(nchunks)]
        flushed = list(ex.map(emit_span, jobs))

        # join the chunks' bitstreams in order through the engine's sink
        outs = []
        for body, rem_val, rem_bits in flushed:
            if len(body):
                self.sink.push_bytes(body)
            if rem_bits:
                self.sink.push_scalar(rem_val, rem_bits)
            piece, _, _ = self.sink.flush(final=False)
            if len(piece):
                outs.append(piece)
        final_piece, _, _ = self.sink.flush(final=last)
        if len(final_piece):
            outs.append(final_piece)
        self.window = data[-WINDOW_SIZE:].copy() if len(data) else self.window
        return np.concatenate(outs) if outs else np.empty(0, dtype=np.uint8)

    def _compress(self, chunk: np.ndarray, last: bool) -> np.ndarray:
        ctx = self.window
        data = np.concatenate([ctx, chunk]) if len(ctx) else chunk
        if bindings.native_available():
            litlen, dist, lf, df, soe = tokenize_full(data, len(ctx), self.level)
            # sync flush on non-last chunks byte-aligns the boundary so a
            # following parallel batch can assume aligned starts
            out = emit_chunk_c(litlen, dist, lf, df, soe, chunk, last, not last)
        else:
            litlen, dist = tokenize_chunk(data, len(ctx), self.level)
            _emit_tape(self.sink, litlen, dist, chunk, last)
            out, _, _ = self.sink.flush(final=last)
        self.window = (
            np.concatenate([self.window, chunk])[-WINDOW_SIZE:]
            if len(chunk) < WINDOW_SIZE
            else chunk[-WINDOW_SIZE:].copy()
        )
        return out


def _emit_tape(sink: BitSink, litlen: np.ndarray, dist: np.ndarray, raw: np.ndarray,
               last: bool) -> None:
    """The numpy route's blocks of one chunk's tape: BLOCK_SYMBOLS tokens
    a block, each split further by emit_block_adaptive; an empty tape
    still writes the final block where `last`.  A chunk that is not the
    last ends with an empty stored block (the Z_SYNC_FLUSH pattern), so
    the next one starts on a byte boundary."""
    if len(litlen) == 0:
        if last:
            emit_block(sink, np.empty(0, np.int32), np.empty(0, np.int32),
                       np.empty(0, np.uint8), True)
    else:
        ends = np.cumsum(np.where(dist > 0, litlen, 1).astype(np.int64))
        for lo in range(0, len(litlen), BLOCK_SYMBOLS):
            hi = min(lo + BLOCK_SYMBOLS, len(litlen))
            raw_lo = 0 if lo == 0 else int(ends[lo - 1])
            emit_block_adaptive(sink, litlen[lo:hi], dist[lo:hi],
                                raw[raw_lo:int(ends[hi - 1])], last and hi == len(litlen))
    if not last:
        emit_stored(sink, np.empty(0, np.uint8), False)  # sync flush
