"""The host deflate engine: chunking, window carry, parallel chunks.

Counterpart of tpuzlib/codec/deflate_engine.py, its native route.  Each
chunk is tokenized with the previous 32 KiB as context and emitted as
adaptively split blocks, both in C (codec/emit_native.py); a chunk that
is not the stream's last ends with an empty stored block (a sync flush),
so every chunk boundary is byte-aligned and chunks concatenate.  Large
inputs compress their chunks on a process-wide thread pool, since the
native calls release the GIL.  tpuzlib's numpy route, which runs only
where its native library fails to load, has no counterpart: the port's
library is required.

The bytes depend on the core count: finish() splits what is pending
across the cores it may run on.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from .emit_native import emit_chunk_c, tokenize_full
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


CHUNK = 1 << 19  # input bytes compressed per pass
MIN_PARALLEL_CHUNK = 1 << 16  # smallest chunk worth a thread
HOLDBACK = 320  # bytes withheld during streaming so matches never lose
#                 lookahead at a chunk boundary (MAX_MATCH + hash margin)


class DeflateEngine:
    """Raw-DEFLATE compressor over appended chunks."""

    def __init__(self, level: int = 6, dictionary: np.ndarray | None = None):
        self.level = level
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

        Each chunk tokenizes with its 32 KiB halo of context and emits in
        C without the GIL; every result is byte-aligned (sync flush or
        final padding), so the pieces concatenate in stream order."""
        nchunks = -(-len(data) // chunk)
        spans = [(ci * chunk, min((ci + 1) * chunk, len(data))) for ci in range(nchunks)]

        def process_span(idx):
            lo, hi = spans[idx]
            ctx = self.window if lo == 0 else data[max(0, lo - WINDOW_SIZE):lo]
            buf = np.concatenate([ctx, data[lo:hi]]) if len(ctx) else data[lo:hi]
            is_last = last and idx == nchunks - 1
            litlen, dist, lf, df, soe = tokenize_full(buf, len(ctx), self.level)
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

    def _compress(self, chunk: np.ndarray, last: bool) -> np.ndarray:
        ctx = self.window
        data = np.concatenate([ctx, chunk]) if len(ctx) else chunk
        litlen, dist, lf, df, soe = tokenize_full(data, len(ctx), self.level)
        # sync flush on non-last chunks byte-aligns the boundary so a
        # following parallel batch can assume aligned starts
        out = emit_chunk_c(litlen, dist, lf, df, soe, chunk, last, not last)
        self.window = (
            np.concatenate([self.window, chunk])[-WINDOW_SIZE:]
            if len(chunk) < WINDOW_SIZE
            else chunk[-WINDOW_SIZE:].copy()
        )
        return out
