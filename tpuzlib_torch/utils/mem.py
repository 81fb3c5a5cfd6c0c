"""Allocator tuning for hosts where a first-touch page fault is expensive.

Counterpart of tpuzlib/utils/mem.py, copied.  glibc malloc mmap()s every
allocation above 128 KiB and munmap()s it on free, so every large codec
buffer is faulted in again on every call.  tune_malloc() raises the mmap
threshold so large buffers come from the (never-returned) heap and are
faulted in once a process.  inflate() and deflate() call it first; set
TPUZLIB_MALLOC_TUNE=0 to disable it (tpuzlib's opt-out variable; the
port reads one other, TPUZLIB_TRACE, in utils/trace.py).
"""

from __future__ import annotations

import ctypes
import os

_done = False

# glibc mallopt parameter ids (malloc.h)
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def tune_malloc() -> bool:
    """Idempotent; returns True when the tuning is active."""
    global _done
    if _done:
        return True
    if os.environ.get("TPUZLIB_MALLOC_TUNE", "1") == "0":
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        # serve big allocations from the heap and never trim it back
        libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(_M_TRIM_THRESHOLD, 1 << 30)
        _done = True
        return True
    except Exception:  # pragma: no cover
        return False
