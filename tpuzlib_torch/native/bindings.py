"""Build and load the host library of the codec (ctypes).

`lib()` compiles tpuzlib_torch_native.cc with g++ on first use into
`_build/` next to this file, names the library by a hash of its source
and flags, and loads it (`_clib.Library`).  A failed build raises with
the compiler's output.  Counterpart of tpuzlib/native/bindings.py,
without `-march=native`, so the library loads on whichever host runs it.

One switch in code takes the place of tpuzlib's TPUZLIB_NO_NATIVE:
`set_native(False)` (or `testing.no_native()`) turns the library off, and
then `get_lib()` gives None and `native_available()` False, as tpuzlib's
do when its library is missing, and every call site takes tpuzlib's numpy
branch at tpuzlib's decision point.  While it is off, `lib()` raises, so
a site that ignores the switch fails instead of using the library.  While
it is on, `get_lib()` builds the library, and a failed build raises: the
port never switches itself off.  No environment variable is read.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .._clib import Library

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "tpuzlib_torch_native.cc")
_BUILD_DIR = os.path.join(_HERE, "_build")

FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_INT = ctypes.c_int
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_P = ctypes.c_void_p
_U32 = ctypes.c_uint32
_SIGNATURES = {
    "tz_state_new": (_P, []),
    "tz_state_free": (None, [_P]),
    # state, src, src_len, start_bit, dst, dst_cap, dict_len, *out_len,
    # *consumed_bits -> status (native/api.py STATUS_*)
    "tz_inflate_stream": (ctypes.c_int, [_P, _P, _I64, _I64, _P, _I64, _I64, _P, _P]),
    # the same from a fresh state: src, src_len, start_bit, dst, ...
    "tz_inflate_raw": (ctypes.c_int, [_P, _I64, _I64, _P, _I64, _I64, _P, _P]),
    # data, n, seed -> the checksum
    "tz_adler32": (_U32, [_P, _I64, _U32]),
    "tz_crc32": (_U32, [_P, _I64, _U32]),
    # src, src_len, start_bit, stop_bit, litlen, dist, cap, *end_bit,
    # *finished, *status
    "tz_inflate_tokenize": (_I64, [_P, _I64, _I64, _I64, _P, _P, _I64, _P, _P, _P]),
    # src, src_len, start_bit, litlens, nlit, distlens, ndist, litlen, dist,
    # cap, *end_bit, *hit_eob, *status
    "tz_tokenize_midblock": (_I64, [_P, _I64, _I64, _P, _I32, _P, _I32, _P, _P, _I64, _P, _P,
                                    _P]),
    # src, src_len, from_bit, allow_final, out_pos, cap
    "tz_find_headers": (_I64, [_P, _I64, _I64, _I32, _P, _I64]),
    # src, src_len, pos, n, out_pos
    "tz_confirm_headers": (_I64, [_P, _I64, _P, _I64, _P]),
    # litlen, dist, ntok, dst, dst_cap, dict_len
    "tz_expand_tokens": (_I64, [_P, _P, _I64, _P, _I64, _I64]),
    # src, src_len, limit_bits, allow_final, out_pos, cap
    "tz_header_candidates": (_I64, [_P, _I64, _I64, _I32, _P, _I64]),
    # litlen, dist, ntok -> output bytes
    "tz_tape_out_len": (_I64, [_P, _P, _I64]),
    # nseg, litlen pointers, dist pointers, ntok, seg_len, window, wlen, dst,
    # nthreads -> output bytes or -2
    "tz_expand_segments": (_I64, [_I32, _P, _P, _P, _P, _P, _I64, _P, _I32]),
    # data, total, ctx_len, max_chain, max_lazy, nice_len, lazy, litlen, dist,
    # lit_freq, dist_freq, stripe_out_end, stripe_tokens -> token count
    "tz_deflate_tokenize": (_I64, [_P, _I64, _I64, _INT, _INT, _INT, _INT, _P, _P, _P, _P, _P,
                                   _I64]),
    # litlen, dist, ntok, lit_freq, dist_freq, stripe_out_end, nstripes,
    # stripe_tokens, raw, raw_len, last, sync_flush, out, out_cap -> end bit
    "tz_emit_chunk": (_I64, [_P, _P, _I64, _P, _P, _P, _I64, _I64, _P, _I64, _INT, _INT, _P,
                             _I64]),
    # litlen, dist, ntok, ll, lcodes, dl, dcodes, out, out_cap, start_bit
    "tz_emit_tokens": (_I64, [_P, _P, _I64, _P, _P, _P, _P, _P, _I64, _I64]),
}

_LIBRARY = Library("tpuzlib_torch_native", lambda: "g++", FLAGS, lambda: [_SRC], _BUILD_DIR,
                   _SIGNATURES)
build = _LIBRARY.build  # the library's path, built first where needed
_enabled = True


def set_native(enabled: bool) -> bool:
    """Switch the native library on or off for the whole process; returns
    the state before the call."""
    global _enabled
    before, _enabled = _enabled, bool(enabled)
    return before


def get_lib():
    """The loaded library, built on first use, or None while it is
    switched off."""
    return _LIBRARY() if _enabled else None


def native_available() -> bool:
    """Whether the call sites take the native route (tpuzlib's test)."""
    return get_lib() is not None


def lib():
    """The loaded library, built on first use; raises while it is switched
    off."""
    if not _enabled:
        raise RuntimeError("the native library is switched off (bindings.set_native)")
    return _LIBRARY()


def ptr(a: np.ndarray) -> int:
    """Address of a C-contiguous array's first element, for a ctypes call
    (the caller keeps `a` alive across the call)."""
    if not a.flags.c_contiguous:
        raise ValueError("native calls take C-contiguous arrays")
    return a.ctypes.data


def out_scalars(*dtypes):
    """One-element arrays that a native call writes its scalar outputs to."""
    return tuple(np.zeros(1, dt) for dt in dtypes)
