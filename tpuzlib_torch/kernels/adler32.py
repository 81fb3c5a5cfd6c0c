"""Adler-32 as data-parallel modular arithmetic.

Counterpart of tpuzlib/kernels/adler32.py.  For bytes x_0..x_{n-1} and
seed (s1_0, s2_0):

  s1 = (s1_0 + S) mod 65521,           S = sum x_i
  s2 = (s2_0 + n*s1_0 + W) mod 65521,  W = sum (n - i) * x_i

`adler32_host` is the host engine's checksum: the native serial fold,
or with the native library switched off tpuzlib's numpy body (float64
BLAS dot products a 1 MiB block, exact below 2^53).
`adler32_device` runs adler32_cuda.adler32_device_scalar on the input
tensor's device (one launch on a card: the per-2 KiB-block sums, their
combine and the seed finish) and reads one integer.
"""

from __future__ import annotations

import numpy as np

from ..utils import trace

MOD = 65521
_MASK32 = 0xFFFFFFFF


def _split(seed: int):
    seed = int(seed) & _MASK32
    return seed & 0xFFFF, (seed >> 16) & 0xFFFF


_HOST_BLOCK = 1 << 20
_weights_cache: dict = {}


def _weights(b: int) -> np.ndarray:
    w = _weights_cache.get(b)
    if w is None:
        w = np.arange(b, 0, -1, dtype=np.float64)
        _weights_cache[b] = w
    return w


def adler32_host(data: np.ndarray, seed: int = 1) -> int:
    """Adler-32 of a uint8 array: the native serial fold, or with the
    library switched off vectorized numpy (BLAS float64 dot products per
    1 MiB block, exact because every partial sum stays below 2^53)."""
    from ..native import bindings

    lib = bindings.get_lib()
    if lib is not None and len(data):
        data = np.ascontiguousarray(data)
        return int(lib.tz_adler32(bindings.ptr(data), len(data), int(seed) & _MASK32))
    n = len(data)
    s1_0, s2_0 = _split(seed)
    if n == 0:
        return ((s2_0 << 16) | s1_0) & _MASK32
    B = _HOST_BLOCK
    w = _weights(B)
    s_total = 0
    w_total = 0
    for start in range(0, n, B):
        x = data[start : start + B]
        m = len(x)
        xf = x.astype(np.float64)
        s_c = int(xf.sum())
        # weight(i) = (m - i) + remaining_after, counted to stream end
        remaining_after = n - (start + m)
        w_c = int(np.dot(w[B - m :], xf)) + (remaining_after % MOD) * s_c
        s_total = (s_total + s_c) % MOD
        w_total = (w_total + w_c) % MOD
    s1 = (s1_0 + s_total) % MOD
    s2 = (s2_0 + (n % MOD) * s1_0 + w_total) % MOD
    return ((s2 << 16) | s1) & _MASK32


def adler32_device(data, seed: int = 1) -> int:
    """Adler-32 of a 1-D uint8 tensor, computed on the tensor's device; the
    host reads one integer (counted as copy.d2h_bytes)."""
    from .adler32_cuda import adler32_device_scalar

    adler = adler32_device_scalar(data, seed)
    trace.count_copy("d2h", adler.device, adler)
    return int(adler)


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """Adler of concat(A, B) from adler(A), adler(B), len(B)."""
    s1a, s2a = _split(adler1)
    s1b, s2b = _split(adler2)
    len2 %= MOD
    s1 = (s1a + s1b - 1) % MOD
    s2 = (s2a + s2b + len2 * (s1a - 1 + MOD)) % MOD
    return ((s2 << 16) | s1) & _MASK32
