"""Adler-32 as data-parallel modular arithmetic.

Counterpart of tpuzlib/kernels/adler32.py.  For bytes x_0..x_{n-1} and
seed (s1_0, s2_0):

  s1 = (s1_0 + S) mod 65521,           S = sum x_i
  s2 = (s2_0 + n*s1_0 + W) mod 65521,  W = sum (n - i) * x_i

`adler32_host` is the native serial fold (the host engine's checksum).
`adler32_device` runs adler32_cuda.adler32_device_scalar on the input
tensor's device (one launch on a card: the per-2 KiB-block sums, their
combine and the seed finish) and reads one integer.
"""

from __future__ import annotations

import numpy as np

MOD = 65521
_MASK32 = 0xFFFFFFFF


def _split(seed: int):
    seed = int(seed) & _MASK32
    return seed & 0xFFFF, (seed >> 16) & 0xFFFF


def adler32_host(data: np.ndarray, seed: int = 1) -> int:
    """Adler-32 of a uint8 array by the native serial fold (tpuzlib's
    native branch; the port's native library is required)."""
    from ..native import bindings

    data = np.ascontiguousarray(data)
    return int(bindings.lib().tz_adler32(bindings.ptr(data), len(data), int(seed) & _MASK32))


def adler32_device(data, seed: int = 1) -> int:
    """Adler-32 of a 1-D uint8 tensor, computed on the tensor's device; the
    host reads one integer."""
    from .adler32_cuda import adler32_device_scalar

    return int(adler32_device_scalar(data, seed))


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """Adler of concat(A, B) from adler(A), adler(B), len(B)."""
    s1a, s2a = _split(adler1)
    s1b, s2b = _split(adler2)
    len2 %= MOD
    s1 = (s1a + s1b - 1) % MOD
    s2 = (s2a + s2b + len2 * (s1a - 1 + MOD)) % MOD
    return ((s2 << 16) | s1) & _MASK32
