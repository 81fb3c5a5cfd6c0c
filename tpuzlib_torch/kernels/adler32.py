"""Adler-32 as data-parallel modular arithmetic.

Counterpart of tpuzlib/kernels/adler32.py.  For bytes x_0..x_{n-1} and
seed (s1_0, s2_0):

  s1 = (s1_0 + S) mod 65521,           S = sum x_i
  s2 = (s2_0 + n*s1_0 + W) mod 65521,  W = sum (n - i) * x_i

`adler32_host` computes S and W per 1 MiB block with float64 dot
products, which are exact because every partial sum stays below 2^53.
`adler32_device` takes them from the per-2 KiB-block sums of
adler32_cuda.py on the input tensor's device.
"""

from __future__ import annotations

import numpy as np

MOD = 65521
_MASK32 = 0xFFFFFFFF
_HOST_BLOCK = 1 << 20


def _split(seed: int):
    seed = int(seed) & _MASK32
    return seed & 0xFFFF, (seed >> 16) & 0xFFFF


def adler32_host(data: np.ndarray, seed: int = 1) -> int:
    s1_0, s2_0 = _split(seed)
    n = len(data)
    if n == 0:
        return ((s2_0 << 16) | s1_0) & _MASK32
    B = _HOST_BLOCK
    w = np.arange(B, 0, -1, dtype=np.float64)
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
    """Adler-32 of a 1-D uint8 tensor, with the block sums and their
    combine on the tensor's device."""
    from .adler32_cuda import BLOCK, adler32_blocks, adler32_totals

    n = data.numel()
    s1_0, s2_0 = _split(seed)
    if n == 0:
        return ((s2_0 << 16) | s1_0) & _MASK32
    s_total, w_total = adler32_totals(adler32_blocks(data, (-n) % BLOCK))
    s1 = (s1_0 + s_total) % MOD
    s2 = (s2_0 + (n % MOD) * s1_0 + w_total) % MOD
    return ((s2 << 16) | s1) & _MASK32


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """Adler of concat(A, B) from adler(A), adler(B), len(B)."""
    s1a, s2a = _split(adler1)
    s1b, s2b = _split(adler2)
    len2 %= MOD
    s1 = (s1a + s1b - 1) % MOD
    s2 = (s2a + s2b + len2 * (s1a - 1 + MOD)) % MOD
    return ((s2 << 16) | s1) & _MASK32
