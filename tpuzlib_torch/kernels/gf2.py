"""GF(2) linear algebra over 32-bit CRC state vectors (host, numpy).

Counterpart of tpuzlib/kernels/gf2.py, carried here because importing
anything from tpuzlib imports jax.  A 32x32 GF(2) matrix is stored as a
uint32 ndarray of shape (32,): ``mat[i]`` is the matrix applied to basis
vector ``e_i`` (column i, packed LSB-first into a uint32).  Matrix-vector
product = XOR of the columns selected by the bits of the vector.
"""

from __future__ import annotations

import numpy as np

_BITS32 = np.arange(32, dtype=np.uint32)


def identity() -> np.ndarray:
    return (np.uint32(1) << _BITS32).astype(np.uint32)


def apply(mat: np.ndarray, vec: int) -> int:
    """Apply 32x32 GF(2) matrix to a single packed vector."""
    v = np.uint32(vec)
    sel = (v >> _BITS32) & np.uint32(1)
    return int(np.bitwise_xor.reduce(np.where(sel.astype(bool), mat, np.uint32(0))))


def apply_many(mat: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """Apply matrix to an array of packed vectors (vectorized)."""
    v = vecs.astype(np.uint32)
    sel = ((v[:, None] >> _BITS32[None, :]) & np.uint32(1)).astype(bool)
    terms = np.where(sel, mat[None, :], np.uint32(0))
    return np.bitwise_xor.reduce(terms, axis=1)


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Compose: (a @ b)(v) == a(b(v))."""
    return apply_many(a, b)


def matpow(mat: np.ndarray, n: int) -> np.ndarray:
    """mat**n by square-and-multiply."""
    result = identity()
    base = mat.copy()
    while n:
        if n & 1:
            result = matmul(base, result)
        base = matmul(base, base)
        n >>= 1
    return result


def lookup_tables(mat: np.ndarray) -> np.ndarray:
    """Decompose matrix application into 4 byte-indexed XOR tables.

    Returns (4, 256) uint32 such that
    apply(mat, v) == t[0][v&255] ^ t[1][(v>>8)&255] ^ t[2][(v>>16)&255]
                   ^ t[3][v>>24]
    """
    t = np.zeros((4, 256), dtype=np.uint32)
    for s in range(4):
        vals = (np.arange(256, dtype=np.uint64) << np.uint64(8 * s)).astype(np.uint32)
        t[s] = apply_many(mat, vals)
    return t


def apply_tables(tables: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    v = vecs.astype(np.uint32)
    return (
        tables[0][v & 0xFF]
        ^ tables[1][(v >> np.uint32(8)) & 0xFF]
        ^ tables[2][(v >> np.uint32(16)) & 0xFF]
        ^ tables[3][v >> np.uint32(24)]
    )
