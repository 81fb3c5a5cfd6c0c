"""CRC-32 (poly 0xEDB88320) as data-parallel GF(2) linear algebra.

Counterpart of tpuzlib/kernels/crc32.py: its numpy constants, the host
combine tree and finish, `crc32_combine`, `crc32_host` (the host
engine's: the native slice-by-8 fold, or with the native library
switched off tpuzlib's numpy GF(2) fold of HOST_BLOCK-byte lanes and the
combine tree), and `crc32_device`, which runs
crc32_cuda.crc32_device_scalar on the input tensor's device.

The form L(data) of a run of bytes is the raw CRC register after folding
them from register 0, with no pre- or post-XOR:
r = T[(r ^ b) & 0xFF] ^ (r >> 8).  It is GF(2)-linear in the bytes, and
with A the raw-register propagation through one zero byte:

  fold_raw(r, data) = L(data) ^ A^n r        (n = len(data))
  L(a | b) = A^len(b) L(a) ^ L(b)            (blocks combine in a tree)
  L(zeros_k | data) = L(data)                (front padding is free)
"""

from __future__ import annotations

import functools

import numpy as np

from ..utils import trace
from . import gf2

POLY = np.uint32(0xEDB88320)
_MASK32 = 0xFFFFFFFF

HOST_BLOCK = 256  # bytes per lane of the numpy fold
DEVICE_BLOCK = 1024  # bytes per per-block form
TILE = 256  # blocks per span form
SPAN = DEVICE_BLOCK * TILE


@functools.lru_cache()
def _table8() -> np.ndarray:
    """Standard 256-entry CRC table (the table itself is a linear map on
    byte bits)."""
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> np.uint32(1)) ^ POLY, t >> np.uint32(1))
    return t


@functools.lru_cache()
def byte_shift_matrix() -> np.ndarray:
    """A: raw-register propagation through one zero data byte.

    r' = table[r & 0xFF] ^ (r >> 8)  — linear in r.
    """
    t = _table8()
    cols = np.zeros(32, dtype=np.uint32)
    for i in range(32):
        v = np.uint32(1) << np.uint32(i)
        cols[i] = t[int(v) & 0xFF] ^ np.uint32(int(v) >> 8)
    return cols


@functools.lru_cache(maxsize=256)
def shift_matrix(n_bytes: int) -> np.ndarray:
    """A^n: raw-register propagation through n zero data bytes."""
    return gf2.matpow(byte_shift_matrix(), n_bytes)


@functools.lru_cache()
def powers() -> np.ndarray:
    """A^(2^k) for k < 64 as packed columns, (64, 32): every shift matrix
    the device CRC applies is a product of these, A^n by the bits of n."""
    out = [byte_shift_matrix()]
    for _ in range(63):
        out.append(gf2.matmul(out[-1], out[-1]))
    return np.stack(out)


@functools.lru_cache(maxsize=64)
def _combine_tables(block: int, level: int) -> np.ndarray:
    """Byte-decomposed lookup tables for A^(block * 2^level)."""
    if level == 0:
        mat = shift_matrix(block)
    else:
        prev_mat = _combine_mat(block, level - 1)
        mat = gf2.matmul(prev_mat, prev_mat)
    return gf2.lookup_tables(mat)


@functools.lru_cache(maxsize=64)
def _combine_mat(block: int, level: int) -> np.ndarray:
    """A^(block * 2^level) as 32 packed columns."""
    if level == 0:
        return shift_matrix(block)
    prev = _combine_mat(block, level - 1)
    return gf2.matmul(prev, prev)


@functools.lru_cache()
def block_matrix_bits(block: int) -> np.ndarray:
    """M_B as an (8*B, 32) int8 bit matrix: L(block) = bits(block) @ M_B
    mod 2, the contract every forms kernel meets.

    Row (j*8 + i) is L(e) for the block with byte value (1 << i) at
    position j: equal to A^(B-1-j) applied to table[1 << i].
    """
    t = _table8()
    a = byte_shift_matrix()
    rows = np.zeros((block, 8), dtype=np.uint32)
    cur = t[(np.uint32(1) << np.arange(8, dtype=np.uint32)).astype(np.int64)]
    for k in range(block):
        rows[block - 1 - k] = cur
        if k + 1 < block:
            cur = gf2.apply_many(a, cur)
    packed = rows.reshape(block * 8)
    bits = ((packed[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1).astype(
        np.int8
    )
    return bits


@functools.lru_cache()
def plane_matrix_bits(block: int) -> np.ndarray:
    """block_matrix_bits(block) with its rows regrouped by bit plane: row
    i * block + j is row j * 8 + i (bit i of byte j), the K order of the
    tensor-core forms (tpuzlib builds it inline, crc32_pallas.py:44-46)."""
    m = block_matrix_bits(block)
    return np.concatenate([m[i::8] for i in range(8)])


def _fold_lanes(blocks: np.ndarray) -> np.ndarray:
    """Per-lane raw fold with zero seeds: G[b] = L(blocks[b]).

    Serial over block bytes, vectorized across lanes (the host analog of
    the device's forms)."""
    t = _table8()
    crc = np.zeros(blocks.shape[0], dtype=np.uint32)
    for j in range(blocks.shape[1]):
        crc = t[((crc ^ blocks[:, j]) & 0xFF).astype(np.int64)] ^ (crc >> np.uint32(8))
    return crc


def _combine_blocks(g: np.ndarray, block: int) -> int:
    """Fold per-block linear forms into L(data) via a log-depth tree.

    g[0] is the earliest block.  Pads at the FRONT with zeros (free in the
    raw domain)."""
    nb = len(g)
    if nb == 0:
        return 0
    size = 1 << max(0, (nb - 1).bit_length())
    if size != nb:
        g = np.concatenate([np.zeros(size - nb, dtype=np.uint32), g])
    level = 0
    while len(g) > 1:
        tables = _combine_tables(block, level)
        g = gf2.apply_tables(tables, g[0::2]) ^ g[1::2]
        level += 1
    return int(g[0])


def _finish(l_data: int, n: int, seed: int) -> int:
    raw_seed = (int(seed) & _MASK32) ^ _MASK32
    raw = l_data ^ gf2.apply(shift_matrix(n), raw_seed)
    return (raw ^ _MASK32) & _MASK32


def crc32_host(data: np.ndarray, seed: int = 0) -> int:
    """CRC-32 of a uint8 array: the native slice-by-8 fold, or with the
    library switched off the vectorized numpy GF(2) fold."""
    from ..native import bindings

    n = len(data)
    if n == 0:
        return int(seed) & _MASK32
    lib = bindings.get_lib()
    if lib is not None:
        data = np.ascontiguousarray(data)
        return int(lib.tz_crc32(bindings.ptr(data), n, int(seed) & _MASK32))
    block = min(HOST_BLOCK, max(8, n))
    pad = (-n) % block
    padded = np.concatenate([np.zeros(pad, dtype=np.uint8), data])
    blocks = padded.reshape(-1, block)
    g = _fold_lanes(blocks)
    l_data = _combine_blocks(g, block)
    return _finish(l_data, n, seed)


def crc32_device(data, seed: int = 0) -> int:
    """CRC-32 of a 1-D uint8 tensor, computed on the tensor's device.

    The forms, their tree and the seed finish all run there
    (crc32_cuda.crc32_device_scalar: one kernel launch on a card, its
    plain version on the CPU); the host reads one integer.  The checks and
    the launch run as the telemetry stage crc32.launch, with no span of its
    own (a second span would cost a share of the call under a profiler);
    the read counts as copy.d2h_bytes."""
    from .crc32_cuda import crc32_device_scalar

    with trace.timed_stage("crc32.launch", data, span=False):
        crc = crc32_device_scalar(data, seed)
    trace.count_copy("d2h", crc.device, crc)
    return int(crc)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of concat(A, B) from crc(A), crc(B), len(B)."""
    raw2 = (int(crc2) & _MASK32) ^ _MASK32
    shifted = gf2.apply(shift_matrix(len2), int(crc1) & _MASK32)
    return (shifted ^ raw2 ^ _MASK32) & _MASK32
