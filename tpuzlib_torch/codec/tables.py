"""RFC 1951 constants, the length and distance code maps, and the
per-level parse knobs.

Counterpart of tpuzlib/codec/tables.py (the length and distance bases,
the fixed trees, length_to_code / dist_to_code) and of TOO_FAR / LEVELS
in tpuzlib/codec/lz77.py.  The native host engine's levels are
native/api.NATIVE_LEVELS; a level here carries the numpy match search's
probes (codec/lz77.py) and the lazy rule, which the device encoder reads
too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

MIN_MATCH = 3
MAX_MATCH = 258
WINDOW_SIZE = 1 << 15

# Length codes 257..285 -> (base, extra bits)
LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51,
     59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int32,
)
LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
     4, 5, 5, 5, 5, 0],
    dtype=np.int32,
)

# Distance codes 0..29 -> (base, extra bits)
DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
     513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577],
    dtype=np.int32,
)
DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10,
     10, 11, 11, 12, 12, 13, 13],
    dtype=np.int32,
)

# Order in which code-length-code lengths are stored in a dynamic header
CLC_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int64,
)

# Fixed (static) Huffman tree code lengths per RFC 1951 §3.2.6
FIXED_LITLEN_LENGTHS = np.concatenate(
    [
        np.full(144, 8, dtype=np.int32),  # 0..143
        np.full(112, 9, dtype=np.int32),  # 144..255
        np.full(24, 7, dtype=np.int32),  # 256..279
        np.full(8, 8, dtype=np.int32),  # 280..287
    ]
)
# all 32 distance codes take part in the fixed tree; 30-31 are invalid
# if they ever appear in the stream (RFC 1951 §3.2.6)
FIXED_DIST_LENGTHS = np.full(32, 5, dtype=np.int32)

# Drop length-3 matches beyond this distance: with dist > ~128 a length-3
# match usually costs more bits than three literals.
TOO_FAR = 128


class LevelParams(NamedTuple):
    probes: tuple  # ((hash_bytes, K), ...): K candidates per hash length
    lazy: bool  # defer a match when the next position's match is longer
    max_lazy: int  # never defer matches at least this long


LEVELS = {
    1: LevelParams(probes=((3, 2), (4, 4)), lazy=False, max_lazy=4),
    2: LevelParams(probes=((3, 2), (4, 8)), lazy=False, max_lazy=5),
    3: LevelParams(probes=((3, 3), (4, 16)), lazy=False, max_lazy=6),
    4: LevelParams(probes=((3, 3), (4, 8), (6, 4)), lazy=True, max_lazy=6),
    5: LevelParams(probes=((3, 3), (4, 12), (6, 6)), lazy=True, max_lazy=16),
    6: LevelParams(probes=((3, 4), (4, 20), (6, 8)), lazy=True, max_lazy=32),
    7: LevelParams(probes=((3, 4), (4, 28), (6, 12)), lazy=True, max_lazy=64),
    8: LevelParams(probes=((3, 6), (4, 48), (6, 24), (8, 12)), lazy=True, max_lazy=258),
    9: LevelParams(probes=((3, 8), (4, 96), (6, 48), (8, 24)), lazy=True, max_lazy=258),
}


def length_to_code(length: np.ndarray) -> np.ndarray:
    """Match length (3..258) -> length code (257..285), vectorized."""
    return _LENGTH_CODE_LUT[np.asarray(length) - MIN_MATCH] + 257


def dist_to_code(dist: np.ndarray) -> np.ndarray:
    """Match distance (1..32768) -> distance code (0..29), vectorized."""
    d = np.asarray(dist)
    small = _DIST_CODE_LUT[np.minimum(d - 1, 255)]
    large = _DIST_CODE_LUT[256 + np.minimum((d - 1) >> 7, 255)]
    return np.where(d <= 256, small, large)


def _build_length_code_lut() -> np.ndarray:
    lut = np.zeros(256, dtype=np.int32)
    for code in range(29):
        base = LENGTH_BASE[code] - MIN_MATCH
        span = 1 << LENGTH_EXTRA[code]
        lut[base : base + span] = code
    lut[255] = 28  # length 258 -> code 285
    return lut


def _build_dist_code_lut() -> np.ndarray:
    # first 256 entries: dist-1 for dist 1..256; next 256: (dist-1)>>7 for larger
    lut = np.zeros(512, dtype=np.int32)
    for code in range(16):
        base = DIST_BASE[code] - 1
        span = 1 << DIST_EXTRA[code]
        lut[base : base + span] = code
    for code in range(16, 30):
        lo = (DIST_BASE[code] - 1) >> 7
        hi = (DIST_BASE[code] - 1 + (1 << DIST_EXTRA[code]) - 1) >> 7
        lut[256 + lo : 256 + hi + 1] = code
    return lut


_LENGTH_CODE_LUT = _build_length_code_lut()
_DIST_CODE_LUT = _build_dist_code_lut()
