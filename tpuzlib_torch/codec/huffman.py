"""Canonical Huffman code-length checks and the flat decode LUT.

Counterpart of tpuzlib/codec/huffman.py, carried here because importing
anything from tpuzlib imports jax.  The device decoder reads canonical
count tables (kernels/inflate_cuda.py) built from `_entry_fields`; the
flat LUT serves the code-length code of a dynamic header and the host
engine's vectorized decode (codec/engine.py, with the fixed-code LUTs).

Entry layout (uint32), shared by the LUT and the decoder's tables:
    bits  0..14  value: literal byte, length base, or distance base
    bits 15..18  Huffman code length in bits (1..15)
    bits 19..22  extra-bit count (0..13)
    bit  23      length-code flag (litlen only)
    bit  24      end-of-block flag
    bit  31      invalid-code flag
Unwritten LUT entries keep the invalid flag set.
"""

from __future__ import annotations

import numpy as np

from .tables import DIST_BASE, DIST_EXTRA, LENGTH_BASE, LENGTH_EXTRA

MAX_BITS = 15
LUT_SIZE = 1 << MAX_BITS

VAL_MASK = np.uint32(0x7FFF)
NB_SHIFT = np.uint32(15)
EB_SHIFT = np.uint32(19)
NB_MASK = np.uint32(0xF)
F_LEN = np.uint32(1 << 23)
F_EOB = np.uint32(1 << 24)
INVALID = np.uint32(1 << 31)


class TreeError(ValueError):
    """Invalid Huffman code-length set (over/under-subscribed)."""


def check_lengths(lengths: np.ndarray, kind: str) -> None:
    """Kraft-sum validation with zlib-compatible rules."""
    lengths = np.asarray(lengths)
    counts = np.bincount(lengths[lengths > 0], minlength=MAX_BITS + 1)
    ncodes = int(counts.sum())
    if ncodes == 0:
        if kind == "dist":
            return  # no distance codes is fine (literal-only block)
        raise TreeError("incomplete %s tree" % _tree_name(kind))
    kraft = int((counts[1:] * (1 << (MAX_BITS - np.arange(1, MAX_BITS + 1)))).sum())
    if kraft > LUT_SIZE:
        raise TreeError("oversubscribed %s tree" % _tree_name(kind))
    if kraft < LUT_SIZE:
        # zlib rule: incomplete sets are legal only with a single code, and
        # never for the code-length tree itself
        if ncodes == 1 and kind != "codelen":
            return
        raise TreeError("incomplete %s tree" % _tree_name(kind))


def _tree_name(kind: str) -> str:
    return {
        "litlen": "literal/length",
        "dist": "distance",
        "codelen": "code lengths",
    }[kind]


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical Huffman codes (MSB-first integers) per RFC 1951."""
    lengths = np.asarray(lengths, dtype=np.int64)
    counts = np.bincount(lengths[lengths > 0], minlength=MAX_BITS + 1).astype(np.int64)
    counts[0] = 0
    next_code = np.zeros(MAX_BITS + 1, dtype=np.int64)
    code = 0
    for b in range(1, MAX_BITS + 1):
        code = (code + counts[b - 1]) << 1
        next_code[b] = code
    # within each length, codes are assigned in symbol order
    order = np.argsort(lengths, kind="stable")
    sorted_lengths = lengths[order]
    firsts = np.searchsorted(sorted_lengths, sorted_lengths, side="left")
    ranks = np.arange(len(lengths)) - firsts
    codes = np.empty(len(lengths), dtype=np.int64)
    codes[order] = next_code[sorted_lengths] + ranks
    return codes.astype(np.uint32)


def _bit_reverse(values: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Reverse the low `nbits` bits of each value (codes are stored
    MSB-first but read LSB-first from the stream)."""
    v = values.astype(np.uint32)
    r = np.zeros_like(v)
    remaining = nbits.astype(np.int64).copy()
    for _ in range(MAX_BITS):
        active = remaining > 0
        r = np.where(active, (r << np.uint32(1)) | (v & np.uint32(1)), r)
        v = np.where(active, v >> np.uint32(1), v)
        remaining -= active.astype(np.int64)
    return r


def _entry_fields(syms: np.ndarray, kind: str) -> np.ndarray:
    """Per-symbol (value | extra | flags) payload of an entry."""
    ent = np.zeros(len(syms), dtype=np.uint32)
    if kind == "litlen":
        lit = syms < 256
        ent[lit] = syms[lit]
        eobm = syms == 256
        ent[eobm] = F_EOB
        lenm = (syms >= 257) & (syms <= 285)
        li = syms[lenm] - 257
        ent[lenm] = (
            LENGTH_BASE[li].astype(np.uint32)
            | (LENGTH_EXTRA[li].astype(np.uint32) << EB_SHIFT)
            | F_LEN
        )
        ent[syms > 285] = INVALID
    elif kind == "dist":
        valid = syms <= 29
        vi = syms[valid]
        ent[valid] = DIST_BASE[vi].astype(np.uint32) | (
            DIST_EXTRA[vi].astype(np.uint32) << EB_SHIFT
        )
        ent[~valid] = INVALID
    else:  # codelen: raw symbol value 0..18
        ent[:] = syms.astype(np.uint32)
    return ent


def build_lut(lengths: np.ndarray, kind: str) -> np.ndarray:
    """Build the flat 2^15-entry decode LUT for a code-length set.

    Index with the next 15 stream bits (LSB = first bit)."""
    check_lengths(lengths, kind)
    lengths = np.asarray(lengths, dtype=np.int64)
    lut = np.full(LUT_SIZE, INVALID, dtype=np.uint32)
    syms = np.flatnonzero(lengths > 0)
    if len(syms) == 0:
        return lut
    codes = canonical_codes(lengths)
    ls = lengths[syms]
    revs = _bit_reverse(codes[syms], ls)
    entries = _entry_fields(syms, kind) | (ls.astype(np.uint32) << NB_SHIFT)
    for l in range(1, MAX_BITS + 1):
        sel = ls == l
        if not sel.any():
            continue
        base = revs[sel].astype(np.int64)
        ent = entries[sel]
        reps = np.arange(1 << (MAX_BITS - l), dtype=np.int64) << l
        idx = (base[:, None] + reps[None, :]).reshape(-1)
        lut[idx] = np.repeat(ent, len(reps))
    return lut


_fixed_cache = {}


def fixed_litlen_lut() -> np.ndarray:
    if "lit" not in _fixed_cache:
        from .tables import FIXED_LITLEN_LENGTHS

        _fixed_cache["lit"] = build_lut(FIXED_LITLEN_LENGTHS, "litlen")
    return _fixed_cache["lit"]


def fixed_dist_lut() -> np.ndarray:
    if "dist" not in _fixed_cache:
        from .tables import FIXED_DIST_LENGTHS

        _fixed_cache["dist"] = build_lut(FIXED_DIST_LENGTHS, "dist")
    return _fixed_cache["dist"]
