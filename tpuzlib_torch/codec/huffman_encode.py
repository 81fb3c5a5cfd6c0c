"""Huffman encode side: optimal length-limited code lengths, canonical
codes, the dynamic header's code-length RLE, and token symbols.

A copy of tpuzlib/codec/huffman_encode.py, carried here because importing
anything from tpuzlib imports jax.  Code lengths come from the
package-merge algorithm, which gives optimal length-limited codes.  The
host engine builds its trees in C (native/tpuzlib_torch_native.cc,
package_merge_c and its neighbours, the same semantics); these are the
numpy versions that codec/deflate_blocks.py and codec/emit_native.py's
plain emit run.
"""

from __future__ import annotations

import numpy as np

from . import huffman
from .tables import DIST_BASE, DIST_EXTRA, LENGTH_BASE, LENGTH_EXTRA, dist_to_code, length_to_code


def package_merge(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal length-limited Huffman code lengths (package-merge).

    freqs: (nsym,) counts.  Returns (nsym,) lengths with 0 for unused
    symbols; all lengths <= max_len."""
    freqs = np.asarray(freqs, dtype=np.int64)
    used = np.flatnonzero(freqs > 0)
    n = len(used)
    lengths = np.zeros(len(freqs), dtype=np.int32)
    if n == 0:
        return lengths
    if n == 1:
        lengths[used[0]] = 1
        return lengths
    # Each item carries (weight, per-symbol membership counts); a symbol's
    # final code length = how many of the first 2n-2 items contain it.
    w = freqs[used]
    order = np.argsort(w, kind="stable")
    base_w = w[order]
    base_c = np.eye(n, dtype=np.int32)[order]
    items_w = base_w
    items_c = base_c
    for _ in range(max_len - 1):
        m = len(items_w) // 2
        pw = items_w[: 2 * m : 2] + items_w[1 : 2 * m : 2]
        pc = items_c[: 2 * m : 2] + items_c[1 : 2 * m : 2]
        items_w = np.concatenate([base_w, pw])
        items_c = np.concatenate([base_c, pc])
        srt = np.argsort(items_w, kind="stable")
        items_w = items_w[srt]
        items_c = items_c[srt]
    counts = items_c[: 2 * n - 2].sum(axis=0)
    lengths[used] = counts
    return lengths


def canonical_codes_lsb(lengths: np.ndarray) -> np.ndarray:
    """Canonical codes, bit-reversed ready for LSB-first stream writing."""
    codes = huffman.canonical_codes(lengths)
    used = lengths > 0
    rev = np.zeros_like(codes)
    rev[used] = huffman._bit_reverse(
        codes[used], np.asarray(lengths)[used]
    )
    return rev


def codelen_rle(lengths: np.ndarray):
    """RLE-encode code lengths with symbols 16/17/18 (RFC 1951 §3.2.7).

    Returns (symbols, extra_vals, extra_bits) arrays.  Runs of the
    previous length use 16 (3-6), zero runs use 17 (3-10) and 18
    (11-138)."""
    syms, extra_vals, extra_bits = [], [], []
    lengths = list(map(int, lengths))
    i = 0
    n = len(lengths)
    while i < n:
        cur = lengths[i]
        run = 1
        while i + run < n and lengths[i + run] == cur:
            run += 1
        if cur == 0:
            left = run
            while left >= 11:
                take = min(left, 138)
                syms.append(18)
                extra_vals.append(take - 11)
                extra_bits.append(7)
                left -= take
            while left >= 3:
                take = min(left, 10)
                syms.append(17)
                extra_vals.append(take - 3)
                extra_bits.append(3)
                left -= take
            for _ in range(left):
                syms.append(0)
                extra_vals.append(0)
                extra_bits.append(0)
        else:
            syms.append(cur)
            extra_vals.append(0)
            extra_bits.append(0)
            left = run - 1
            while left >= 3:
                take = min(left, 6)
                syms.append(16)
                extra_vals.append(take - 3)
                extra_bits.append(2)
                left -= take
            for _ in range(left):
                syms.append(cur)
                extra_vals.append(0)
                extra_bits.append(0)
        i += run
    return (
        np.array(syms, dtype=np.int32),
        np.array(extra_vals, dtype=np.int32),
        np.array(extra_bits, dtype=np.int32),
    )


def token_symbols(litlen: np.ndarray, dist: np.ndarray):
    """Token tape -> (litlen symbol, len extra val/bits, dist symbol,
    dist extra val/bits) arrays."""
    is_match = dist > 0
    lsym = np.where(is_match, length_to_code(np.maximum(litlen, 3)), litlen)
    lcode_idx = np.clip(lsym - 257, 0, 28)
    lext_bits = np.where(is_match, LENGTH_EXTRA[lcode_idx], 0)
    lext_val = np.where(is_match, litlen - LENGTH_BASE[lcode_idx], 0)
    dsym = np.where(is_match, dist_to_code(np.maximum(dist, 1)), 0)
    dext_bits = np.where(is_match, DIST_EXTRA[dsym], 0)
    dext_val = np.where(is_match, dist - DIST_BASE[dsym], 0)
    return lsym.astype(np.int32), lext_val, lext_bits, dsym, dext_val, dext_bits


def block_histograms(lsym: np.ndarray, dsym: np.ndarray, is_match: np.ndarray):
    lit_freq = np.bincount(lsym, minlength=286)[:286]
    lit_freq[256] += 1  # EOB
    if is_match.any():
        dist_freq = np.bincount(dsym[is_match], minlength=30)[:30]
    else:
        dist_freq = np.zeros(30, dtype=np.int64)
    return lit_freq.astype(np.int64), dist_freq.astype(np.int64)
