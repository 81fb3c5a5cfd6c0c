"""Concatenated gzip members, compressed and decompressed in host threads.

Counterpart of tpuzlib/parallel/members.py.  The RFC 1952 member
boundary is the codec's natural data-parallel seam: members compress and
decompress independently, outputs gather in order, and the whole
corpus's CRC-32 comes from the members' trailer CRCs through the GF(2)
combine (kernels/crc32.crc32_combine), with no payload byte read again.
verify=True checks that CRC against the output's, computed on `device`.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..api.checksums import crc32
from ..api.deflate_api import Deflater, DeflaterOptions
from ..common import mergeBuffers, u8_view
from ..containers.inflate_container import ContainerInflater
from ..kernels.crc32 import crc32_combine


def compress_members(data, level: int = 6, member_size: int = 4 << 20,
                     max_workers: int | None = None):
    """Compress into concatenated gzip members (one per shard) with the
    host Deflater.

    Returns (wire_bytes, member_index) where member_index[i] is the byte
    offset of member i in the output: the side channel that makes
    decompression embarrassingly parallel."""
    view = u8_view(data)
    nshards = max(1, -(-len(view) // member_size))
    spans = [(i * member_size, min((i + 1) * member_size, len(view))) for i in range(nshards)]

    def one(span):
        lo, hi = span
        d = Deflater(DeflaterOptions(format="gzip", level=level))
        return mergeBuffers(d.append(view[lo:hi]) + d.finish())

    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        members = list(ex.map(one, spans))
    index = np.zeros(nshards, dtype=np.int64)
    off = 0
    for i, m in enumerate(members):
        index[i] = off
        off += len(m)
    return mergeBuffers(members), index


def _decode_member(view: np.ndarray, offset: int):
    """Decode one gzip member; returns (out, end_offset, stored_crc)."""
    c = ContainerInflater(raw=False)
    out = c.push(view[offset:])
    if not c.is_complete:
        raise ValueError("truncated gzip member at offset %d" % offset)
    consumed = len(view) - offset - (len(c.header_buf) - c.trailer_len)
    return out, offset + consumed, c.stored_checksum


def decompress_members(data, index=None, max_workers: int | None = None, verify: bool = False,
                       *, device="cuda"):
    """Decompress concatenated gzip members on the host engine; in
    parallel when `index` is given.

    Returns (output_bytes, combined_crc32).  combined_crc32 is the CRC of
    the whole decompressed corpus, derived purely from the members'
    trailer CRCs and lengths via crc32_combine.  verify=True also computes
    the output's CRC-32 on `device` and raises on a difference."""
    view = u8_view(data)
    outs = []
    crcs = []
    if index is None:
        off = 0
        while off < len(view):
            out, off, crc = _decode_member(view, off)
            outs.append(out)
            crcs.append(crc)
    else:
        offsets = [int(o) for o in index]
        ends = offsets[1:] + [len(view)]

        def one(span):
            off, end = span
            out, _, crc = _decode_member(view[off:end], 0)
            return out, crc

        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            for out, crc in ex.map(one, zip(offsets, ends)):
                outs.append(out)
                crcs.append(crc)

    combined = 0
    for out, crc in zip(outs, crcs):
        combined = crc32_combine(combined, crc, len(out))
    result = mergeBuffers(outs)
    if verify and crc32(result, device=device) != combined:
        raise ValueError("Data integrity check failed")
    return result, combined
