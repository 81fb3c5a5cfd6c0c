"""Device inflate of many gzip members at once: BGZF, the block gzip under
BAM, VCF.gz and tabix files, and any concatenation of members whose sizes
are known.

The port's own: tpuzlib decodes a concatenation of members only on host
threads (parallel/members.py).  `decode_members(buf, members, device=)`
takes the whole input and the member index (Member: where each member's
deflate data starts and where the member ends, from BGZF's BSIZE fields
or from a caller's index; api/inflate_api.member_index reads it) and
decodes the members with inflate_device2's pieces, in one batched decode
rather than a launch a member:

  plan        each member's blocks planned from its own first bit
              (_plan_blocks on its deflate data: the first header parsed
              at its known bit, a final block ending at the member's data
              end, and only a member of several blocks scanned for headers,
              within its own bytes), shifted to their bits in the input;
              one cursor layout over all of them (lay_cursors, layout),
              its stride adapted so the blocks of a group of members fit
              MAX_CURSORS; each block's first cursor is anchored;
  decode      one cursor_decode of a group (its table launch and its
              decode launch), one splice_compact and one meta pull; where
              the splice cannot prove the chain, one _repair_splice over
              all blocks, in which a block that would decline fails alone
              (and its member with it);
  walk        each member's blocks chained through their gaps
              (walk_blocks over the member's own bytes); a member whose
              final block does not end on its data's last byte fails;
  expand      one pull of the compacted tape, then each member expanded
              from an empty window into its place in one output buffer: a
              distance reaching before its member's first byte is a data
              error ("invalid distance too far back"), never a read of
              the member before it; that member fails.

A group holds as many members as keep its input under MAX_STREAM_BITS
and its blocks under half of MAX_CURSORS; a 32 MiB BGZF slice is one
group.  decode_members returns the output buffer and, per member, its
slice of it or None for a member the device path could not prove;
check_members then computes every decoded member's CRC-32 in one launch
(kernels/crc32_segments.py) and holds it and the length to the member's
trailer.  The caller decodes the failed members on the host engine.

Telemetry: the stages of decode_stream under their names (inflate.plan,
with the blocks planned counted as inflate.plan_blocks while the
telemetry is on; inflate.tokenize_dispatch, inflate.pre_splice,
inflate.splice_pull, inflate.repair_walk and inflate.compact where the
repair runs, inflate.token_splice for the walks, inflate.comp_pull,
inflate.host_expand), and check_members' inflate.members.check.
"""

from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch

from ..codec.expand import expand_host, tape_out_len
from ..codec.tokenize import DataError
from ..native import bindings
from ..utils import trace
from . import inflate_cuda
from .crc32_segments import crc32_segments
from .inflate_device2 import (MAX_CURSORS, MAX_STREAM_BITS, META_KCNT, STRIDE_BITS,
                              DeviceDeclined, _meta_vec, _plan_blocks, _repair_splice,
                              compact_bounds, fast_block_ends, flagged_rows, lay_cursors,
                              layout, splice_compact, walk_blocks)

TRAILER = 8  # a gzip member's CRC-32 and ISIZE


class Member(NamedTuple):
    """One gzip member of the input: bytes [start, end), its deflate data
    from `cdata` to end - 8, then its trailer's CRC-32 and ISIZE."""

    start: int
    cdata: int
    end: int
    crc: int
    isize: int


def _member_plan(buf: np.ndarray, m: Member):
    """Member m's blocks, their bits counted from its first byte, or None
    where its data does not plan."""
    plan = _plan_blocks(buf[m.cdata : m.end - TRAILER])
    if plan is None:
        return None
    o = 8 * (m.cdata - m.start)
    return [p._replace(header_bit=p.header_bit + o, data_start=p.data_start + o,
                       stop_bit=p.stop_bit + o) for p in plan]


def _groups(members: list, plans: list, max_cursors: int) -> list:
    """Runs [lo, hi) of the planned members, each within MAX_STREAM_BITS of
    input and half of max_cursors blocks."""
    limit = (MAX_STREAM_BITS >> 3) - 1
    groups, lo, blocks = [], None, 0
    for j, (m, plan) in enumerate(zip(members, plans)):
        if plan is None:
            continue
        if lo is not None and (m.end - members[lo].start > limit
                               or blocks + len(plan) > max_cursors // 2):
            groups.append((lo, j))
            lo = None
        if lo is None:
            lo, blocks = j, 0
        blocks += len(plan)
    if lo is not None:
        groups.append((lo, len(members)))
    return groups


def _stride(plan: list, max_cursors: int) -> int:
    """A power-of-two stride, at least STRIDE_BITS, at which every block's
    cursors fit max_cursors: the data bits over the cursors left after a
    cursor a block."""
    data_bits = sum(max(1, p.stop_bit - p.data_start) for p in plan)
    stride = max(STRIDE_BITS, -(-data_bits // max(1, max_cursors - len(plan))))
    return 1 << max(12, (stride - 1).bit_length())


def decode_members(buf: np.ndarray, members: list, *, device="cuda", max_cursors=None,
                   force_repair: bool = False):
    """The members' bytes by the batched device decode (module docstring):
    (out, slices), out one uint8 array of the decoded members back to back,
    slices[j] member j's part of it, or None where member j failed (it
    holds no byte of out).  force_repair: run the splice repair where the
    splice validated."""
    buf = np.ascontiguousarray(np.asarray(buf), dtype=np.uint8)
    max_cursors = MAX_CURSORS if max_cursors is None else max_cursors
    tapes: list = [None] * len(members)  # (litlen, dist) of each decoded member
    with trace.timed_stage("inflate.plan", buf):
        plans = []
        for m in members:
            too_big = m.end - m.start > (MAX_STREAM_BITS >> 3) - 1
            plans.append(None if too_big else _member_plan(buf, m))
        groups = _groups(members, plans, max_cursors)
    for lo, hi in groups:
        try:
            _decode_group(buf, members, plans, lo, hi, max_cursors, device, force_repair, tapes)
        except DeviceDeclined:
            pass  # the group's members fail: the caller decodes them on the host
    with trace.timed_stage("inflate.host_expand", buf):
        return _expand(tapes)


def _decode_group(buf, members, plans, lo, hi, max_cursors, device, force_repair,
                  tapes) -> None:
    """Decode members [lo, hi) (those with a plan) in one batch; puts each
    proved member's token tape into tapes[j]."""
    at = members[lo].start
    gbuf = buf[at : members[hi - 1].end]
    n_in = len(gbuf)
    with trace.timed_stage("inflate.plan", n_in):
        plan, first_block = [], {}
        for j in range(lo, hi):
            if plans[j] is not None:
                first_block[j] = len(plan)
                # the group's bits count from its first byte
                o = 8 * (members[j].start - at)
                plan += [p._replace(header_bit=p.header_bit + o, data_start=p.data_start + o,
                                    stop_bit=p.stop_bit + o) for p in plans[j]]
        if trace.telemetry_enabled():
            trace.count("inflate.plan_blocks", len(plan))
        stride = _stride(plan, max_cursors)
        cp = lay_cursors(plan, stride, max_cursors)
        if cp is None:
            raise DeviceDeclined("the members' blocks need more than %d cursors" % max_cursors)
        lay = layout(cp, stride)
    with trace.timed_stage("inflate.tokenize_dispatch", n_in):
        toks = inflate_cuda.cursor_decode(lay.decode_args(gbuf, device))
    with trace.timed_stage("inflate.pre_splice", toks):
        meta, comp, _ = splice_compact(toks, lay.stops, lay.bstart, lay.first, lay.last,
                                       lay.expect_eob, lay.active)
    with trace.timed_stage("inflate.splice_pull", meta):
        meta_np = meta.cpu().numpy()
        trace.count_copy("d2h", meta.device, meta)
    M = int(meta_np[1])
    kcnt_np = _meta_vec(meta_np, lay.Kpad, META_KCNT)[: lay.K]
    failed: set = set()
    bridge_ins: dict = {}
    if int(meta_np[0]) != 1 or force_repair:
        tok_pack, tok_bp = toks[0], toks[1]
        with trace.timed_stage("inflate.repair_walk", n_in):
            keep_lo, keep_hi, bridge_ins, block_end_bits = _repair_splice(
                gbuf, lay, meta_np, tok_bp, flagged_rows(tok_pack, lay.Kpad),
                max_bridges=max(64, len(plan)),
                max_row_batches=max(64, len(plan)), failed=failed)
        trace.count("inflate.splice_repair")
        with trace.timed_stage("inflate.compact", tok_pack):
            dev = tok_pack.device
            M_r, comp, kcnt = compact_bounds(tok_pack, torch.from_numpy(keep_lo).to(dev),
                                             torch.from_numpy(keep_hi).to(dev))
            trace.count_copy("h2d", dev, keep_lo, keep_hi)
            M = int(M_r)
            kcnt_np = kcnt.cpu().numpy()[: lay.K]
            trace.count_copy("d2h", dev, M_r, kcnt)
    else:
        block_end_bits = fast_block_ends(lay, meta_np)
    with trace.timed_stage("inflate.token_splice", n_in):
        cum = np.concatenate([[0], np.cumsum(kcnt_np, dtype=np.int64)])
        # cursors [kfirst[b], kfirst[b + 1]) are block b's
        kfirst = np.searchsorted(lay.block[: lay.K], np.arange(len(plan) + 1))
        pieces = {}
        for j, b0 in first_block.items():
            b1 = b0 + len(plans[j])
            if failed.intersection(range(b0, b1)):
                continue
            parts = _member_pieces(gbuf, members[j], at, lay.plan[b0:b1],
                                   block_end_bits[b0:b1], kfirst[b0 : b1 + 1], cum, bridge_ins)
            if parts is not None:
                pieces[j] = parts
    with trace.timed_stage("inflate.comp_pull", 4 * M):
        comph = comp[:M].cpu().numpy().view(np.uint32)
        trace.count_copy("d2h", comp.device, comph)
    with trace.timed_stage("inflate.host_expand", 4 * M):  # the tokens; _expand expands
        litlen = (comph & 0x1FF).astype(np.int32)
        dist = np.where((comph >> 25) & 1 == 1, (comph >> 9) & 0xFFFF, 0).astype(np.int32)
        for j, parts in pieces.items():
            got = [(litlen[p[0] : p[1]], dist[p[0] : p[1]]) if isinstance(p[0], int) else p
                   for p in parts]
            if len(got) == 1:
                tapes[j] = got[0]
            else:
                tapes[j] = (np.concatenate([g[0] for g in got]).astype(np.int32),
                            np.concatenate([g[1] for g in got]).astype(np.int32))


def _member_pieces(gbuf, m: Member, at: int, plan, ends, kfirst, cum, bridge_ins):
    """Member m's token tape as pieces in order: (lo, hi) ranges of the
    compacted tape, or (litlen, dist) arrays decoded on the host (its
    cursors' bridges, the tokens between its blocks, an open-ended
    tail); None where its blocks do not chain to its data's last byte."""
    data_end = m.end - TRAILER - at
    try:
        insertions, tail, end = walk_blocks(gbuf[:data_end], types.SimpleNamespace(plan=plan),
                                            ends)
    except DeviceDeclined:
        return None
    if (end + 7) // 8 != data_end:
        return None
    parts, lo = [], int(cum[kfirst[0]])
    for bi in range(len(plan)):
        for k in range(int(kfirst[bi]), int(kfirst[bi + 1])):
            if k in bridge_ins:
                parts += [(lo, int(cum[k + 1])), bridge_ins[k]]
                lo = int(cum[k + 1])
        if bi in insertions:
            hi = int(cum[kfirst[bi + 1]])
            parts += [(lo, hi), *insertions[bi]]
            lo = hi
    parts.append((lo, int(cum[kfirst[-1]])))
    if tail is not None:
        parts.append(tail)
    kept = [p for p in parts if not isinstance(p[0], int) or p[1] > p[0]]
    return kept or [(lo, lo)]


def _expand(tapes: list):
    """Each member's tape expanded from an empty window into its place in
    one buffer, back to back: (out, slices); a member whose distance
    reaches before its first byte fails (its slice None, no byte of
    out)."""
    lib = bindings.get_lib()
    tapes = [None if t is None else tuple(np.ascontiguousarray(a, dtype=np.int32) for a in t)
             for t in tapes]
    lens = [tape_out_len(*t) if t is not None else 0 for t in tapes]
    out = np.empty(sum(lens), np.uint8)
    slices: list = [None] * len(tapes)
    at = 0
    for j, (t, n) in enumerate(zip(tapes, lens)):
        if t is None:
            continue
        dst = out[at : at + n]
        if lib is not None:
            litlen, dist = t
            got = lib.tz_expand_tokens(bindings.ptr(litlen), bindings.ptr(dist), len(litlen),
                                       bindings.ptr(dst), n, 0) if n else 0
            ok = got == n
        else:
            try:
                dst[:] = expand_host(*t, np.empty(0, np.uint8))
                ok = True
            except DataError:
                ok = False
        if ok:  # else the next member takes its place
            slices[j] = dst
            at += n
    return out[:at], slices


def check_members(out: np.ndarray, slices: list, members: list, device) -> list:
    """Which decoded members hold to their trailers: each slice's length
    against its ISIZE (mod 2^32), and its CRC-32, all computed on `device`
    in one launch (crc32_segments) from one upload of `out` (counted as
    copy.h2d_bytes), queued from pinned memory ahead of the launch.
    Returns a bool a member, False for a failed one."""
    with trace.timed_stage("inflate.members.check", out):
        done = [j for j, s in enumerate(slices) if s is not None]
        ok = [False] * len(slices)
        if not done:
            return ok
        lens = np.array([len(slices[j]) for j in done], np.int64)
        bounds = np.concatenate([[0], np.cumsum(lens)])
        if torch.device(device).type == "cpu":
            data = torch.from_numpy(out)
        else:
            # from pinned memory without waiting: the card is still copying
            # when crc32_segments records its start event, so the event
            # fires as the copy ends and times the kernel, not the launch
            trace.count_copy("h2d", device, out)
            data = torch.from_numpy(out).pin_memory().to(device, non_blocking=True)
        crcs = crc32_segments(data, bounds).cpu().numpy().view(np.uint32)
        trace.count_copy("d2h", data.device, crcs)
        for i, j in enumerate(done):
            m = members[j]
            ok[j] = int(crcs[i]) == m.crc and int(lens[i]) & 0xFFFFFFFF == m.isize
        return ok
