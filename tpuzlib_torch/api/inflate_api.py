"""Public decompression API: Inflater / inflate().

Counterpart of tpuzlib/api/inflate_api.py.  `Inflater`, `InflaterOptions`
and `InflateResult` are tpuzlib's host objects, copied: option checks,
the chunked append loop on the host engine (containers/, codec/engine.py),
NEED_DICT handling and the finish() verdict, word for word.  Parity with
reference src/sd-inflate.ts: option validation (:60-80), append drive
loop (:87-153), NEED_DICT (:116-126), finish() verdict (:159-179),
one-shot inflate() with container auto-detect (:189-228).

inflate() takes tpuzlib's route rule, with its `device` in place of
tpuzlib's TPUZLIB_DEVICE switch, as deflate() does: on a CUDA device, a
gzip stream or a zlib stream without FDICT of at least DEVICE_MIN_BYTES
(tpuzlib's floor under its switch), given no dictionary, decodes by the
device route first (tpuzlib's `_inflate_device_oneshot`, the rule in
`device_route_applies`); every other stream (device="cpu", a raw stream,
a small one, one with FDICT or given a dictionary) goes straight to the
host route.  The rule is a route and not a fallback: an error of the
device route that is not a verdict on the data propagates.

The host route (tpuzlib's): on a host with at least
SPECULATIVE_MIN_CORES cores, a stream of at least SPECULATIVE_MIN_BYTES
decodes by the speculative segment-parallel decode
(parallel/speculative.py: the steps of inflate_parallel_container, its
DICTID and trailer checked on `device`, its bytes counted as
`inflate.speculative`); any other stream, and one whose speculative host
decode fails with an error that is not a ValueError (logged), decodes on
the host engine's Inflater.

The device route (_inflate_device, which testing.inflate_device_route
calls at any size and for raw streams too) decodes the stream on
`device`; its output is a host array (pass 3 on the host) and its
trailer checksum runs on `device`.  A malformed header and one cut short
leave the stream to the host route uncounted; a stream the device route
declines (DeviceDeclined, among them every stream of 2^29 bits or more),
a DataError from its decode and a trailer cut short are counted as
`inflate.device_fallback`; an output that fails its CRC-32, Adler-32 or
ISIZE as `inflate.device_mismatch_fallback`, and logged.  Each is decoded
again from the start on the host route, which renders tpuzlib's verdict
(its ValueError messages).  `inflate.device` counts the bytes the device
route returned.

The counters are utils/trace.py's, under tpuzlib's names (the port's own
`inflate.speculative` aside); the Inflater's appends run under the
`inflate.append` stage, as tpuzlib's do, and the device route's trailer
checksum under `inflate.checksum`.  The port's own stages: inflate()
runs inside `inflate.call`, with its input bytes; a device-route attempt
that ends in the host route (any of the four ways above) is recorded as
`inflate.declined`, its host seconds and input bytes (no span of its
own: the attempt's stages show in a trace).

inflate_members() is the port's own: the one-shot decode of a
concatenation of gzip members (BGZF: BAM, VCF.gz, tabix files), the
whole of it, where inflate() returns the first member as zlib and
tpuzlib do.  member_index reads each member's extent from its BGZF `BC`
subfield (BSIZE, the member's size less one) or from a caller's index
(parallel/members.compress_members'); it runs as the stage
inflate.members.index and raises the verdict on a member cut short, a
BSIZE past the end, and bytes after the last member that are not a
whole member.  The route rule is inflate()'s: the device route on a
CUDA `device` for an input of at least DEVICE_MIN_BYTES whose members'
sizes are all known (kernels/inflate_members.py: one batched decode of
all members, then every member's CRC-32 in one launch and its ISIZE);
every other input takes the host route, the host engine a member at a
time.  A member the device route cannot prove, or whose CRC-32 or
ISIZE fails on the card, decodes again on the host engine alone, whose
verdict stands; the other members keep the card's bytes.  The whole
call is the stage inflate.members; the counters inflate.members_card
and inflate.members_host count the members each route gave, and
inflate.device the bytes the device route gave.

Deliberate differences from tpuzlib: its catch-all fallbacks are kept
away from the card: that of the device route is not ported, and that of
the speculative route covers its host decode, not its checksums on
`device`; so a CUDA error, a kernel build error or an out-of-memory error
propagates.  The speculative dispatch's thresholds are module constants,
with no environment switch.
"""

from __future__ import annotations

import datetime
import logging
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..codec.deflate_engine import _ncores
from ..codec.tokenize import DataError
from ..common import mergeBuffers, u8_view
from ..containers.inflate_container import ContainerInflater, NeedDictionary
from ..kernels.inflate_device2 import DeviceDeclined, decode_stream
from ..kernels.inflate_members import TRAILER, Member, check_members, decode_members
from ..parallel.speculative import (check_dictionary, check_trailer, container_frame,
                                    inflate_parallel)
from ..utils import trace
from ..utils.mem import tune_malloc
from .checksums import adler32, crc32

# the host route decodes a stream of at least SPECULATIVE_MIN_BYTES with
# the speculative segment-parallel decode on a host with at least
# SPECULATIVE_MIN_CORES usable cores (tpuzlib's dispatch,
# tpuzlib/api/inflate_api.py:252-284; its TPUZLIB_SPECULATIVE switch is
# not ported).  On the 8-core host of an H100 80GB HBM3 the speculative
# decode of level-1 streams took 0.60x the Inflater's speed at 3.6 MB in,
# 0.81x at 7.5 MB, 1.43x at 12.7 MB and 1.62x at 16.3 MB
# (probes/speculative_breakdown.py), so tpuzlib's thresholds hold there.
SPECULATIVE_MIN_CORES = 8
SPECULATIVE_MIN_BYTES = 16 << 20
# the least input inflate() gives the device route on a CUDA device:
# tpuzlib's floor under TPUZLIB_DEVICE=1 (tpuzlib/api/inflate_api.py:177-178)
DEVICE_MIN_BYTES = 1 << 18


@dataclass
class InflateResult:
    """Parity with reference InflateResult (sd-inflate.ts:39-52)."""

    success: bool
    complete: bool
    checksum: str  # "match" | "mismatch" | "unchecked"
    fileSize: str  # "match" | "mismatch" | "unchecked"
    fileName: str
    modDate: Optional[datetime.datetime]


@dataclass
class InflaterOptions:
    """Parity with reference InflaterOptions (sd-inflate.ts:17-37)."""

    raw: bool = False
    dictionary: object = None


class Inflater:
    """Streaming decompression on the host engine: append() compressed
    chunks split at any byte, then finish() for the verdict."""

    def __init__(self, options: InflaterOptions | None = None, **kwargs):
        if options is None:
            options = InflaterOptions(**kwargs)
        elif kwargs:
            raise TypeError("pass either an options object or keyword options")
        raw = options.raw
        if raw is None:
            raw = False
        if not isinstance(raw, bool):
            raise TypeError("options.raw must be undefined or true or false")
        dictionary = options.dictionary
        if dictionary is not None:
            if raw:
                raise ValueError(
                    "options.dictionary cannot be set when options.raw is true"
                )
            try:
                dictionary = u8_view(dictionary)
            except TypeError:
                raise TypeError(
                    "options.dictionary must be undefined or a buffer or a buffer view"
                )
        self._container = ContainerInflater(raw, dictionary)
        self._finished = False
        self._total_in = 0

    @property
    def total_in(self) -> int:
        """Bytes consumed so far (ZStream.total_in parity)."""
        return self._total_in

    @property
    def total_out(self) -> int:
        """Decompressed bytes produced so far (ZStream.total_out)."""
        return self._container.total_out

    def append(self, data) -> list[np.ndarray]:
        """Feed a chunk of compressed data; returns decompressed buffers."""
        if self._finished:
            raise RuntimeError("Inflater instances cannot be reused")
        try:
            view = u8_view(data)
        except TypeError:
            raise TypeError("data must be an ArrayBuffer or buffer view")
        if self._container.is_complete and len(view):
            # the stream (incl. trailer) already ended: an append that
            # consumes nothing is an error (sd-inflate.ts:130-132)
            raise ValueError("inflate error: bad input data")
        self._total_in += len(view)
        try:
            with trace.timed_stage("inflate.append", len(view)):
                out = self._container.push(view)
        except NeedDictionary as nd:
            if nd.args[0] == "required":
                raise ValueError("Custom dictionary required for this data")
            raise ValueError("Custom dictionary is not valid for this data")
        except DataError as e:
            raise ValueError("inflate error: %s" % e)
        return [out] if len(out) else []

    def finish(self) -> InflateResult:
        """Verdict logic parity with sd-inflate.ts:159-179."""
        self._finished = True
        c = self._container
        stored_checksum = c.stored_checksum
        stored_size = c.stored_isize
        complete = c.is_complete
        checksum = (
            "unchecked"
            if stored_checksum == 0
            else ("match" if stored_checksum == c.output_checksum else "mismatch")
        )
        file_size = (
            "unchecked"
            if stored_size == 0
            else (
                "match"
                if stored_size == (c.total_out & 0xFFFFFFFF)
                else "mismatch"
            )
        )
        success = complete and checksum != "mismatch" and file_size != "mismatch"
        mod_date = (
            None
            if c.mtime == 0
            else datetime.datetime.fromtimestamp(c.mtime, datetime.timezone.utc)
        )
        return InflateResult(
            success=success,
            complete=complete,
            checksum=checksum,
            fileSize=file_size,
            fileName=c.file_name,
            modDate=mod_date,
        )


def _log_mismatch_fallback():
    logging.getLogger("tpuzlib_torch").warning(
        "device inflate produced a checksum mismatch; re-decoding on the "
        "host for the authoritative verdict"
    )


def _is_zlib(b0: int, b1: int) -> bool:
    """The detection rule: zlib only when the first byte is exactly 0x78."""
    return b0 == 0x78 and ((b0 << 8) + b1) % 31 == 0


def device_route_applies(input_: np.ndarray, dictionary, device) -> bool:
    """Whether inflate() takes the device route for `input_` (tpuzlib's
    rule under its switch): a CUDA `device`, no dictionary, at least
    DEVICE_MIN_BYTES, and a gzip stream or a zlib stream without FDICT."""
    if dictionary is not None or len(input_) < DEVICE_MIN_BYTES:
        return False
    if torch.device(device).type == "cpu":
        return False
    b0, b1 = int(input_[0]), int(input_[1])
    return (b0 == 0x1F and b1 == 0x8B) or (_is_zlib(b0, b1) and not b1 & 0x20)


def _inflate_device(input_: np.ndarray, device) -> np.ndarray | None:
    """The device route: the decoded bytes, or None where the host engine
    must decode the stream (see the module docstring for which streams,
    and which of them are counted).  A zlib stream with FDICT never comes
    here: device_route_applies keeps it on the host route.  An attempt
    that gives None is recorded as the stage inflate.declined."""
    with trace.pending_stage("inflate.declined", input_) as attempt:
        out = _device_attempt(input_, device)
        if out is None and attempt is not None:
            attempt.keep = True
    return out


def _device_attempt(input_: np.ndarray, device) -> np.ndarray | None:
    """_inflate_device's decode: the bytes, or None."""
    b0, b1 = int(input_[0]), int(input_[1])
    gzip = b0 == 0x1F and b1 == 0x8B
    header = ContainerInflater(raw=not (gzip or _is_zlib(b0, b1)))
    try:
        start = 0 if header.raw else header._parse_header(input_)
    except DataError:
        return None
    n_trailer = header.trailer_len
    if start is None or len(input_) < start + n_trailer:
        return None
    try:
        out, end = decode_stream(input_[start:], device=device)
    except (DeviceDeclined, DataError):
        trace.count("inflate.device_fallback")
        return None
    # the trailer starts at the first whole byte after the final block;
    # bytes after it are ignored (a second gzip member, trailing garbage)
    at = start + (end + 7) // 8
    if len(input_) < at + n_trailer:
        trace.count("inflate.device_fallback")
        return None
    trailer = input_[at : at + n_trailer].tobytes()
    with trace.timed_stage("inflate.checksum", len(out)):
        if gzip:
            stored_crc, isize = struct.unpack("<II", trailer)
            ok = crc32(out, device=device) == stored_crc and len(out) & 0xFFFFFFFF == isize
        elif n_trailer:
            ok = adler32(out, device=device) == struct.unpack(">I", trailer)[0]
        else:
            ok = True  # a raw stream carries no checksum
    if not ok:
        # a device-path mismatch cannot tell a corrupt stream from a fault
        # of the device path: the host engine settles it and gives the
        # verdict
        trace.count("inflate.device_mismatch_fallback")
        _log_mismatch_fallback()
        return None
    trace.count("inflate.device", len(out))
    return out


def speculative_applies(n_bytes: int) -> bool:
    """Whether the host route decodes a stream of n_bytes by the
    speculative decode on this host (tpuzlib's dispatch rule)."""
    return _ncores() >= SPECULATIVE_MIN_CORES and n_bytes >= SPECULATIVE_MIN_BYTES


class _HostFault(Exception):
    """A speculative host step failed with an error that is not a
    ValueError (logged): the Inflater decodes the stream instead."""


def _on_host(fn, *args, **kwargs):
    """fn(*args, **kwargs), a host step of the speculative route: a
    ValueError is the verdict and propagates (it carries tpuzlib's
    message), any other error is logged and becomes _HostFault."""
    try:
        return fn(*args, **kwargs)
    except ValueError:
        raise
    except Exception as e:
        logging.getLogger("tpuzlib_torch").warning(
            "speculative inflate failed (%s: %s); falling back to the sequential path",
            type(e).__name__, e)
        raise _HostFault from e


def _verdict(inflater: Inflater) -> None:
    """Raise the host route's ValueError for a finished Inflater whose
    stream fails."""
    result = inflater.finish()
    if not result.success:
        if not result.complete:
            raise ValueError("Unexpected EOF during decompression")
        if result.checksum == "mismatch":
            raise ValueError("Data integrity check failed")
        if result.fileSize == "mismatch":
            raise ValueError("Data size check failed")
        raise ValueError("Decompression error")


def _inflate_host(input_: np.ndarray, dictionary, device) -> np.ndarray:
    """tpuzlib's host route: the speculative segment-parallel decode of a
    large stream on a many-core host, else one Inflater over the whole
    input.  Only the speculative route's host steps fall back to the
    Inflater (_on_host); its DICTID and trailer checks on `device` do
    not, so an error of the card propagates."""
    if speculative_applies(len(input_)):
        try:
            frame = _on_host(container_frame, input_)
            check_dictionary(frame, dictionary, device)
            out = _on_host(inflate_parallel, input_[frame.start : frame.stop],
                           dictionary=dictionary)
            check_trailer(frame, out, device)
        except _HostFault:
            pass
        else:
            trace.count("inflate.speculative", len(out))
            return out
    method, flag = int(input_[0]), int(input_[1])
    gzip = method == 0x1F and flag == 0x8B
    inflater = Inflater(InflaterOptions(raw=not (gzip or _is_zlib(method, flag)),
                                        dictionary=dictionary))
    if gzip and len(input_) >= 18:
        # whole gzip stream in hand: the trailer ISIZE (mod 2^32) is an
        # exact allocation hint for the native decoder
        isize = struct.unpack("<I", input_[-4:].tobytes())[0]
        inflater._container.engine.size_hint = isize + 64
    buffers = inflater.append(input_)
    _verdict(inflater)
    return mergeBuffers(buffers)


def inflate(data, dictionary=None, *, device="cuda") -> np.ndarray:
    """One-shot decompress `data`, detecting its container: gzip (1F 8B),
    zlib (first byte exactly 0x78 with a valid header check), else raw
    DEFLATE.  Decodes on a CUDA `device` first where the route rule
    applies (device_route_applies), else, and where the device route does
    not give the verified bytes, on the host.  Returns the bytes as a
    uint8 array; raises tpuzlib's ValueError for bad data."""
    tune_malloc()  # large codec buffers must not be munmap'd per call
    input_ = u8_view(data)
    if len(input_) < 2:
        raise ValueError("data buffer is too small")
    with trace.timed_stage("inflate.call", input_):
        if device_route_applies(input_, dictionary, device):
            out = _inflate_device(input_, device)
            if out is not None:
                return out
        return _inflate_host(input_, dictionary, device)


# ---------------------------------------------------------------------------
# concatenated gzip members (BGZF)
# ---------------------------------------------------------------------------


def _u16(view: np.ndarray, at: int) -> int:
    return int(view[at]) | int(view[at + 1]) << 8


def _member_header(view: np.ndarray, at: int):
    """The gzip member header at byte `at`: (where its deflate data
    starts, its BGZF BSIZE or None).  Raises the host route's ValueError
    for a header that is cut short or is not a gzip member's (the
    container's own parse and checks)."""
    if len(view) - at >= 2 and (view[at] != 0x1F or view[at + 1] != 0x8B):
        raise ValueError("inflate error: not a gzip member at offset %d" % at)
    try:
        size = ContainerInflater(raw=False)._try_parse_gzip_header(view[at:])
    except DataError as e:
        raise ValueError("inflate error: %s" % e)
    if size is None:
        raise ValueError("truncated gzip member at offset %d" % at)
    bsize = None
    if view[at + 3] & 0x04:  # FEXTRA's subfields: SI1 SI2 SLEN data
        sub, end = at + 12, at + 12 + _u16(view, at + 10)
        while sub + 4 <= end:
            slen = _u16(view, sub + 2)
            if view[sub] == 66 and view[sub + 1] == 67 and slen == 2 and sub + 6 <= end:
                bsize = _u16(view, sub + 4)  # BC: the member's size less one
            sub += 4 + slen
    return at + size, bsize


def member_index(view: np.ndarray, index=None) -> list | None:
    """The members of `view` (Member: start, deflate data, end, the
    trailer's CRC-32 and ISIZE), from `index` (each member's first byte,
    the first 0, as compress_members returns it) or else from every
    member's BSIZE; None where a member's header has no BSIZE and no index
    is given (the sizes are then unknown).  Raises ValueError for a
    member cut short, a BSIZE past the end, an index that does not fit
    the input, and bytes after the last member that are not a whole
    member."""
    n = len(view)
    spans = []
    if index is not None:
        offs = np.asarray(index, dtype=np.int64).reshape(-1)
        if (not len(offs) or offs[0] != 0 or (np.diff(offs) <= 0).any() or offs[-1] >= n):
            raise ValueError("the member index does not fit the input's %d bytes" % n)
        for start, end in zip(offs.tolist(), offs[1:].tolist() + [n]):
            spans.append((start, _member_header(view[:end], start)[0], end))
    else:
        at = 0
        while at < n:
            cdata, bsize = _member_header(view, at)
            if bsize is None:
                return None
            end = at + bsize + 1
            if end > n:
                raise ValueError("truncated gzip member at offset %d" % at)
            spans.append((at, cdata, end))
            at = end
    for start, cdata, end in spans:
        if cdata + TRAILER > end:
            raise ValueError("truncated gzip member at offset %d" % start)
    ends = np.array([e for _, _, e in spans], np.int64)
    trailers = view[ends[:, None] - TRAILER + np.arange(TRAILER)].copy().view("<u4") \
        if len(spans) else np.zeros((0, 2), np.uint32)
    return [Member(s, c, e, int(t[0]), int(t[1]))
            for (s, c, e), t in zip(spans, trailers.tolist())]


def _host_member(view: np.ndarray, start: int, m: Member | None = None):
    """The member at byte `start` alone on the host engine, with its
    verdict (inflate()'s ValueErrors); where its index entry `m` is given,
    also one for bytes between its stream's end and m's end.  Returns its
    bytes and where it ends."""
    inflater = Inflater(InflaterOptions(raw=False))
    if m is not None:
        inflater._container.engine.size_hint = m.isize + 64
    buffers = inflater.append(view[start : None if m is None else m.end])
    _verdict(inflater)
    c = inflater._container
    extra = len(c.header_buf) - c.trailer_len
    if m is not None and extra:
        raise ValueError("the gzip member at offset %d ends %d bytes before its size says"
                         % (start, extra))
    return mergeBuffers(buffers), len(view) - extra if m is None else m.end


def _host_members_in_turn(view: np.ndarray) -> list:
    """Members whose sizes are unknown, on the host engine one after
    another, each from where the one before ended."""
    outs, at = [], 0
    while at < len(view):
        _member_header(view, at)
        out, at = _host_member(view, at)
        outs.append(out)
    return outs


def members_route_applies(view: np.ndarray, members, device) -> bool:
    """Whether inflate_members() takes the device route: a CUDA `device`,
    at least DEVICE_MIN_BYTES, and every member's size known."""
    return (members is not None and len(view) >= DEVICE_MIN_BYTES
            and torch.device(device).type == "cuda")


def inflate_members(data, index=None, *, device="cuda") -> np.ndarray:
    """One-shot decompress a concatenation of gzip members, all of them:
    BGZF (each member's size in its `BC` subfield, as BAM, VCF.gz and
    tabix files carry) or members whose first bytes `index` gives
    (compress_members' index).  Every member's CRC-32 and ISIZE is
    checked; the EOF member decodes to nothing.  Decodes on a CUDA
    `device` in one batched decode where the route rule applies
    (members_route_applies), else, and for each member the card does not
    prove, on the host engine.  Returns the bytes as one uint8 array;
    raises a ValueError for bad data."""
    tune_malloc()
    view = u8_view(data)
    with trace.timed_stage("inflate.members", view):
        with trace.timed_stage("inflate.members.index", view):
            members = member_index(view, index)
        return _inflate_members(view, members, device,
                                members_route_applies(view, members, device))


def _inflate_members(view: np.ndarray, members, device, device_route: bool) -> np.ndarray:
    """inflate_members' decode of the indexed `members` (None: sizes
    unknown), by the device route on `device` where device_route (which
    testing.members_device_route sets at any size, on the CPU too)."""
    if members is None:
        outs = _host_members_in_turn(view)
        trace.count("inflate.members_host", len(outs))
        return mergeBuffers(outs)
    ok, slices = [False] * len(members), [None] * len(members)
    if device_route:
        out, slices = decode_members(view, members, device=device)
        ok = check_members(out, slices, members, device)
        card = sum(ok)
        trace.count("inflate.members_card", card)
        trace.count("inflate.device", sum(len(s) for s, k in zip(slices, ok) if k))
        if card == len(members):
            return out
        if any(s is not None and not k for s, k in zip(slices, ok)):
            _log_mismatch_fallback()
    trace.count("inflate.members_host", len(members) - sum(ok))
    return mergeBuffers([slices[j] if ok[j] else _host_member(view, m.start, m)[0]
                         for j, m in enumerate(members)])
