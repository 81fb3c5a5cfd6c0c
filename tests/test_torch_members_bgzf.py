"""inflate_members() on the CPU against a plain BGZF reader of its own
(tests/bgzf_plain.py: Python's zlib, no tpuzlib, no port kernel).

Both routes run here: inflate_members(device="cpu"), the host route (the
host engine a member at a time), and testing.members_device_route, the
device route as inflate_members() runs it on a card (the member plan, the
one batched decode, the splice and the CRC-32 of every member in their
plain versions, then the host engine for a member the route does not
prove).  Each input is given by its BSIZE fields and by an index of its
members' first bytes.  The verdicts of both routes are the host route's
ValueError: a flipped CRC or ISIZE byte, a cut last member, a BSIZE past
the end, trailing garbage, and a member whose first match reaches into
the member before it.  Both routes also give the bytes of tpuzlib's
decompress_members(verify=True), and refuse a flipped CRC-32 as it does.
crc32_segments_plain is held to zlib.crc32.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

import bgzf_plain
import tpuzlib_torch
from tpuzlib_torch import testing
from tpuzlib_torch.api import inflate_api
from tpuzlib_torch.kernels import inflate_members as im
from tpuzlib_torch.kernels.crc32_segments import crc32_segments_plain
from tpuzlib_torch.parallel.members import compress_members
from tpuzlib_torch.utils import trace

torch.set_num_threads(1)


def _records(n: int, seed: int) -> bytes:
    """n bytes of text with BAM-like repeats: read names, bases, qualities."""
    rng = np.random.default_rng(seed)
    out = []
    size = 0
    while size < n:
        name = b"A00%03d:8:H%05d:1:%d:%d:%d" % tuple(int(x) for x in rng.integers(0, 99999, 5))
        bases = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 150))
        quals = bytes(rng.choice(np.frombuffer(b"F:,#", np.uint8), 150, p=[.8, .15, .04, .01]))
        rec = name + b"\t" + bases + b"\t" + quals + b"\tNM:i:%d\n" % int(rng.integers(0, 5))
        out.append(rec)
        size += len(rec)
    return b"".join(out)[:n]


DATA = _records(200_000, 1)
WIRE, STARTS = bgzf_plain.write(DATA)


def _both(wire, index=None):
    """(host route, device route) of inflate_members on the CPU: each its
    bytes, or the ValueError it raised."""
    out = []
    for fn in (lambda: tpuzlib_torch.inflate_members(wire, index, device="cpu"),
               lambda: testing.members_device_route(wire, index)):
        try:
            out.append(bytes(fn()))
        except ValueError as e:
            out.append(e)
    return out


def _equal_verdicts(got):
    host, dev = got
    assert isinstance(host, ValueError) and isinstance(dev, ValueError), got
    assert str(host) == str(dev)
    return str(host)


@pytest.mark.parametrize("by", ["bsize", "index"])
def test_slice_by_bsize_and_by_index(by):
    index = STARTS if by == "index" else None
    before = trace.get_counters()
    host, dev = _both(np.frombuffer(WIRE, np.uint8), index)
    moved = testing.counters_since(before)
    assert host == dev == bgzf_plain.read(WIRE) == DATA
    assert len(STARTS) == 5  # four data members and the EOF member
    assert moved.get("inflate.members_card") == 5 and moved.get("inflate.members_host") == 5


@pytest.mark.parametrize("case", ["stored", "multi-block", "fixed", "index without BC"])
def test_member_kinds(case):
    rng = np.random.default_rng(2)
    if case == "stored":  # incompressible bytes: stored blocks
        data = rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes() + DATA[:30_000]
        wire, starts = bgzf_plain.write(data)
    elif case == "multi-block":  # sync flushes: three blocks and two markers a member
        data = DATA[:150_000]
        wire, starts = bgzf_plain.write(data, sync_every=20_000)
    elif case == "fixed":
        data = DATA[:100_000]
        wire, starts = bgzf_plain.write(data, strategy=zlib.Z_FIXED)
    else:  # plain gzip members with no BC subfield: only an index gives their sizes
        data = DATA
        wire, index = compress_members(np.frombuffer(data, np.uint8), member_size=60_000)
        host, dev = _both(wire, index)
        assert host == dev == data
        with pytest.raises(ValueError, match="does not fit"):
            tpuzlib_torch.inflate_members(wire, index[1:], device="cpu")
        assert bytes(tpuzlib_torch.inflate_members(wire, device="cpu")) == data  # in turn
        return
    assert bgzf_plain.read(wire) == data
    for index in (None, starts):
        before = trace.get_counters()
        host, dev = _both(wire, index)
        assert host == dev == data, case
        # the device route proved every member
        assert testing.counters_since(before).get("inflate.members_card") == len(starts)


def test_eof_member_alone_and_at_the_end():
    for wire in (bgzf_plain.EOF_MEMBER, bgzf_plain.EOF_MEMBER * 3,
                 bgzf_plain.member(b"abc") + bgzf_plain.EOF_MEMBER):
        host, dev = _both(wire)
        assert host == dev == bgzf_plain.read(wire)
    assert bytes(tpuzlib_torch.inflate_members(b"", device="cpu")) == b""


def _flip(wire: bytes, at: int) -> bytes:
    b = bytearray(wire)
    b[at] ^= 0x10
    return bytes(b)


def test_verdicts():
    second_end = STARTS[2]
    assert "integrity" in _equal_verdicts(_both(_flip(WIRE, second_end - 6)))  # CRC byte
    assert "size" in _equal_verdicts(_both(_flip(WIRE, second_end - 2)))  # ISIZE byte
    cut = WIRE[: STARTS[-1] - 3] + bgzf_plain.EOF_MEMBER[:0]
    assert "truncated" in _equal_verdicts(_both(cut))  # the last member cut
    past = bytearray(WIRE)
    struct.pack_into("<H", past, STARTS[-1] + 16, 40)  # the EOF member's BSIZE past the end
    assert "truncated" in _equal_verdicts(_both(bytes(past)))
    for garbage in (b"\x00" * 30, b"\x1f\x8b\x08\x04" + b"\x00" * 3):
        _equal_verdicts(_both(WIRE + garbage))
    # a flipped byte inside a member's deflate data
    _equal_verdicts(_both(_flip(WIRE, STARTS[1] + 5000)))
    # by index too: a member cut where the next index entry starts
    assert "Unexpected EOF" in _equal_verdicts(_both(WIRE[: STARTS[1] - 5] + WIRE[STARTS[1]:],
                                                     [0, STARTS[1] - 5]))


def test_a_match_into_the_previous_member_is_refused():
    """The crafted member's first token copies 3 bytes at distance 1: a
    decode that kept the previous member's bytes as its window would give
    three copies of that member's last byte and the trailer below, which
    says so; each member starts from an empty window, so both routes
    refuse it."""
    prev = DATA[:1000]
    lit = np.zeros(258, np.int64)
    lit[[97, 256, 257]] = [1, 2, 2]
    body = testing.dynamic_block(lit, [1], [(257, 0), (97, 0)]).tobytes()
    would_be = prev[-1:] * 3 + b"a"
    wire = bgzf_plain.member(prev) + bgzf_plain.frame(body, zlib.crc32(would_be), 4)
    wire += bgzf_plain.EOF_MEMBER
    assert "too far back" in _equal_verdicts(_both(wire))
    with pytest.raises(ValueError):
        bgzf_plain.read(wire)


def test_a_member_the_card_check_refuses_ends_on_the_host(monkeypatch):
    """A member whose check fails on the device route decodes again on the
    host engine alone; the others keep the device route's bytes."""
    real = inflate_api.check_members

    def one_refused(out, slices, members, device):
        ok = real(out, slices, members, device)
        ok[1] = False
        return ok

    monkeypatch.setattr(inflate_api, "check_members", one_refused)
    before = trace.get_counters()
    assert bytes(testing.members_device_route(WIRE)) == DATA
    moved = testing.counters_since(before)
    assert moved["inflate.members_card"] == 4 and moved["inflate.members_host"] == 1
    assert moved["inflate.device"] == len(DATA) - bgzf_plain.BLOCK


def test_route_rule(monkeypatch):
    view = np.frombuffer(WIRE, np.uint8)
    members = inflate_api.member_index(view)
    assert [m.start for m in members] == STARTS
    assert [(m.crc, m.isize) for m in members[:2]] == [
        (zlib.crc32(DATA[:bgzf_plain.BLOCK]), bgzf_plain.BLOCK),
        (zlib.crc32(DATA[bgzf_plain.BLOCK : 2 * bgzf_plain.BLOCK]), bgzf_plain.BLOCK)]
    applies = inflate_api.members_route_applies
    assert applies(view, members, "cuda") == (len(view) >= inflate_api.DEVICE_MIN_BYTES)
    big = np.zeros(inflate_api.DEVICE_MIN_BYTES, np.uint8)
    assert applies(big, members, "cuda") and not applies(big, members, "cpu")
    assert not applies(big, None, "cuda") and not applies(big[:-1], members, "cuda")

    def refused(*args, **kwargs):
        raise AssertionError("the host route decodes on the host")

    monkeypatch.setattr(inflate_api, "decode_members", refused)
    assert bytes(tpuzlib_torch.inflate_members(WIRE, device="cpu")) == DATA


@pytest.mark.parametrize("case", ["slice", "stored", "multi-block"])
@pytest.mark.parametrize("by", ["bsize", "index"])
def test_against_tpuzlib_decompress_members(case, by):
    """Both routes give tpuzlib's decompress_members(verify=True) bytes on
    the same wire, and both refuse, as it does, a member whose stored
    CRC-32 has a flipped bit."""
    from tpuzlib.parallel import members as jmembers

    if case == "slice":
        wire, starts = WIRE, STARTS
    elif case == "stored":
        rng = np.random.default_rng(3)
        wire, starts = bgzf_plain.write(rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes())
    else:
        wire, starts = bgzf_plain.write(DATA[:150_000], sync_every=20_000)
    index = starts if by == "index" else None
    want, _ = jmembers.decompress_members(wire, index, verify=True)
    assert _both(wire, index) == [bytes(want)] * 2
    bad = _flip(wire, starts[1] - 6)  # the first member's stored CRC-32
    with pytest.raises(ValueError, match="integrity"):
        jmembers.decompress_members(bad, index, verify=True)
    assert "integrity" in _equal_verdicts(_both(bad, index))


@pytest.mark.parametrize("n", [0, 1, 65280, 65536])
def test_crc32_segments_plain_is_zlib(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, 3 * n + 7, dtype=np.uint8)
    offs = [3, 3 + n, 3 + 2 * n, 3 + 2 * n, 3 + 3 * n]  # one segment empty
    got = crc32_segments_plain(torch.from_numpy(data), offs).numpy().view(np.uint32)
    want = [zlib.crc32(data[a:b].tobytes()) for a, b in zip(offs[:-1], offs[1:])]
    assert got.tolist() == want


def test_telemetry_names(monkeypatch):
    """With the telemetry on, the device route (taken on the CPU here)
    records the call's stages and counters under their names."""
    monkeypatch.setattr(inflate_api, "members_route_applies", lambda *a: True)
    was = trace.telemetry_enabled()
    trace.enable(True)
    trace.reset()
    before = trace.get_counters()
    try:
        assert bytes(tpuzlib_torch.inflate_members(WIRE, device="cpu")) == DATA
        stages = trace.get_telemetry()
    finally:
        trace.enable(was)
    moved = testing.counters_since(before)
    assert {"inflate.members", "inflate.members.index", "inflate.members.check",
            "inflate.plan", "inflate.tokenize_dispatch", "inflate.splice_pull",
            "inflate.comp_pull", "inflate.host_expand"} <= set(stages)
    assert stages["inflate.members"]["self_seconds"] < stages["inflate.members"]["seconds"]
    assert moved["inflate.members_card"] == 5 and moved["inflate.plan_blocks"] == 5
    assert moved["inflate.device"] == len(DATA)


def test_member_groups_and_stride():
    """Members split into groups where their blocks would pass half the
    cursor budget, each group one batch; the stride fits every block's
    cursors."""
    data = DATA[:6000]
    wire = b"".join(bgzf_plain.member(data[i : i + 2000]) for i in range(0, 6000, 2000))
    view = np.frombuffer(wire + bgzf_plain.EOF_MEMBER, np.uint8)
    members = inflate_api.member_index(view)
    plans = [im._member_plan(view, m) for m in members]
    assert im._groups(members, plans, 4) == [(0, 2), (2, 4)]
    assert im._groups(members, plans, 8192) == [(0, 4)]
    out, slices = im.decode_members(view, members, device="cpu", max_cursors=4)
    assert bytes(out) == data and [len(s) for s in slices] == [2000, 2000, 2000, 0]
    assert im._stride(sum(plans, []), 8192) == im.STRIDE_BITS
    # two blocks of ~5.4 Kbit and one cursor left over their first ones
    assert im._stride(sum(plans[:2], []), 3) == 1 << 14


def test_forced_repair_keeps_every_member():
    """The splice repair over all members' blocks (forced here) gives the
    same bytes; a member whose data breaks fails alone in it."""
    view = np.frombuffer(WIRE, np.uint8)
    members = inflate_api.member_index(view)
    out, slices = im.decode_members(view, members, device="cpu", force_repair=True)
    assert bytes(out) == DATA and all(s is not None for s in slices)
    bad = np.frombuffer(_flip(WIRE, STARTS[2] + 3000), np.uint8)
    out, slices = im.decode_members(bad, members, device="cpu", force_repair=True)
    ok = im.check_members(out, slices, members, "cpu")
    assert ok[:2] == [True, True] and ok[2] is False and ok[3:] == [True, True]


def _replay_segment(data: np.ndarray, base: int, lo: int, hi: int) -> int:
    """csrc/crc32_segments.cu's cut of one segment, replayed in numpy: the
    whole 128-byte pieces between the absolute boundaries at or before lo
    and hi (bytes before lo read as 0), 256 a round, each lane's pieces
    joined by A^(32 KiB) a round, the lanes by the tree, the tail folded
    alone and joined, the CRC finished."""
    from tpuzlib_torch.kernels.crc32 import _table8, powers

    table, pw = _table8(), powers()

    def apply(k, v):  # A^(2^k) v
        return int(np.bitwise_xor.reduce(pw[k] * ((v >> np.arange(32)) & 1).astype(np.uint32)))

    def shift_by(n, v):
        for k in range(int(n).bit_length()):
            if n >> k & 1:
                v = apply(k, v)
        return v

    def fold(r, block):
        for b in block.tolist():
            r = int(table[(r ^ b) & 0xFF]) ^ (r >> 8)
        return r

    g0, g1 = lo - (base + lo) % 128, hi - (base + hi) % 128
    pieces = (g1 - g0) // 128
    rounds = -(-pieces // 256)
    front = rounds * 256 - pieces
    masked = lambda a, b: np.where((np.arange(a, b) >= lo) & (np.arange(a, b) < g1),  # noqa: E731
                                   data[np.clip(np.arange(a, b), 0, len(data) - 1)], 0)
    acc = [0] * 256
    for r in range(rounds):
        for t in range(256):
            c = g0 + (r * 256 + t - front) * 128
            acc[t] = apply(15, acc[t]) ^ (fold(0, masked(c, c + 128)) if c + 128 > lo else 0)
    v = 0
    for t in range(256):  # the tree's order: lane t shifted by the lanes after it
        v = shift_by(128, v) ^ acc[t]
    tail = fold(0, np.where(np.arange(g1, hi) >= lo, data[np.clip(np.arange(g1, hi), 0, None)], 0))
    form = shift_by(hi - g1, v) ^ tail
    return form ^ shift_by(hi - lo, 0xFFFFFFFF) ^ 0xFFFFFFFF


@pytest.mark.parametrize("base", [0, 5, 77])
def test_crc32_segments_kernel_cut_replayed(base):
    """The card kernel's cut of a segment at absolute 128-byte boundaries,
    its rounds, empty front pieces, tree and tail, replayed on the host,
    is zlib's CRC-32 wherever the buffer starts."""
    data = np.random.default_rng(base).integers(0, 256, 80_000, dtype=np.uint8)
    for lo, hi in ((0, 0), (3, 3), (10, 11), (100, 300), (0, 128), (7, 65280 + 7),
                   (130, 33_000 + 130), (1, 70_001)):
        assert _replay_segment(data, base, lo, hi) == zlib.crc32(data[lo:hi].tobytes()), (lo, hi)


def test_without_the_native_library():
    """With the native library off the expansion and the host engine take
    their numpy branches: the same bytes, and the same refusal of a match
    into the member before."""
    prev = DATA[:1000]
    lit = np.zeros(258, np.int64)
    lit[[97, 256, 257]] = [1, 2, 2]
    body = testing.dynamic_block(lit, [1], [(257, 0), (97, 0)]).tobytes()
    crafted = bgzf_plain.member(prev) + bgzf_plain.frame(body, 0, 4) + bgzf_plain.EOF_MEMBER
    with testing.no_native():
        assert bytes(testing.members_device_route(WIRE[: STARTS[2]])) == DATA[: 2 * bgzf_plain.BLOCK]
        assert "too far back" in _equal_verdicts(_both(crafted))
