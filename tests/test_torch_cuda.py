"""tpuzlib_torch's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA card.  The CPU
tests hold the plain versions to tpuzlib; these hold each kernel to its
plain version, on the same tensors on the card, at the sizes the main
path's full shapes never give it: lengths that are not a multiple of a
block, partial and odd-sized segments, the depth limits, one-token
chunks.  Every comparison is exact.  On a machine with a card (and no
JAX, which tests/conftest.py imports), from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import zlib

import numpy as np
import pytest
import torch

import tpuzlib_torch
from tpuzlib_torch import testing, tools
from tpuzlib_torch.kernels import _build, adler32_cuda, crc32_cuda, crc32_probe, inflate_cuda
from tpuzlib_torch.kernels import parse, screen
from tpuzlib_torch.kernels import deflate_device3 as d3
from tpuzlib_torch.kernels import inflate_device2 as d2
from tpuzlib_torch.kernels.deflate_device import segment_parse_xla
from tpuzlib_torch.utils import trace

pytestmark = pytest.mark.cuda

KB = 1 << 10
SPAN = 256 * KB
# byte lengths around the CRC block (1 KiB), the Adler block (2 KiB) and
# the CRC span (256 KiB)
RAGGED = [0, 1, 1023, 1025, 2047, 2049, SPAN - 1, SPAN, SPAN + 1, 3 * SPAN + 12345]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _launched(kernel, fn, times=1):
    """fn()'s result, checking that it launched `kernel` `times` times."""
    before = _build.LAUNCHES[kernel]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + times
    return out


def _screen_args(total, seed, dev):
    """Bytes, candidate floor and caps for `total` positions of
    low-entropy data, so that most positions have candidates."""
    rng = np.random.default_rng(seed)
    data = np.concatenate([rng.integers(0, 4, total // 2, dtype=np.uint8),
                           testing.corpus("text", total - total // 2, seed)])
    mincand = np.minimum(rng.integers(0, 300, total), np.arange(total)).astype(np.int32)
    lim16 = np.clip(total - np.arange(total), 0, 16).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (data, mincand, lim16))


def _near_equal(data, mincand, lim16, nd):
    got = _launched("near_screen", lambda: screen.near_screen(data, mincand, lim16, nd))
    want = screen.near_screen_plain(data, mincand, lim16, nd)
    assert torch.equal(got, want)
    return got


def _far_equal(data, best, rows, k):
    """Both versions over the probes' (sorted hash, permutation) rows in
    turn, each from its own copy of `best`, updated in place."""
    got, want = best.clone(), best.clone()
    for sh, perm in rows:
        assert _launched("far_screen", lambda: screen.far_screen(sh, perm, data, got, k)) is got
        screen.far_screen_plain(sh, perm, data, want, k)
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("nd", [1, 24, 64])
@pytest.mark.parametrize("total", [1, 255, 257, 5000, 5001])
def test_near_screen_kernel_matches_plain(dev, total, nd):
    _near_equal(*_screen_args(total, total + nd, dev), nd)


def _probe_rows(data, mincand, chid):
    ws = d3.window_words(data)
    return [d3.probe_rows(ws, mincand, chid, nbytes, bits) for nbytes, bits in d3.PROBES]


@pytest.mark.parametrize("k", [1, 6, 48, 64])
@pytest.mark.parametrize("total", [1, 255, 257, 5000, 5001])
def test_far_screen_kernel_matches_plain(dev, total, k):
    data, mincand, lim16 = _screen_args(total, total + k, dev)
    chid = (torch.arange(total, device=dev) >= total // 2).to(torch.int32)
    best = screen.near_screen_plain(data, mincand, lim16, 24)
    _far_equal(data, best, _probe_rows(data, mincand, chid), k)


def _offset(x, offset):
    """x as a view starting `offset` elements into a larger allocation."""
    buf = torch.zeros(x.numel() + offset, dtype=x.dtype, device=x.device)
    buf[offset:] = x
    return buf[offset:]


@pytest.mark.parametrize("case", ["all equal", "lim16 < 3", "mincand = p", "unaligned bytes",
                                  "R does not divide"])
@pytest.mark.parametrize("nd", [1, 24, 64])
def test_near_screen_kernel_edges(dev, case, nd):
    total = 3 * 1024 + 7  # not a multiple of any block's positions or of 4
    data, mincand, lim16 = _screen_args(total, nd, dev)
    pos = torch.arange(total, dtype=torch.int32, device=dev)
    if case == "all equal":
        data = torch.full_like(data, 9)
        mincand = torch.zeros_like(mincand)
    elif case == "lim16 < 3":
        lim16 = torch.remainder(pos, 3)
    elif case == "mincand = p":
        mincand = pos
    elif case == "unaligned bytes":
        data = _offset(data, 3)
    else:
        data, mincand, lim16 = data[:-2], mincand[:-2], lim16[:-2]
    got = _near_equal(data, mincand, lim16, nd)
    if case == "all equal":
        # a full screen at d = 1 for every position with 16 bytes left
        assert (got[1 : total - 16] == (16 << 16 | 0xFFFE)).all()
    if case in ("lim16 < 3", "mincand = p"):
        assert not got.any()


def _bucket(total, positions, dev):
    """(sorted hash, permutation) rows where `positions` share one hash and
    every other position has a hash of its own, as probe_rows makes them."""
    hc = (1 << 28) + torch.arange(total, dtype=torch.int32, device=dev)
    hc[torch.as_tensor(positions, device=dev)] = 5
    return torch.sort(hc, stable=True)


@pytest.mark.parametrize("case", ["all equal", "long bucket", "gaps of 32768", "16 at j = 1",
                                  "unaligned bytes", "tail"])
@pytest.mark.parametrize("k", [1, 6, 48, 64])
def test_far_screen_kernel_edges(dev, case, k):
    """The walk's exits (another hash, a gap over 32768, a 16-byte
    screen) and the windows that run past the end."""
    total = 70001
    rng = np.random.default_rng(k)
    data = torch.from_numpy(rng.integers(0, 256, total, dtype=np.uint8)).to(dev)
    best = torch.zeros(total, dtype=torch.int32, device=dev)
    chid = torch.zeros(total, dtype=torch.int32, device=dev)
    mincand = torch.zeros(total, dtype=torch.int32, device=dev)
    if case == "all equal":
        data = torch.full_like(data, 200)
        rows = _probe_rows(data, mincand, chid)
    elif case in ("long bucket", "unaligned bytes"):
        # 200 positions sharing a hash, 3 bytes of a pattern and then noise
        pos = np.sort(rng.choice(total - 32, 200, replace=False))
        for i, p in enumerate(pos):
            data[p : p + 3] = 77
            data[p + 3 : p + 3 + i % 14] = 78
        if case == "unaligned bytes":
            data = _offset(data, 1)
        rows = [_bucket(total, pos, dev)]
    elif case == "gaps of 32768":
        pos = [10, 20, 20 + 32768, 20 + 32768 + 32769, 20 + 2 * 32768 + 5]
        for p in pos:
            data[p : p + 20] = 33
        rows = [_bucket(total, pos, dev)]
    elif case == "16 at j = 1":
        pos = [100 * i for i in range(1, 300)]
        for i, p in enumerate(pos):
            data[p : p + 16] = 44
            data[p + 16] = i % 3  # runs of equal 17-byte screens
        rows = [_bucket(total, pos, dev)]
    else:
        # windows within 15 bytes of the end read zeros past it, though the
        # memory past it holds the same bytes as the last 40
        data = torch.cat([data, torch.full((64,), 5, dtype=torch.uint8, device=dev)])
        data[total - 40 :] = 5
        data = data[:total]
        pos = list(range(total - 40, total))
        rows = [_bucket(total, pos, dev)]
    got = _far_equal(data, best, rows, k)
    assert got.any()
    if case == "gaps of 32768":
        d = 0xFFFF - (got & 0xFFFF)
        assert int(d[20]) == 10 and int(d[20 + 32768]) == 32768
        assert int(got[20 + 32768 + 32769]) == 0  # its only candidate is 32769 back


@pytest.mark.parametrize("n,n_valid,seg", [
    (1, 1, 1024), (1023, 1000, 1024), (1025, 1025, 1024), (5000, 3333, 1024),
    (5000, 5000, 64), (20000, 19999, 8192),
])
def test_segment_parse_kernel_matches_plain(dev, n, n_valid, seg):
    rng = np.random.default_rng(n + seg)
    room = seg - np.arange(n) % seg
    step = np.minimum(np.where(rng.random(n) < 0.6, 1, rng.integers(3, 259, n)), room)
    step = torch.from_numpy(step.astype(np.int32)).to(dev)
    got = _launched("segment_parse", lambda: parse.segment_parse(step, n_valid, seg))
    assert got.dtype == torch.bool
    assert torch.equal(got, segment_parse_xla(step, n_valid, seg))


def _segment_tape(case, n, seg, seed):
    """A step tape of n positions whose steps end at or before their
    segment's end."""
    rng = np.random.default_rng(seed)
    room = seg - np.arange(n) % seg
    if case == "literals":  # every segment a walk of seg steps
        step = np.ones(n)
    elif case == "jumps over spans":  # steps of up to 258 over spans of seg / 32
        step = np.where(rng.random(n) < 0.2, 1, rng.integers(seg // 32 + 1, 259, n))
    elif case == "steps to the room left":
        step = np.where(rng.random(n) < 0.5, room, 1)
    else:
        step = np.where(rng.random(n) < 0.6, 1, rng.integers(3, 259, n))
    return np.minimum(step, room).astype(np.int32)


@pytest.mark.parametrize("case", ["literals", "jumps over spans", "steps to the room left", "mixed",
                                  "mixed, tape not 16-byte aligned"])
@pytest.mark.parametrize("seg", [1, 64, 1024, 8192])
def test_segment_parse_kernel_tapes(dev, case, seg):
    """n not a multiple of seg, and n_valid inside a segment."""
    n = 3 * seg + seg // 3 + 1
    n_valid = n - seg // 2 - 1
    step = torch.from_numpy(_segment_tape(case, n, seg, seg)).to(dev)
    if case.endswith("aligned"):
        step = _offset(step, 1)  # 4-byte loads and 1-byte stores
    got = _launched("segment_parse", lambda: parse.segment_parse(step, n_valid, seg))
    assert torch.equal(got, segment_parse_xla(step, n_valid, seg))
    if case == "literals":
        assert got[:n_valid].all() and not got[n_valid:].any()


def test_segment_parse_kernel_on_the_paths_tape(dev):
    """The encoder's own step tape for one small batch."""
    chunk, batch = 16 * KB, 4
    args = [torch.from_numpy(a).to(dev) for a in d3.batch_arrays(_mixed_stream(), range(batch),
                                                                 chunk, batch)]
    _, step, _ = d3.parse_tape(batch, d3.CTX, chunk, args[0], args[1], args[2], 6)
    step = step.reshape(-1).contiguous()
    got = _launched("segment_parse", lambda: parse.segment_parse(step, step.numel()))
    assert torch.equal(got, segment_parse_xla(step, step.numel()))


def _pack_on(dev, arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.parametrize("B,T", [(1, 1), (3, 1000), (2, 1001), (8, 4096)])
def test_pack_fields_kernel_matches_plain(dev, B, T):
    """pack_words (fields and words) on random tokens, every slot up to
    the last one a token."""
    rng = np.random.default_rng(B * T)
    litlen = rng.integers(0, 512, (B, T))
    is_match = rng.random((B, T)) < 0.5
    tok = litlen | (is_match << 9) | (rng.integers(0, 1 << 15, (B, T)) << 10)
    tok[:, ::7] = 256
    tok[:, 1::5] = 511
    lbits = rng.integers(0, 16, (B, 286))
    dbits = rng.integers(0, 16, (B, 30))
    lcodes = rng.integers(0, 1 << 15, (B, 286)) & ((1 << lbits) - 1)
    dcodes = rng.integers(0, 1 << 15, (B, 30)) & ((1 << dbits) - 1)
    hdr_bits = rng.integers(0, 15, (B, d3.HDRF))
    hdr_vals = rng.integers(0, 1 << 14, (B, d3.HDRF)) & ((1 << hdr_bits) - 1)
    args = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (tok, lcodes, lbits, dcodes, dbits)]
    args += _pack_on(dev, (np.full(B, T - 1, np.int64), hdr_vals.astype(np.int64),
                           hdr_bits.astype(np.int64), rng.integers(0, 2, B).astype(np.int32)))
    out_words = (48 * T + 15 * d3.HDRF) // 32 + 4
    got = _launched("pack_words", lambda: d3.pack_words(*args, out_words))
    for g, w in zip(got, d3.pack_words_plain(*args, out_words)):
        assert g.dtype == torch.int64 and torch.equal(g, w)


@pytest.mark.parametrize("case", sorted(testing.PACK_CASES))
def test_pack_words_kernel_cases(dev, case):
    """Rows whose EOB sits at the last slot, an empty row, lasts 0 and 1,
    a row past its output cap (its total_bits and ok equal, its words
    compared where ok, as the encoder's caller reads them), 48-bit fields
    and a row of two tiles."""
    arrays, out_words = testing.pack_words_inputs(case)
    args = _pack_on(dev, arrays)
    words, total_bits = _launched("pack_words", lambda: d3.pack_words(*args, out_words))
    want_words, want_total = d3.pack_words_plain(*args, out_words)
    assert torch.equal(total_bits, want_total)
    ok = total_bits <= out_words * 32 - 64
    assert torch.equal(words[ok], want_words[ok])
    if case == "past the output cap":
        assert not ok.all() and ok.any()


def _mixed_stream():
    return np.concatenate([
        testing.corpus("text", 30 * KB, 1), testing.corpus("runs", 20 * KB, 2),
        testing.corpus("random", 10 * KB, 3), testing.corpus("vertices", 20 * KB + 333, 4),
    ])


@pytest.mark.parametrize("level", [1, 9])
def test_encode_batch_on_card_matches_cpu(dev, level):
    """A small batch, with the partial last chunk and an empty row, through
    all four kernels."""
    chunk, batch = 16 * KB, 4
    args = d3.batch_arrays(_mixed_stream(), (0, 2, 5), chunk, batch)
    enc = d3.make_encode_batch_v3(level, chunk, batch, d3.out_words_for(chunk))
    cw, cb, cok = enc(*(torch.from_numpy(a) for a in args))
    _build.reset_launches()
    gw, gb, gok = (t.cpu() for t in enc(*(torch.from_numpy(a).to(dev) for a in args)))
    assert all(_build.LAUNCHES[k] for k in ("near_screen", "far_screen", "segment_parse", "pack_words"))
    assert torch.equal(gb, cb) and torch.equal(gok, cok)
    ok = cok.bool()
    assert ok.any() and torch.equal(gw[ok], cw[ok])


def test_deflate_and_stream_on_card(dev):
    """Inputs of one chunk (a batch of one) and none through deflate()'s
    device route (which deflate() takes from 1 MiB), and a stream whose
    window stays on the card."""
    data = _mixed_stream()
    for x in (data, data[:0]):
        before = _build.LAUNCHES["near_screen"]
        out = testing.device_route(x, device=dev, level=6)
        assert _build.LAUNCHES["near_screen"] > before or not len(x)
        assert zlib.decompress(out.tobytes()) == x.tobytes()

    def stream(device):
        d = tpuzlib_torch.DeviceDeflater(level=6, chunk=16 * KB, batch=2, device=device)
        parts = [d.append(data[a:b]) for a, b in ((0, 5000), (5000, 45000), (45000, 70000))]
        on_device = d._ctx.device.type
        parts.append(d.append(data[70000:]))
        parts.append(d.finish())
        return b"".join(p.tobytes() for p in parts), on_device

    wire, on_device = stream(dev)
    assert on_device == "cuda"
    assert wire == stream("cpu")[0]
    assert zlib.decompress(wire, -15) == data.tobytes()


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(300, dtype=torch.int32, device=dev)
    u = torch.zeros(300, dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError):
        screen.near_screen(x, x, x, 8)
    with pytest.raises(TypeError):
        screen.near_screen(u, x.long(), x, 8)
    with pytest.raises(ValueError):
        screen.near_screen(u, x, x, screen.MAX_DEPTH + 1)
    with pytest.raises(ValueError):
        screen.near_screen(u, x, x[:10], 8)
    with pytest.raises(ValueError):
        screen.near_screen(u, x.cpu(), x, 8)
    with pytest.raises(TypeError):
        screen.far_screen(x, x, u, x, 8)  # positions must be int64
    with pytest.raises(ValueError):
        screen.far_screen(x, x.long(), u, x[:10], 8)
    with pytest.raises(ValueError):
        screen.far_screen(x, x.long(), u, x, 0)
    with pytest.raises(ValueError):
        screen.far_screen(x, x.long(), u[::2], x[:150], 8)
    with pytest.raises(ValueError):
        parse.segment_parse(x[::2], 150)
    with pytest.raises(ValueError):
        parse.segment_parse(x, 300, seg=parse.MAX_SEG + 1)
    arrays, _ = testing.pack_words_inputs("empty row")
    pack = _pack_on(dev, arrays)
    with pytest.raises(ValueError):
        d3.pack_words(pack[0][:, :-1], *pack[1:], 8)
    with pytest.raises(TypeError):
        d3.pack_words(*pack[:5], pack[5].int(), *pack[6:], 8)
    with pytest.raises(ValueError):
        d3.pack_words(*pack, 0)
    b = torch.zeros(4096, dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError):
        crc32_cuda.crc32_forms(x, 0, 1)
    with pytest.raises(ValueError):
        crc32_cuda.crc32_forms(b[::2], 0, 1)
    with pytest.raises(ValueError):
        crc32_cuda.crc32_forms(b, 0, 256)
    with pytest.raises(ValueError):
        adler32_cuda.adler32_blocks(b[1:], 0)
    args = DECODE_CASES["one cursor"](dev)
    luts = inflate_cuda.decode_luts(args)
    for threads in (0, 48, 256):
        with pytest.raises(ValueError):
            inflate_cuda.cursor_decode(args, luts, threads)
    with pytest.raises(ValueError):
        inflate_cuda.cursor_decode(args, luts[:, :-1].contiguous())
    with pytest.raises(TypeError):
        inflate_cuda.cursor_decode(args, luts.long())


def test_far_screen_kernel_skips_positions_outside_the_batch(dev):
    """A permutation with two entries out of range reads no byte and
    writes no key outside the batch; every other row keeps its key."""
    total = 5000
    data, mincand, lim16 = _screen_args(total, 7, dev)
    data = torch.full_like(data, 3)  # every row of a bucket screens 16
    sh = torch.full((total,), 9, dtype=torch.int32, device=dev)
    sp = torch.arange(total, dtype=torch.int64, device=dev)
    sp[[100, 4000]] = torch.tensor([-5, total + 7], device=dev)
    guard = torch.zeros(total + 64, dtype=torch.int32, device=dev)
    best = guard[:total]
    _launched("far_screen", lambda: screen.far_screen(sh, sp, data, best, 6))
    assert not guard[total:].any()
    keep = torch.ones(total, dtype=torch.bool, device=dev)
    keep[[0, 100, 101, 4000, 4001]] = False  # no predecessor in range, or out of range
    keep[total - 15 :] = False  # windows that run past the end
    assert (best[keep] == (16 << 16 | 0xFFFE)).all()


def _bytes_at(n, offset, dev):
    """n seeded bytes on the card, as a view starting `offset` bytes into
    its allocation (offset 3: no load of the kernel is aligned)."""
    data = testing.mixed(n + 1, n)[:n]
    buf = torch.zeros(n + offset, dtype=torch.uint8, device=dev)
    buf[offset:] = torch.from_numpy(data).to(dev)
    return buf[offset:], data


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("tile", [1, 256])
@pytest.mark.parametrize("n", RAGGED)
def test_crc32_forms_kernel_matches_plain(dev, n, tile, offset):
    x, _ = _bytes_at(n, offset, dev)
    pad = (-n) % (KB * tile)
    name = "crc32_spans" if tile == 256 else "crc32_forms"
    got = _launched(name, lambda: crc32_cuda.crc32_forms(x, pad, tile), int(n > 0))
    assert got.dtype == torch.int32 and got.shape == ((n + pad) // (KB * tile),)
    assert torch.equal(got, crc32_cuda.crc32_forms_plain(x, pad, tile))


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("n", RAGGED)
def test_adler32_blocks_kernel_matches_plain(dev, n, offset):
    x, _ = _bytes_at(n, offset, dev)
    pad = (-n) % adler32_cuda.BLOCK
    got = _launched("adler32", lambda: adler32_cuda.adler32_blocks(x, pad), int(n > 0))
    assert got.dtype == torch.int32 and got.shape == ((n + pad) // adler32_cuda.BLOCK, 2)
    assert torch.equal(got, adler32_cuda.adler32_blocks_plain(x, pad))


def test_public_checksums_on_card(dev):
    """crc32 / adler32 of card tensors (at an odd offset) and of host
    buffers uploaded to the card, seeded and chained, against zlib."""
    for n in RAGGED:
        x, data = _bytes_at(n, 5, dev)
        b = data.tobytes()
        for seed in (0, 1, 0xDEADBEEF):
            assert tpuzlib_torch.crc32(x, seed) == zlib.crc32(b, seed)
            assert tpuzlib_torch.crc32(b, seed, device=dev) == zlib.crc32(b, seed)
            assert tpuzlib_torch.adler32(x, seed or 1) == zlib.adler32(b, seed or 1)
            assert tpuzlib_torch.adler32(data, seed or 1, device=dev) == zlib.adler32(b, seed or 1)
    x, data = _bytes_at(SPAN + 777, 1, dev)
    crc, adl = 0, 1
    for lo, hi in ((0, 1), (1, 1000), (1000, 1000), (1000, 5000), (5000, SPAN), (SPAN, SPAN + 700),
                   (SPAN + 700, SPAN + 777)):
        crc, adl = tpuzlib_torch.crc32(x[lo:hi], crc), tpuzlib_torch.adler32(x[lo:hi], adl)
    assert (crc, adl) == (zlib.crc32(data.tobytes()), zlib.adler32(data.tobytes()))


def _zlib_raw(data, level=6, strategy=zlib.Z_DEFAULT_STRATEGY):
    return np.frombuffer(testing.zlib_stream(data, level, -15, strategy), np.uint8)


def _decode_args(stream, dev, k=None, cap=None, keep=None, stride=1 << 12):
    """The decode's inputs on the card for the first k cursors (padded
    with inactive ones past the plan) of `stream`, planned whole; the
    stream's first `keep` bytes are what the cursors may read."""
    lay = d2.plan_cursors(stream, stride)
    k = lay.K if k is None else k
    pad = lambda a, fill: np.concatenate([a, np.full(max(0, k - len(a)), fill, a.dtype)])[:k]  # noqa: E731
    return inflate_cuda.prepare(
        stream[:keep], pad(lay.starts, -1), pad(lay.stops_dec, 0), pad(lay.block, 0), lay.plan,
        lay.stride_bits, 2 * d2.OVERLAP, cap or lay.cap, pad(lay.expect_eob, True), dev)


def _clamp_args(n, dev):
    """n cursors in block 0 of a level-6 stream, each allowed to decode to
    the end of its slice of nwp = 200 words: their last symbols are read
    from the word index clamped into the slice's last three words."""
    raw = _zlib_raw(testing.mixed(1 << 17, 9))
    plan = d2._plan_blocks(raw)
    starts = np.minimum(plan[0].data_start + 997 * np.arange(n), plan[0].stop_bit - 1)
    return inflate_cuda.prepare(raw, starts, np.full(n, 8 * len(raw)), np.zeros(n, np.int64),
                                plan, 1 << 12, 1 << 11, 2048, np.ones(n, bool), dev)


def _corrupted_fixed(dev):
    """Fixed blocks with 600 random bytes a third of the way in: the
    reserved codes (lit/len 286-287, distance 30-31) are soon reached."""
    buf = testing.inflate_streams()["fixed"][0]
    lay = d2.plan_cursors(buf, 1 << 13, 256)
    bad = buf.copy()
    bad[len(bad) // 3 : len(bad) // 3 + 600] = np.random.default_rng(2).integers(0, 256, 600)
    return lay.decode_args(bad, dev)


DECODE_CASES = {
    "one cursor": lambda dev: _decode_args(_zlib_raw(testing.corpus("text", 1 << 16, 1)), dev, k=1),
    "129 cursors": lambda dev: _decode_args(_zlib_raw(testing.mixed(1 << 19, 2)), dev, k=129),
    "stored only": lambda dev: _decode_args(_zlib_raw(testing.corpus("random", 1 << 16, 3)), dev),
    "fixed only": lambda dev: _decode_args(
        _zlib_raw(testing.mixed(1 << 17, 4), strategy=zlib.Z_FIXED), dev),
    "tape overflow": lambda dev: _decode_args(_zlib_raw(testing.mixed(1 << 17, 5)), dev, cap=40),
    "ends mid-symbol": lambda dev: _decode_args(_zlib_raw(testing.mixed(1 << 17, 6)), dev,
                                                keep=20001),
    "odd available bits": lambda dev: _decode_args(_zlib_raw(testing.mixed(1 << 17, 7), 9), dev,
                                                   keep=33333),
    "15-bit codes, zlib": lambda dev: _decode_args(np.frombuffer(testing.zlib_stream(
        testing.fibonacci_bytes(), 9, -15, zlib.Z_HUFFMAN_ONLY), np.uint8), dev),
    "15-bit codes, hand-made": lambda dev: _decode_args(
        testing.hand_made_blocks()["15-bit codes"], dev),
    "one-bit distance code": lambda dev: _decode_args(
        testing.hand_made_blocks()["one-bit distance code"], dev),
    "corrupted": _corrupted_fixed,
    # an odd row length: every other cursor's rows are not 16-byte aligned
    "rows not aligned": lambda dev: _decode_args(_zlib_raw(testing.mixed(1 << 17, 11)), dev,
                                                 cap=1001),
    "word clamp, one cursor": lambda dev: _clamp_args(1, dev),
    "word clamp, 64 cursors": lambda dev: _clamp_args(64, dev),
}


def _check_decode(args, got):
    """got (the kernel's outputs) equal the plain version's; returns them."""
    want = inflate_cuda.cursor_tokenize_plain(args)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    return want


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_inflate_lut_kernel_matches_plain(dev, case):
    args = DECODE_CASES[case](dev)
    got = _launched("inflate_lut", lambda: inflate_cuda.decode_luts(args))
    assert got.dtype == torch.int32 and got.shape == (args.tabs.shape[0], inflate_cuda.LUT_ROWS, 2)
    assert torch.equal(got, inflate_cuda.decode_luts_plain(args.tabs, args.lents, args.dents))


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_inflate_decode_kernel_matches_plain(dev, case):
    args = DECODE_CASES[case](dev)
    lut_before = _build.LAUNCHES["inflate_lut"]
    got = _launched("inflate_decode", lambda: inflate_cuda.cursor_decode(args))
    assert _build.LAUNCHES["inflate_lut"] == lut_before + 1
    want = _check_decode(args, got)
    statuses = set(want[4].tolist())
    if case in ("tape overflow", "corrupted"):
        assert inflate_cuda.ST_ERR in statuses
    if case == "ends mid-symbol":
        assert inflate_cuda.ST_OOB in statuses
    if case.startswith("word clamp"):
        # a row decoded from past the slice's third-last word
        swstart, cnt = args.cur[inflate_cuda.C_SWSTART, 0], int(want[2][0])
        assert int(want[1][cnt - 1]) - 32 * int(swstart) >= 32 * (args.nwp - 2)


@pytest.mark.parametrize("threads", [32, 64, 96, 128])
@pytest.mark.parametrize("case", ["129 cursors", "word clamp, 64 cursors", "stored only",
                                  "rows not aligned"])
def test_inflate_decode_block_sizes(dev, case, threads):
    """Every block size gives the same tapes, from tables built once."""
    args = DECODE_CASES[case](dev)
    luts = inflate_cuda.decode_luts(args)
    got = _launched("inflate_decode", lambda: inflate_cuda.cursor_decode(args, luts, threads))
    _check_decode(args, got)


def _device_route(fn, n_bytes):
    """fn()'s result, checking that the device route returned all of its
    `n_bytes` and that nothing fell back to the host engine."""
    before = trace.get_counters()
    out = fn()
    counted = testing.counters_since(before)
    moved = {k: counted.get("inflate." + k, 0)
             for k in ("device_fallback", "device_mismatch_fallback", "device")}
    assert moved == {"device_fallback": 0, "device_mismatch_fallback": 0, "device": n_bytes}
    return out


def test_inflate_on_card_matches_cpu(dev):
    """inflate()'s device route on zlib, gzip and raw streams
    (testing.inflate_device_route: inflate() itself keeps a raw stream on
    the host), and inflate_device_v2's pass-3 variants and forced repair,
    on the card and on the CPU, each with no fallback; a bad trailer falls
    back to the host engine's verdict."""
    data = testing.mixed(3 << 18, 8)
    streams = [zlib.compress(data.tobytes(), 6),
               testing.device_route(data, device=dev, format="gzip").tobytes(),
               _zlib_raw(data, 1).tobytes()]
    for wire in streams:
        _build.reset_launches()
        got = _device_route(lambda: testing.inflate_device_route(wire, device=dev), len(data))
        assert _build.LAUNCHES["inflate_decode"] == _build.LAUNCHES["inflate_lut"] == 1
        assert got.tobytes() == data.tobytes()
        assert np.array_equal(
            got, _device_route(lambda: testing.inflate_device_route(wire), len(data)))
    raw = _zlib_raw(data, 6)
    for kw in ({"device_expand": True}, {"device_expand": False}, {"force_repair": True}):
        out = d2.inflate_device_v2(raw, device=dev, **kw)
        assert torch.is_tensor(out) == kw.get("device_expand", False)
        out = out.cpu().numpy() if torch.is_tensor(out) else out
        assert out.tobytes() == data.tobytes()
    # a bad Adler-32: the card's output fails it, and the host engine,
    # after one counted fallback, gives the verdict
    before = trace.get_counters()
    with pytest.raises(ValueError, match="Data integrity check failed"):
        tpuzlib_torch.inflate(streams[0][:-1] + bytes([streams[0][-1] ^ 1]), device=dev)
    assert testing.counters_since(before).get("inflate.device_mismatch_fallback") == 1


def test_inflate_on_card_reads_the_trailer_after_the_stream(dev):
    """Bytes after the trailer are ignored by the device route
    (testing.inflate_device_route: these streams are under inflate()'s
    256 KiB floor) on the card as on the CPU; a trailer cut short falls
    back (counted) and inflate() raises ValueError."""
    data = testing.mixed(3 << 16, 10)
    z = zlib.compress(data.tobytes(), 6)
    gz = testing.device_route(data, device=dev, format="gzip").tobytes()
    for wire, want in ((z + b"GARBAGE TRAILING DATA", data.tobytes()),
                       (gz + testing.device_route(data[::-1], device=dev, format="gzip").tobytes(),
                        data.tobytes()),
                       (_zlib_raw(data).tobytes() + b"\x01\x02trailing", data.tobytes())):
        got = _device_route(lambda: testing.inflate_device_route(wire, device=dev), len(want))
        assert got.tobytes() == want == _device_route(
            lambda: testing.inflate_device_route(wire), len(want)).tobytes()
    for wire in (z[:-2], gz[:-3]):
        before = trace.get_counters()
        assert testing.inflate_device_route(wire, device=dev) is None
        assert testing.counters_since(before) == {"inflate.device_fallback": 1}
        with pytest.raises(ValueError, match="Unexpected EOF"):
            tpuzlib_torch.inflate(wire, device=dev)


def test_device_deflater_on_card_keeps_its_own_pending_input(dev):
    """A buffer reused between appends: the bytes as they were appended."""
    d = tpuzlib_torch.DeviceDeflater(level=6, chunk=16 * KB, batch=2, device=dev)
    buf = bytearray(b"A" * 40000)
    parts = [d.append(buf)]
    buf[:] = b"B" * 40000
    parts += [d.append(buf), d.finish()]
    wire = b"".join(p.tobytes() for p in parts)
    assert zlib.decompress(wire, -15) == b"A" * 40000 + b"B" * 40000


# the CRC probe kernels: row counts around a CUDA block of each kernel
# (8 rows, 32 rows, tiles of 256 to 1024), all-zero and all-0xFF bytes
PROBE_NB = [1, 7, 255, 257]


def _crc_rows(nb, row, offset, fill, dev):
    """(nb, row) bytes on the card, seeded or all `fill`, as a view
    starting `offset` bytes into its allocation; and the same bytes on the
    host."""
    if fill is None:
        return (lambda x, data: (x.view(nb, row), data))(*_bytes_at(nb * row, offset, dev))
    data = np.full(nb * row, fill, np.uint8)
    buf = torch.zeros(nb * row + offset, dtype=torch.uint8, device=dev)
    buf[offset:] = fill
    return buf[offset:].view(nb, row), data


@pytest.mark.parametrize("fill", [None, 0, 255])
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("row", [17, 1024, 4096])
@pytest.mark.parametrize("nb", PROBE_NB)
def test_crc_row_kernels_match_plain(dev, nb, row, offset, fill):
    x, _ = _crc_rows(nb, row, offset, fill, dev)
    got = _launched("crc_rowsum", lambda: crc32_probe.crc_rowsum(x))
    assert got.dtype == torch.int32 and torch.equal(got, crc32_probe.crc_rowsum_plain(x))
    for mode in crc32_probe.MODES:
        got = _launched("crc_unpack_" + mode, lambda: crc32_probe.crc_unpack(x, mode))
        assert torch.equal(got, crc32_probe.crc_unpack_plain(x, mode)), mode


@pytest.mark.parametrize("fill", [None, 0, 255])
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("block", crc32_probe.FORM_BLOCKS)
@pytest.mark.parametrize("nb", PROBE_NB)
def test_crc_forms_mm_kernel_matches_plain(dev, nb, block, offset, fill):
    x, _ = _crc_rows(nb, block, offset, fill, dev)
    for dtype in crc32_probe.DTYPES:
        want = crc32_probe.crc_forms_mm_plain(x, dtype)
        for tile in crc32_probe.TILES:
            got = _launched("crc_forms_mm_" + dtype,
                            lambda: crc32_probe.crc_forms_mm(x, dtype, tile))
            assert got.shape == (nb, 32) and torch.equal(got, want), (dtype, tile)


@pytest.mark.parametrize("fill", [None, 0, 255])
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("nb", PROBE_NB)
def test_gf2_bits_mm_kernel_matches_plain(dev, nb, offset, fill):
    """Bits of bytes at an element offset (3: no fragment load is aligned)
    against the plain product and the forms of the same bytes."""
    x, _ = _crc_rows(nb, 1024, 0, fill, dev)
    bits = crc32_probe.plane_bits(x)
    buf = torch.zeros(bits.numel() + offset, dtype=torch.bfloat16, device=dev)
    buf[offset:] = bits.reshape(-1)
    bits = buf[offset:].view(nb, -1)
    m = crc32_probe.form_matrix(1024, torch.bfloat16, dev)
    got = _launched("gf2_bits_mm", lambda: crc32_probe.gf2_bits_mm(bits, m))
    assert torch.equal(got, crc32_probe.gf2_bits_mm_plain(bits, m))
    assert torch.equal(got, crc32_probe.crc_forms_mm_plain(x))


def test_gf2_bits_mm_kernel_on_random_matrices(dev):
    rng = np.random.default_rng(7)
    for nb, K in ((33, 128), (64, 384), (300, 1024)):
        bits, m = (torch.from_numpy(rng.integers(0, 2, shape).astype(np.float32))
                   .to(dev, torch.bfloat16) for shape in ((nb, K), (K, 32)))
        got = _launched("gf2_bits_mm", lambda: crc32_probe.gf2_bits_mm(bits, m))
        assert torch.equal(got, crc32_probe.gf2_bits_mm_plain(bits, m)), (nb, K)


@pytest.mark.parametrize("dtype", sorted(crc32_probe.DTYPES))
@pytest.mark.parametrize("block", crc32_probe.FORM_BLOCKS)
def test_tensor_core_forms_give_the_crc(dev, dtype, block):
    """The forms of 257 blocks, combined on the host, give zlib's CRC; at
    1 KiB they equal the table fold's per-block forms."""
    x, data = _crc_rows(257, block, 5, None, dev)
    cols = crc32_probe.crc_forms_mm(x, dtype)
    assert tools.forms_crc(cols, block, data.size) == zlib.crc32(data.tobytes())
    if block == 1024:
        fold = crc32_cuda.crc32_forms(x.reshape(-1), 0, 1)
        assert torch.equal(crc32_probe.pack_forms(cols), fold)


def test_crc_probe_wrappers_reject_what_the_kernels_do_not_take(dev):
    b = torch.zeros(8, 1024, dtype=torch.uint8, device=dev)
    m = crc32_probe.form_matrix(1024, torch.bfloat16, dev)
    bits = torch.zeros(8, 8192, dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError):
        crc32_probe.crc_rowsum(b.int())
    with pytest.raises(ValueError):
        crc32_probe.crc_rowsum(b.reshape(-1))
    with pytest.raises(ValueError):
        crc32_probe.crc_unpack(b, "f32")
    with pytest.raises(ValueError):
        crc32_probe.crc_unpack(b[:, ::2], "u8")
    with pytest.raises(ValueError):
        crc32_probe.crc_forms_mm(b[:, :512])
    with pytest.raises(ValueError):
        crc32_probe.crc_forms_mm(b, "f16")
    with pytest.raises(ValueError):
        crc32_probe.crc_forms_mm(b, "bf16", 64)
    with pytest.raises(TypeError):
        crc32_probe.gf2_bits_mm(bits.float(), m)
    with pytest.raises(ValueError):
        crc32_probe.gf2_bits_mm(bits[:, :8000].contiguous(), m[:8000].contiguous())
    with pytest.raises(ValueError):
        crc32_probe.gf2_bits_mm(bits, m[:4096])
    with pytest.raises(ValueError):  # m off a 32-byte boundary
        crc32_probe.gf2_bits_mm(bits[:, :128].contiguous(),
                                m.view(-1)[8 : 8 + 128 * 32].view(128, 32))
