"""The decode's primary lookup tables (decode_luts_plain, the plain
version of the `inflate_lut` kernel) against the counting decode they
stand for (inflate_cuda._tree_decode) on every 16-bit window of every
block, and against tpuzlib's flat decode table (codec/huffman.build_lut):
python zlib's levels 1, 6 and 9, Z_FIXED, stored blocks, 15-bit codes
from zlib and by hand, a single one-bit distance code, the tables of a
corrupted stream, and count tables no valid header gives.
"""

import zlib

import numpy as np
import pytest
import torch

from tpuzlib.codec import huffman as jhuffman
from tpuzlib_torch import testing
from tpuzlib_torch.kernels import inflate_cuda as PC
from tpuzlib_torch.kernels import inflate_device2 as P

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

WINDOWS = torch.arange(1 << 16)


def _corrupted():
    """L1's blocks, the middle half of the stream replaced by random bytes:
    the headers that still parse give the tables."""
    buf = testing.inflate_streams()["L1"][0].copy()
    n = len(buf)
    buf[n // 4 : n // 4 + n // 2] = np.random.default_rng(3).integers(0, 256, n // 2)
    return buf


def _streams():
    s = testing.inflate_streams()
    out = {name: s[name][0] for name in ("L1", "L6", "L9", "fixed", "stored")}
    out["15-bit codes, zlib"] = np.frombuffer(
        testing.zlib_stream(testing.fibonacci_bytes(), 9, -15, zlib.Z_HUFFMAN_ONLY), np.uint8)
    out.update(testing.hand_made_blocks())
    out["corrupted"] = _corrupted()
    return out


STREAMS = _streams()


def _args(buf):
    return P.plan_cursors(buf, 1 << 13, 256).decode_args(buf, "cpu")


def _check_against_counting(tabs, lents, dents):
    """Every 16-bit window of every block: where the table's row for the
    window's first bits holds a length, the counting decode matches that
    length and finds that entry; where it holds 0, the counting decode
    matches no length within the table's bits.  Returns the rows of each
    table that send the decode to the counting loop."""
    lut = PC.decode_luts_plain(tabs, lents, dents)
    assert lut.dtype == torch.int32 and lut.shape == (tabs.shape[0], PC.LUT_ROWS, 2)
    t = tabs.to(torch.int64)
    misses = [0, 0]
    for b in range(tabs.shape[0]):
        tb = t[b].expand(len(WINDOWS), -1)
        for part, (col, ents, bits, base) in enumerate((
                (PC.T_LC, lents, PC.LUT_BITS, 0), (PC.T_DC, dents, PC.DLUT_BITS, 1 << PC.LUT_BITS))):
            rank, L, ok = PC._tree_decode(WINDOWS, tb[:, col : col + 16], tb[:, col + 16 : col + 32],
                                          tb[:, col + 32 : col + 48])
            ent = ents[b][rank.clamp(0, ents.shape[1] - 1)]
            row = lut[b, base + (WINDOWS & ((1 << bits) - 1))]
            hit = row[:, 1] > 0
            assert torch.equal(hit, ok & (L <= bits))
            assert torch.equal(row[hit, 1] & 0xFF, L[hit].int()) and torch.equal(row[hit, 0], ent[hit])
            # the bits the symbol takes: its code and its extra bits
            assert torch.equal(row[hit, 1] >> 8, (L[hit] + ((ent[hit] >> 19) & 0xF)).int())
            assert not row[~hit].any()
            misses[part] += int((lut[b, base : base + (1 << bits), 1] == 0).sum())
    return misses


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_luts_equal_counting_decode(name):
    a = _args(STREAMS[name])
    lmiss, dmiss = _check_against_counting(a.tabs, a.lents, a.dents)
    kinds = {p.lens_info[0] for p in P.plan_cursors(STREAMS[name], 1 << 13, 256).plan}
    if name.startswith("15-bit"):
        # codes past the tables' bits: the counting loop is reached
        assert "dyn" in kinds and lmiss > 0
    if name in ("15-bit codes", "one-bit distance code"):
        assert dmiss > 0  # the one-bit code: every window whose first bit is 1
    if name == "stored":
        assert kinds == {"stored"} and lmiss == 0


def test_luts_match_tpuzlib_flat_table():
    """Each table row equals tpuzlib's flat 15-bit decode table at the same
    window, where that entry's code fits the table's bits; elsewhere (a
    longer code, or no code of an incomplete set) the row is 0."""
    checked = 0
    for name, buf in STREAMS.items():
        a = _args(buf)
        lut = PC.decode_luts_plain(a.tabs, a.lents, a.dents).numpy()
        plan = P.plan_cursors(buf, 1 << 13, 256).plan
        for b, p in enumerate(plan):
            if p.lens_info[0] != "dyn":
                continue
            for lengths, kind, bits, base in ((p.lens_info[1], "litlen", PC.LUT_BITS, 0),
                                              (p.lens_info[2], "dist", PC.DLUT_BITS,
                                               1 << PC.LUT_BITS)):
                flat = jhuffman.build_lut(np.asarray(lengths, np.int32), kind)[: 1 << bits]
                nb = (flat >> jhuffman.NB_SHIFT) & jhuffman.NB_MASK
                fits = ((flat & jhuffman.INVALID) == 0) & (nb <= bits)
                rows = lut[b, base : base + (1 << bits)]
                assert np.array_equal(rows[:, 1] & 0xFF, np.where(fits, nb, 0)), (name, b, kind)
                assert np.array_equal(rows[:, 0].view(np.uint32), np.where(fits, flat, 0))
                checked += 1
    assert checked >= 20


def test_luts_of_code_lengths_no_header_gives():
    """Over- and under-subscribed length sets (the count tables then pass
    the code space, and ranks leave the entry table): the tables still
    equal the counting decode."""
    rng = np.random.default_rng(5)
    sets = [(rng.integers(0, 16, 286), rng.integers(0, 16, 30)),
            (rng.integers(0, 4, 286), rng.integers(0, 3, 30)),
            (np.r_[np.full(100, 15), np.zeros(186, int)], np.r_[np.full(3, 9), np.zeros(27, int)]),
            (np.zeros(286, int), np.zeros(30, int))]
    nblk = len(sets)
    tabs = np.zeros((nblk, PC.TB), np.int32)
    lents = np.zeros((nblk, PC.LE), np.uint32)
    dents = np.zeros((nblk, PC.DE), np.uint32)
    for b, (ll, dl) in enumerate(sets):
        (le, *lt), (de, *dt) = PC.canon_tables(ll, "litlen"), PC.canon_tables(dl, "dist")
        lents[b], dents[b] = le, de
        for col, t in zip((PC.T_LC, PC.T_LF, PC.T_LO, PC.T_DC, PC.T_DF, PC.T_DO), (*lt, *dt)):
            tabs[b, col : col + 16] = t
    as_t = lambda x: torch.from_numpy(x.view(np.int32))  # noqa: E731
    lmiss, dmiss = _check_against_counting(as_t(tabs), as_t(lents), as_t(dents))
    assert lmiss > 0 and dmiss > 0


def test_decode_luts_on_cpu_is_the_plain_version():
    a = _args(STREAMS["L1"])
    assert a.tabs.shape[0] > 1
    assert torch.equal(PC.decode_luts(a), PC.decode_luts_plain(a.tabs, a.lents, a.dents))
    assert PC.LUT_ROWS == (1 << PC.LUT_BITS) + (1 << PC.DLUT_BITS)
    # narrower tables hold the same rule
    small = PC.decode_luts_plain(a.tabs, a.lents, a.dents, 9, 6)
    assert small.shape == (a.tabs.shape[0], (1 << 9) + (1 << 6), 2)
    full = PC.decode_luts(a)
    lit9 = full[:, : 1 << 9]
    keep = ((lit9[..., 1] & 0xFF) <= 9)[..., None]
    assert torch.equal(small[:, : 1 << 9], torch.where(keep, lit9, 0))
