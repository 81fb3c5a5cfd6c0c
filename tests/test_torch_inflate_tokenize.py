"""The cursor decode (cursor_tokenize, its plain torch version on CPU
tensors) against tpuzlib's Pallas kernel in interpret mode, and the
decode tables against tpuzlib's: all six outputs exactly equal, on every
block kind, on a truncated and a corrupted stream, with a tape too short,
and with a cursor count that is not a whole number of 128-cursor groups.
"""

import numpy as np
import pytest
import torch

from tpuzlib.kernels import inflate_device2 as J
from tpuzlib.kernels import inflate_pallas as JP
from tpuzlib_torch import testing
from tpuzlib_torch.kernels import inflate_cuda as PC
from tpuzlib_torch.kernels import inflate_device2 as P

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

STREAMS = testing.inflate_streams()
STRIDE, MAXC = 1 << 13, 256


def _decode_both(buf, lay, k=None, cap=None):
    """Both decodes of the first k cursors of layout `lay` over `buf`;
    tpuzlib's takes whole 128-cursor groups, padded with inactive ones."""
    k = lay.Kpad if k is None else k
    cap = lay.cap if cap is None else cap
    kp = -(-k // 128) * 128

    def padded(a, fill):
        out = np.full(kp, fill, a.dtype)
        out[:k] = a[:k]
        return out

    want = JP.pallas_cursor_tokenize(
        buf, padded(lay.starts, -1), padded(lay.stops_dec, 0), padded(lay.block, 0),
        J._plan_blocks(buf, build_luts=False), lay.stride_bits, 2 * P.OVERLAP, cap,
        expect_eob=padded(lay.expect_eob, True))
    got = PC.cursor_tokenize(buf, lay.starts[:k], lay.stops_dec[:k], lay.block[:k], lay.plan,
                             lay.stride_bits, 2 * P.OVERLAP, cap, lay.expect_eob[:k], "cpu")
    want = [np.asarray(w).view(np.int32) for w in want]
    want = [w[: k * cap] for w in want[:2]] + [w[:k] for w in want[2:]]
    for name, g, w in zip(("tok_pack", "tok_bp", "cnt", "end_pos", "status", "eob_idx"), got, want):
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        assert np.array_equal(g.numpy(), w), name
    return [g.numpy() for g in got]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decode_matches_pallas(monkeypatch, name):
    buf = STREAMS[name][0]
    lay = P.plan_cursors(buf, STRIDE, MAXC)
    tok, bp, cnt, _, status, _ = _decode_both(buf, lay)
    # the tapes are real: tok_bp ascends within a cursor's rows, and the
    # rows past its count hold the sentinel
    assert np.all(status[: lay.K] != PC.ST_RUN)
    rows = bp.reshape(lay.Kpad, lay.cap)
    for k in range(lay.K):
        assert np.all(np.diff(rows[k, : cnt[k]]) > 0) and np.all(rows[k, cnt[k]:] == PC.SENT_BP)


def test_truncated_stream_runs_out_of_bits():
    buf = STREAMS["L6"][0]
    lay = P.plan_cursors(buf, STRIDE, MAXC)
    status = _decode_both(buf[: 3 * len(buf) // 5 + 1], lay)[4]
    assert PC.ST_OOB in status


def test_corrupted_stream_hits_bad_codes():
    # the fixed tables hold reserved codes (lit/len 286-287, distance
    # 30-31), which random bits soon reach
    buf = STREAMS["fixed"][0]
    lay = P.plan_cursors(buf, STRIDE, MAXC)
    bad = buf.copy()
    bad[len(bad) // 3 : len(bad) // 3 + 600] = np.random.default_rng(2).integers(0, 256, 600)
    status = _decode_both(bad, lay)[4]
    assert PC.ST_ERR in status


def test_tape_overflow():
    buf = STREAMS["fixed"][0]
    lay = P.plan_cursors(buf, STRIDE, MAXC)
    cnt, status = (_decode_both(buf, lay, cap=40)[i] for i in (2, 4))
    assert PC.ST_ERR in status and cnt.max() == 40


def test_cursor_count_not_whole_groups():
    buf = STREAMS["L1"][0]
    lay = P.plan_cursors(buf, STRIDE, MAXC)
    assert lay.K > 20
    _decode_both(buf, lay, k=lay.K - 3)
    _decode_both(buf, lay, k=1)


def test_tables_match():
    plan = P._plan_blocks(STREAMS["L1"][0])
    jplan = J._plan_blocks(STREAMS["L1"][0], build_luts=False)
    cases = [(PC.stored_canon_tables(), JP.stored_canon_tables()),
             (PC.fixed_canon_tables(), JP.fixed_canon_tables())]
    cases += [(PC.tables_for_block(p.lens_info), JP.tables_for_block(jp[7]))
              for p, jp in zip(plan, jplan)]
    for got, want in cases:
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert np.array_equal(a, b)
    tabs, lents, dents = PC.block_tables(plan)
    assert tabs.shape == (len(plan), PC.TB) and lents.shape == (len(plan), PC.LE)
    assert (PC.LE, PC.DE, PC.SENT_BP) == (JP.LE, JP.DE, JP.SENT_BP)
    assert (PC.ST_RUN, PC.ST_STRIDE_END, PC.ST_EOB, PC.ST_ERR, PC.ST_OOB) == (
        J.ST_RUN, J.ST_STRIDE_END, J.ST_EOB, J.ST_ERR, J.ST_OOB)
    for stride in (1 << 12, 1 << 13, 1 << 14):
        for overlap in (1024, 2048):
            nwp, nwpad = PC.words_shape(30001, stride, overlap)
            assert nwp == JP._words_shape(30001, stride, overlap)[0] and nwpad == 7501 + nwp
