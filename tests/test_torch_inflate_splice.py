"""The splice, the compaction and the device expansion against tpuzlib's
jitted programs, on the CPU, from the same tapes: the splice's meta
vector and compacted tape, compact_bounds with host keep bounds, and
expand_v2's bytes and total, all exactly equal.

One synthetic tape holds the deliberate difference from tpuzlib: a kept
flagged EOB behind a spurious one in a cursor's garbage prefix.  tpuzlib
reads only each cursor's first flag and keeps the tape (ok = 1); the port
reads every kept flag and declines it (ok = 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuzlib.kernels import inflate_device2 as J
from tpuzlib_torch import testing
from tpuzlib_torch.kernels import inflate_cuda as PC
from tpuzlib_torch.kernels import inflate_device2 as P

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

STREAMS = testing.inflate_streams()
STRIDE, MAXC = 1 << 13, 256
_TAPES = {}


def _tapes(name):
    """(buf, layout, the port's tapes on the CPU) of a stream, made once."""
    if name not in _TAPES:
        buf = STREAMS[name][0]
        lay = P.plan_cursors(buf, STRIDE, MAXC)
        _TAPES[name] = buf, lay, PC.cursor_decode(lay.decode_args(buf, "cpu"))
    return _TAPES[name]


def _jax_splice(toks, stops, bstart, first, last, expect, active):
    K = len(stops)
    tok, bp, cnt, end, status, eob = (t.numpy() for t in toks)
    splice = J.make_splice_compact(K, bp.size // K)
    meta, comp, kcnt = splice(
        jnp.asarray(tok.view(np.uint32)), *(jnp.asarray(a) for a in (
            bp, cnt, end, status, stops, bstart, first, last, expect, active, eob)))
    return np.asarray(meta), np.asarray(comp).view(np.int32), np.asarray(kcnt)


def _port_splice(toks, *vecs):
    meta, comp, kcnt = P.splice_compact(toks, *vecs)
    return meta.numpy(), comp.numpy(), kcnt.numpy()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_splice_matches(name):
    _, lay, toks = _tapes(name)
    vecs = (lay.stops, lay.bstart, lay.first, lay.last, lay.expect_eob, lay.active)
    want = _jax_splice(toks, *vecs)
    got = _port_splice(toks, *vecs)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    # the vectors as tensors give the same
    as_tensors = P.splice_compact(toks, *(torch.from_numpy(v) for v in vecs))
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(as_tensors, got))


@pytest.mark.parametrize("name", ["L1", "hidden stored", "fixed"])
def test_compact_bounds_matches(name):
    _, lay, toks = _tapes(name)
    rng = np.random.default_rng(3)
    for _ in range(3):
        lo = rng.integers(-5, lay.cap + 5, lay.Kpad).astype(np.int32)
        hi = (lo + rng.integers(-20, lay.cap, lay.Kpad)).astype(np.int32)
        M, comp, kcnt = J.make_compact_bounds(lay.Kpad, lay.cap)(
            jnp.asarray(toks[0].numpy().view(np.uint32)), jnp.asarray(lo), jnp.asarray(hi))
        gM, gcomp, gkcnt = P.compact_bounds(toks[0], torch.from_numpy(lo), torch.from_numpy(hi))
        assert int(gM) == int(M)
        assert np.array_equal(gcomp.numpy(), np.asarray(comp).view(np.int32))
        assert np.array_equal(gkcnt.numpy(), np.asarray(kcnt))


@pytest.mark.parametrize("name", ["L6", "L9", "stored", "port encoder"])
def test_expand_v2_matches(name):
    """Both expansions of the spliced tape: output bytes past the total
    included, with and without a window, and with an output too small
    (the total says so)."""
    buf, lay, toks = _tapes(name)
    meta, comp, _ = P.splice_compact(toks, lay.stops, lay.bstart, lay.first, lay.last,
                                     lay.expect_eob, lay.active)
    assert int(meta[0]) == 1, "the stream splices without repair"
    M = int(meta[1])
    src = STREAMS[name][1]
    rng = np.random.default_rng(4)
    for window, out_cap in ((np.zeros(P.WINDOW, np.uint8), len(src) + 3000),
                            (rng.integers(0, 256, P.WINDOW, dtype=np.uint8), len(src) + 1024),
                            (np.zeros(P.WINDOW, np.uint8), len(src) // 2)):
        want_out, want_total = J.make_expand_v2(comp.numel(), out_cap)(
            jnp.asarray(comp.numpy().view(np.uint32)), np.int32(M), jnp.asarray(window))
        out, total = P.expand_v2(comp, M, torch.from_numpy(window), out_cap)
        assert int(total) == int(want_total) == len(src)
        assert out.dtype == torch.uint8 and np.array_equal(out.numpy(), np.asarray(want_out))
    assert out_cap < len(src)
    full = P.device_expand_all(comp, M, torch.zeros(P.WINDOW, dtype=torch.uint8), len(src) // 3)
    assert full.numpy().tobytes() == src.tobytes()


def _masked_eob_tape():
    """One block of three cursors.  Cursor 1 enters cursor 0's chain at its
    row 2 (bit 100); its row 0, in the garbage prefix before that, holds a
    spurious flagged EOB, and its row 5 (bit 130), which it keeps, a real
    one.  Cursor 2 ends the block at an expected EOB."""
    cap = 16
    bps = [list(range(0, 150, 10)), [45, 57] + list(range(100, 240, 10)),
           list(range(190, 310, 10))]
    tok = np.zeros((3, cap), np.int32)
    bp = np.full((3, cap), PC.SENT_BP, np.int32)
    for k, row in enumerate(bps):
        bp[k, : len(row)] = row
        tok[k, : len(row)] = 65 + k
    tok[1, 0] = tok[1, 5] = 1 << 26
    cnt = np.array([len(r) for r in bps], np.int32)
    end = np.array([150, 240, 305], np.int32)
    status = np.array([PC.ST_STRIDE_END, PC.ST_STRIDE_END, PC.ST_EOB], np.int32)
    eob_idx = np.array([-1, 0, -1], np.int32)
    toks = [torch.from_numpy(a.reshape(-1)) for a in (tok, bp)] + [
        torch.from_numpy(a) for a in (cnt, end, status, eob_idx)]
    vecs = (np.array([100, 200, 300], np.int32), np.zeros(3, np.int32),
            np.array([True, False, False]), np.array([False, False, True]),
            np.array([False, False, True]), np.ones(3, bool))
    return toks, vecs


def test_masked_early_eob_declines():
    toks, vecs = _masked_eob_tape()
    want = _jax_splice(toks, *vecs)
    got = _port_splice(toks, *vecs)
    assert want[0][0] == 1 and got[0][0] == 0  # tpuzlib keeps it; the port declines
    assert np.array_equal(got[0][1:], want[0][1:])
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    # the same tape without the kept flag splices in both
    toks[0][16 + 5] = 66
    assert _port_splice(toks, *vecs)[0][0] == _jax_splice(toks, *vecs)[0][0] == 1
