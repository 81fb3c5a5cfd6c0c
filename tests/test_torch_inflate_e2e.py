"""inflate_device_v2 on the CPU against tpuzlib's (its Pallas path, the
kernel in interpret mode) and zlib: both pass-3 variants, the forced
splice repair with equal keep bounds, a preset dictionary, the repair's
caps, size_hint, and the port's deliberate differences from tpuzlib (a Huffman block
the header scan cannot see, a real early EOB behind a spurious flag, one
OVERLAP constant).
"""

import zlib

import numpy as np
import pytest
import torch

from tpuzlib.kernels import inflate_device2 as J
from tpuzlib.kernels import inflate_pallas as JP
from tpuzlib_torch import testing
from tpuzlib_torch.kernels import inflate_cuda as PC
from tpuzlib_torch.kernels import inflate_device2 as P
from tpuzlib_torch.utils import trace

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

STREAMS = testing.inflate_streams()
STRIDE, MAXC = 1 << 13, 256


def _jax(monkeypatch, buf, **kw):
    monkeypatch.setenv("TPUZLIB_PALLAS_TOK", "1")
    out = J.inflate_device_v2(buf, stride_bits=STRIDE, max_cursors=MAXC, **kw)
    return None if out is None else np.asarray(out)


def _port(buf, **kw):
    out = P.inflate_device_v2(buf, stride_bits=STRIDE, max_cursors=MAXC, device="cpu", **kw)
    if kw.get("device_expand"):
        assert torch.is_tensor(out) and out.dtype == torch.uint8
        return out.numpy()
    assert out is None or isinstance(out, np.ndarray)
    return out


def _recorder(monkeypatch, module, seen):
    """Record what module._repair_splice returns."""
    repair = module._repair_splice

    def record(*args, **kw):
        seen.append(repair(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(module, "_repair_splice", record)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_inflate_matches_tpuzlib(monkeypatch, name):
    buf, src = STREAMS[name]
    want = _jax(monkeypatch, buf)
    assert want is not None and want.tobytes() == src.tobytes()
    assert _port(buf).tobytes() == src.tobytes()
    assert _port(buf, device_expand=True).tobytes() == src.tobytes()


@pytest.mark.parametrize("name", ["L1", "L6", "fixed", "hidden stored", "port encoder"])
def test_forced_repair_matches(monkeypatch, name):
    buf, src = STREAMS[name]
    jseen, pseen = [], []
    _recorder(monkeypatch, J, jseen)
    _recorder(monkeypatch, P, pseen)
    monkeypatch.setenv("TPUZLIB_FORCE_REPAIR", "1")
    assert _jax(monkeypatch, buf).tobytes() == src.tobytes()
    before = trace.get_counters()
    assert _port(buf, force_repair=True).tobytes() == src.tobytes()
    assert testing.counters_since(before).get("inflate.splice_repair") == 1
    assert _port(buf, force_repair=True, device_expand=True).tobytes() == src.tobytes()
    (jlo, jhi, jbridges, jends), (plo, phi, pbridges, pends) = jseen[0], pseen[0]
    assert np.array_equal(plo, jlo) and np.array_equal(phi, jhi) and pends == jends
    assert sorted(pbridges) == sorted(jbridges)
    for k, (litlen, dist) in pbridges.items():
        assert np.array_equal(litlen, jbridges[k][0]) and np.array_equal(dist, jbridges[k][1])


@pytest.mark.parametrize("where", ["below", "equal", "above"])
def test_size_hint_changes_no_byte(where):
    """size_hint, in tpuzlib's position and by keyword, below, at and
    above the output's size: the device expansion starts from it and
    grows by retry, the host expansion ignores it; the same bytes."""
    buf, src = STREAMS["L6"]
    n = {"below": 1, "equal": len(src), "above": 3 * len(src) + 5}[where]
    # (data, dictionary, stride_bits, max_cursors, size_hint, device_expand)
    out = P.inflate_device_v2(buf, None, STRIDE, MAXC, n, True, device="cpu")
    assert torch.is_tensor(out) and out.numpy().tobytes() == src.tobytes()
    assert _port(buf, size_hint=n, device_expand=True).tobytes() == src.tobytes()
    assert _port(buf, size_hint=n).tobytes() == src.tobytes()


def test_repair_caps_and_bridge_chunk():
    buf, src = STREAMS["fixed"]  # its splice declines: the repair bridges
    before = trace.get_counters()
    assert _port(buf, bridge_chunk=64).tobytes() == src.tobytes()
    assert testing.counters_since(before).get("inflate.repair_bridge", 0) > 0
    assert _port(buf, max_bridges=0) is None
    with pytest.raises(P.DeviceDeclined, match="bridge cap"):
        P.decode(buf, stride_bits=STRIDE, max_cursors=MAXC, device="cpu", max_bridges=0)


def test_dictionary_stream(monkeypatch):
    data = testing.corpus("text", 1 << 16, 5)
    dictionary = data[:4096]
    c = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=dictionary.tobytes())
    buf = np.frombuffer(c.compress(data[4096:].tobytes()) + c.flush(), np.uint8)
    want = _jax(monkeypatch, buf, dictionary=dictionary)
    assert want is not None and want.tobytes() == data[4096:].tobytes()
    for device_expand in (False, True):
        got = _port(buf, dictionary=dictionary, device_expand=device_expand)
        assert got.tobytes() == want.tobytes()


def test_hidden_fixed_block_decodes(monkeypatch):
    """zlib writes a fixed block for a short piece before a sync flush.
    The header scan finds only dynamic headers, so the block lies hidden
    between two planned ones: tpuzlib declines the stream, the port
    decodes it on the host in the gap walk."""
    text = testing.corpus("text", 1 << 16, 9)
    parts = [text[:24000], text[24000:24200], text[30000:]]
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    buf = np.frombuffer(b"".join(c.compress(p.tobytes()) + c.flush(zlib.Z_SYNC_FLUSH)
                                 for p in parts) + c.flush(), np.uint8)
    src = np.concatenate(parts)
    assert _jax(monkeypatch, buf) is None
    assert _port(buf).tobytes() == src.tobytes()
    assert _port(buf, device_expand=True).tobytes() == src.tobytes()


def test_real_early_eob_behind_spurious_flag(monkeypatch):
    """A cursor whose kept rows hold a real early EOB (a stored run hides
    behind its block) gets a spurious flag in its garbage prefix, in both
    packages' tapes.  tpuzlib reads only the first flag, keeps the real
    EOB and goes wrong; the port's splice and repair find it."""
    buf, src = STREAMS["hidden stored"]
    lay = P.plan_cursors(buf, STRIDE, MAXC)
    toks = PC.cursor_decode(lay.decode_args(buf, "cpu"))
    meta = P.splice_compact(toks, lay.stops, lay.bstart, lay.first, lay.last, lay.expect_eob,
                            lay.active)[0].numpy()
    flagged = P.flagged_rows(toks[0], lay.Kpad)
    keep_lo = P._repair_splice(buf, lay, meta, toks[1], flagged)[0]
    k = next(k for k, rows in flagged.items() if not lay.first[k] and rows[0] >= keep_lo[k] > 0)

    def inject(tok, eob_idx):
        tok.view(lay.Kpad, lay.cap)[k, 0] = 1 << 26
        eob_idx[k] = 0

    decode = JP.pallas_cursor_tokenize

    def jax_injected(*args, **kw):
        tok, bp, cnt, end, status, eob_idx = (np.array(a) for a in decode(*args, **kw))
        inject(torch.from_numpy(tok.view(np.int32)), eob_idx)
        return tok, bp, cnt, end, status, eob_idx

    cursor_decode = PC.cursor_decode

    def port_injected(args):
        toks = cursor_decode(args)
        inject(toks[0], toks[5])
        return toks

    monkeypatch.setattr(JP, "pallas_cursor_tokenize", jax_injected)
    monkeypatch.setattr(PC, "cursor_decode", port_injected)
    want = _jax(monkeypatch, buf)
    assert want is None or want.tobytes() != src.tobytes()
    assert _port(buf).tobytes() == src.tobytes()


def test_overlap_is_one_constant(monkeypatch):
    """The early start, the decode past the stop and the words slice all
    follow OVERLAP."""
    buf, src = STREAMS["L1"]
    for overlap in (P.OVERLAP, 512):
        monkeypatch.setattr(P, "OVERLAP", overlap)
        lay = P.plan_cursors(buf, STRIDE, MAXC)
        live = lay.active & ~(lay.last & lay.stored)
        assert np.all((lay.stops_dec - lay.stops)[live] == overlap)
        early = lay.active & ~lay.first & ~lay.stored
        assert np.array_equal(lay.starts[early],
                              np.maximum(lay.bstart, _planned(lay) - overlap)[early])
        assert lay.decode_args(buf, "cpu").nwp == PC.words_shape(len(buf), STRIDE, 2 * overlap)[0]
        assert _port(buf).tobytes() == src.tobytes()


def _planned(lay):
    """The cursors' planned starts: the previous cursor's planned stop
    within a block, the block's data start for its first cursor."""
    prev_stop = np.concatenate([[0], lay.stops[:-1]])
    return np.where(lay.first, lay.bstart, prev_stop)
