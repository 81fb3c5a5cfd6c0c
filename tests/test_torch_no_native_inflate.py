"""The port's inflate with its native library switched off, on the CPU,
against tpuzlib with its library off (as tpuzlib's own tests turn it
off), exactly: the numpy expansion (codec/expand.py), the host engine's
vectorized decode through inflate(device="cpu") and the Inflater on
corrupted streams, the numpy header scan, the speculative inflate's
numpy tokenizer, and the device route's decode (its kernels' plain
versions) around the numpy scan, repair bridge and expansion.

While the switch is off the port's bindings.lib() raises, so a call that
still reached the library would fail these tests rather than pass them.
"""

import zlib

import numpy as np
import pytest
import torch

import tpuzlib
from tpuzlib.codec import expand as jexpand
from tpuzlib.codec.tokenize import DataError as JDataError
from tpuzlib.native import bindings as jbindings
from tpuzlib.parallel import speculative as jsp
import tpuzlib_torch
from tpuzlib_torch import testing
from tpuzlib_torch.codec import expand
from tpuzlib_torch.codec.tokenize import DataError
from tpuzlib_torch.kernels import inflate_device2 as d2
from tpuzlib_torch.parallel import speculative as sp
from tpuzlib_torch.utils import trace

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

STREAMS = testing.inflate_streams()
TEXT = testing.corpus("text", 20000, 41)
MIXED = testing.mixed(192 << 10, 42)


@pytest.fixture
def off(monkeypatch):
    monkeypatch.setattr(jbindings, "_lib", None)
    monkeypatch.setattr(jbindings, "_tried", True)
    with testing.no_native():
        yield


def _outcome(fn):
    """("bytes", the bytes) or (exception type name, message)."""
    try:
        return "bytes", np.asarray(fn()).tobytes()
    except Exception as e:  # noqa: BLE001 - both packages' exceptions compared
        return type(e).__name__, str(e)


def _tape(raw):
    litlen, dist, _, fin = sp._tokenize_range(raw, 0, len(raw) * 8)
    assert fin
    return np.ascontiguousarray(litlen), np.ascontiguousarray(dist)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_expand_host_matches_tpuzlib(name, monkeypatch):
    """Each stream's tape, whole against no window and its second half
    against the 32 KiB its first half ends with: the port's numpy
    expansion gives tpuzlib's numpy bytes and the native expander's."""
    raw, data = STREAMS[name]
    litlen, dist = _tape(raw)
    half = len(litlen) // 2
    head = int(np.where(dist[:half] > 0, litlen[:half], 1).sum())
    cases = [(litlen, dist, np.empty(0, np.uint8)),
             (litlen[half:], dist[half:], data[max(0, head - (1 << 15)) : head])]
    native = [expand.expand_host(*c) for c in cases]
    with monkeypatch.context() as m:
        m.setattr(jbindings, "_lib", None)
        m.setattr(jbindings, "_tried", True)
        with testing.no_native():
            for case, want in zip(cases, native):
                got = expand.expand_host(*case)
                assert got.tobytes() == jexpand.expand_host(*case).tobytes() == want.tobytes()
    assert native[0].tobytes() == data.tobytes()


def test_expand_too_far_back(off):
    """A distance before the window: DataError with tpuzlib's message, in
    expand_host and in expand_segments' numpy path."""
    litlen, dist = np.array([65, 66, 5], np.int32), np.array([0, 0, 4], np.int32)
    for window in (np.empty(0, np.uint8), np.zeros(1, np.uint8)):
        with pytest.raises(DataError) as ours:
            expand.expand_host(litlen, dist, window)
        with pytest.raises(JDataError) as theirs:
            jexpand.expand_host(litlen, dist, window)
        assert str(ours.value) == str(theirs.value) == "invalid distance too far back"
    assert expand.expand_host(litlen, dist, np.zeros(2, np.uint8)).tobytes() == b"AB\0\0AB\0"
    tapes = [(litlen[:2], dist[:2], 2), (litlen[2:], dist[2:], 5)]
    with pytest.raises(DataError, match="invalid distance too far back"):
        expand.expand_segments(tapes, np.zeros(1, np.uint8), 2)
    assert expand.expand_segments(tapes, np.zeros(2, np.uint8), 2).tobytes() == b"AB\0\0AB\0"


def test_expand_segments_without_the_library():
    """expand_segments expands the tapes one after another through
    expand_host with the library off: the bytes of its native threads,
    over 40 pieces whose windows reach through several."""
    raw, data = STREAMS["L9"]
    litlen, dist = _tape(raw)
    cuts = np.linspace(0, len(litlen), 41).astype(int)
    tapes = [(np.ascontiguousarray(litlen[a:b]), np.ascontiguousarray(dist[a:b]))
             for a, b in zip(cuts[:-1], cuts[1:])]
    window = testing.corpus("text", 1 << 15, 43)
    native = expand.expand_segments([(*t, expand.tape_out_len(*t)) for t in tapes], window, 4)
    with testing.no_native():
        lens = [expand.tape_out_len(*t) for t in tapes]
        got = expand.expand_segments([(*t, n) for t, n in zip(tapes, lens)], window, 4)
    assert got.tobytes() == native.tobytes() == data.tobytes()


def _corrupt():
    """tpuzlib's test_native_vs_vectorized_on_corruption inputs, from a
    seed: a level-9 zlib stream of 20,000 bytes of text with 25 bytes
    flipped one at a time, and the stream cut at 20 places."""
    wire = zlib.compress(TEXT.tobytes(), 9)
    rng = np.random.default_rng(44)
    cases = []
    for _ in range(25):
        mut = bytearray(wire)
        mut[int(rng.integers(0, len(mut)))] ^= 0xFF
        cases.append(bytes(mut))
    cases += [wire[:cut] for cut in np.linspace(3, len(wire) - 1, 20).astype(int).tolist()]
    return cases


CORRUPT = _corrupt()


def _inflater(pkg, wire, raw):
    """The Inflater's verdict: its bytes and finish()'s flags, or the
    exception's type and message."""
    def run():
        inf = pkg.Inflater(raw=raw) if pkg is tpuzlib_torch else pkg.Inflater(
            tpuzlib.api.inflate_api.InflaterOptions(raw=raw))
        bufs = inf.append(wire)
        r = inf.finish()
        return (np.concatenate([np.asarray(b) for b in bufs]) if bufs else np.empty(0, np.uint8),
                r.complete, r.success, r.checksum)

    try:
        out, *flags = run()
        return "ok", out.tobytes(), flags
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, str(e)


@pytest.mark.parametrize("case", range(len(CORRUPT)))
def test_corruption_matches_tpuzlib(case, off):
    """inflate(device="cpu") (the host route) and the Inflater, on the zlib
    stream and on its raw body: tpuzlib's bytes, or its exception type
    and message; the device route's counters never move."""
    wire = CORRUPT[case]
    before = trace.get_counters()
    got = _outcome(lambda: tpuzlib_torch.inflate(wire, device="cpu"))
    assert got == _outcome(lambda: tpuzlib.inflate(wire))
    assert not any(k.startswith("inflate.device") for k in testing.counters_since(before))
    for body, raw in ((wire, False), (wire[2:], True)):
        assert _inflater(tpuzlib_torch, body, raw) == _inflater(tpuzlib, body, raw)


@pytest.mark.parametrize("level", [1, 6])
def test_find_all_block_starts_matches_its_native_scan(level, monkeypatch):
    """The numpy scan equals the native one and tpuzlib's numpy scan, from
    the start and from a header on without final blocks (after tpuzlib's
    test_find_all_block_starts_one_pass_matches_real)."""
    buf = np.frombuffer(testing.zlib_stream(MIXED, level, -15, mem_level=5), np.uint8)
    native = sp.find_all_block_starts(buf)
    assert len(native) > 1
    tail = sp.find_all_block_starts(buf, from_bit=native[1], allow_final=False)
    monkeypatch.setattr(jbindings, "_lib", None)
    monkeypatch.setattr(jbindings, "_tried", True)
    with testing.no_native():
        assert sp.find_all_block_starts(buf) == native == list(jsp.find_all_block_starts(buf))
        assert sp.find_all_block_starts(buf, from_bit=native[1], allow_final=False) == tail


@pytest.mark.parametrize("n_segments", [1, 2, 5])
def test_inflate_parallel_matches_tpuzlib(n_segments, off):
    """The speculative inflate's numpy tokenizer, header candidates and
    expansion: tpuzlib's bytes, and for a zlib container its verdicts."""
    raw = np.frombuffer(testing.zlib_stream(MIXED, 6, -15, flush_every=40 << 10), np.uint8)
    got = sp.inflate_parallel(raw, n_segments=n_segments, max_workers=2)
    assert got.tobytes() == MIXED.tobytes() == np.asarray(
        jsp.inflate_parallel(raw, n_segments=n_segments, max_workers=2)).tobytes()
    assert [sp.find_block_start(raw, len(raw) * s // 5) for s in range(1, 5)] == [
        jsp.find_block_start(raw, len(raw) * s // 5) for s in range(1, 5)]
    wire = zlib.compress(MIXED.tobytes(), 6)
    for w in (wire, wire[:-1] + bytes([wire[-1] ^ 1]), wire[: len(wire) // 2]):
        assert _outcome(lambda: sp.inflate_parallel_container(
            w, n_segments, 2, device="cpu")) == _outcome(
            lambda: jsp.inflate_parallel_container(w, n_segments, 2))


def _counted(fn):
    """fn()'s bytes and the counters it moved."""
    before = trace.get_counters()
    out = fn()
    return out.tobytes(), testing.counters_since(before)


@pytest.mark.parametrize("name", ["L6", "L1"])
def test_device_route_without_the_library(name):
    """The device route's decode (plain versions on the CPU) with the
    numpy header scan and expansion gives every byte: L6's splice
    validates; L1's needs a repair whose bridge decodes with the
    vectorized decoder (tpuzlib's without its library), with the counts
    of the native bridge."""
    raw, data = STREAMS[name]
    native = _counted(lambda: testing.inflate_device_route(raw))
    with testing.no_native():
        got = _counted(lambda: testing.inflate_device_route(raw))
    want = {"inflate.device": len(data)}
    if name == "L1":
        want.update({"inflate.splice_repair": 1, "inflate.repair_bridge": 1})
    assert got == native == (data.tobytes(), want)


@pytest.mark.parametrize("name", ["fixed", "hidden stored"])
def test_repair_bridges_without_the_library(name):
    """A forced splice repair that bridges (four times in the fixed-block
    stream): the vectorized bridge gives the native bridge's bytes and
    counts."""
    raw, data = STREAMS[name]
    run = lambda: d2.decode(raw, device="cpu", force_repair=True)  # noqa: E731
    native = _counted(run)
    with testing.no_native():
        got = _counted(run)
    assert got == native and got[0] == data.tobytes()
    assert got[1]["inflate.repair_bridge"] >= 1
