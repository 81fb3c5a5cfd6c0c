"""tpuzlib_torch's host deflate engine against tpuzlib's, on the CPU.

The tokenizer (tz_deflate_tokenize), the whole-chunk emit (tz_emit_chunk)
and DeflateEngine are copies of tpuzlib's native route; here they meet
the same seeded inputs and must give the same tapes, histograms and
bytes.  tz_emit_chunk is also held to the port's plain emit
(emit_chunk_native: numpy splitter and trees over tz_emit_tokens).  The
engine's bytes depend on the core count, so both packages' _ncores are
fixed to the same value.  Every stream must decode with python's zlib,
and every chunk boundary must be a byte-aligned resume point.
"""

import zlib

import numpy as np
import pytest
import torch

from tpuzlib.codec import deflate_engine as jengine
from tpuzlib.codec import emit_native as jemit
from tpuzlib.native import api as jnative_api
from tpuzlib_torch import testing
from tpuzlib_torch.codec import deflate_engine as engine
from tpuzlib_torch.codec import emit_native as emit
from tpuzlib_torch.codec import huffman_encode as he
from tpuzlib_torch.codec import tables
from tpuzlib_torch.codec.bitsink import BitSink
from tpuzlib_torch.codec.deflate_blocks import emit_stored
from tpuzlib_torch.codec.expand import expand_host
from tpuzlib_torch.native import api as native_api

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

KB = 1 << 10


def _cases():
    rng = np.random.default_rng(7)
    block = rng.integers(0, 256, 1000, dtype=np.uint8)
    return {
        "mixed": testing.mixed(600 * KB, 5),
        "text": testing.corpus("text", 200 * KB, 1),
        "vertices": testing.corpus("vertices", 100 * KB, 2),
        "random": rng.integers(0, 256, 70 * KB, dtype=np.uint8),
        "one byte": np.full(50 * KB, 97, np.uint8),
        # a 32,768-byte distance and 258-byte matches
        "far": np.concatenate([block, np.zeros(31768, np.uint8), block,
                               np.full(300, ord("z"), np.uint8)]),
        "two": np.frombuffer(b"xy", np.uint8),
        "empty": np.empty(0, np.uint8),
    }


CASES = _cases()


@pytest.fixture
def ncores(monkeypatch):
    """Sets both packages' core count to the same value."""
    def set_(n):
        monkeypatch.setattr(engine, "_ncores", lambda: n)
        monkeypatch.setattr(jengine, "_ncores", lambda: n)
    return set_


@pytest.mark.parametrize("level", range(1, 10))
def test_tokenize_matches_tpuzlib(level):
    """Tapes, stripe histograms and stripe ends, with and without context;
    the tape expands to its input."""
    for name, d in CASES.items():
        for ctx_len in (0, min(len(d) // 3, 32 * KB)):
            got = emit.tokenize_full(d, ctx_len, level)
            want = jemit.tokenize_full(d, ctx_len, level)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg="%s ctx %d" % (name, ctx_len))
            litlen, dist, lf, df, soe = got
            assert expand_host(litlen, dist, d[:ctx_len]).tobytes() == d[ctx_len:].tobytes()
            # the histograms count the tape's symbols, the stripe ends its output
            lsym, _, _, dsym, _, _ = he.token_symbols(litlen, dist)
            np.testing.assert_array_equal(lf.sum(0), np.bincount(lsym, minlength=286)[:286])
            np.testing.assert_array_equal(df.sum(0), np.bincount(dsym[dist > 0], minlength=30))
            assert int(soe[-1]) == len(d) - ctx_len
            tape = native_api.tokenize(d, ctx_len, level)
            for g, w in zip(tape, jnative_api.tokenize(d, ctx_len, level)):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("level", range(1, 10))
def test_emit_chunk_c_matches_plain_and_tpuzlib(level):
    """tz_emit_chunk against the port's plain emit and tpuzlib's
    emit_chunk_c on the same tapes, as the last chunk and with a sync
    flush; every output decodes."""
    for name, d in CASES.items():
        litlen, dist, lf, df, soe = emit.tokenize_full(d, 0, level)
        for last in (True, False):
            got = emit.emit_chunk_c(litlen, dist, lf, df, soe, d, last, not last)
            assert got.tobytes() == jemit.emit_chunk_c(litlen, dist, lf, df, soe, d, last,
                                                       not last).tobytes(), name
            sink = BitSink()
            emit.emit_chunk_native(sink, litlen, dist, lf, df, soe, d, last)
            if not last:
                emit_stored(sink, np.empty(0, np.uint8), False)
            plain, _, _ = sink.flush(final=True)
            assert got.tobytes() == plain.tobytes(), (name, last)
            do = zlib.decompressobj(-15)
            assert do.decompress(got.tobytes()) == d.tobytes()
            assert do.eof == last


def test_code_maps_match_tpuzlib():
    from tpuzlib.codec import tables as jtables

    lengths = np.arange(3, 259)
    np.testing.assert_array_equal(tables.length_to_code(lengths), jtables.length_to_code(lengths))
    dists = np.arange(1, 32769)
    np.testing.assert_array_equal(tables.dist_to_code(dists), jtables.dist_to_code(dists))
    assert tables.length_to_code(np.array([3, 258])).tolist() == [257, 285]
    assert tables.dist_to_code(np.array([1, 32768])).tolist() == [0, 29]


@pytest.mark.parametrize("cores", [1, 8])
@pytest.mark.parametrize("level", [1, 4, 6, 9])
def test_engine_matches_tpuzlib(ncores, cores, level):
    """DeflateEngine output, append by append, at sizes that take push's
    parallel branch (>= 2 CHUNK + HOLDBACK pending) and finish's (more
    than 256 KiB pending), with and without a dictionary."""
    ncores(cores)
    data = testing.mixed(2200 * KB, 9)
    zdict = testing.corpus("text", 40 * KB, 4)
    for data_, steps, dictionary in ((data, [len(data)], None),
                                     (data, [1, 7, 4 * KB, 1 << 20], None),
                                     (data, [300 * KB], zdict), (data[:0], [1], None)):
        got_e = engine.DeflateEngine(level, dictionary)
        want_e = jengine.DeflateEngine(level, dictionary)
        got, want, off, k = [], [], 0, 0
        while off < len(data_):
            piece = data_[off : off + steps[k % len(steps)]]
            got.append(got_e.push(piece).tobytes())
            want.append(want_e.push(piece).tobytes())
            off, k = off + len(piece), k + 1
        got.append(got_e.finish().tobytes())
        want.append(want_e.finish().tobytes())
        assert got == want, (steps, dictionary is not None)
        do = zlib.decompressobj(-15, zdict=dictionary.tobytes() if dictionary is not None else b"")
        assert do.decompress(b"".join(got)) == data_.tobytes() and do.eof


@pytest.mark.parametrize("cores", [1, 8])
def test_chunk_boundaries_are_byte_aligned_resume_points(ncores, cores):
    """Each output push() returns ends on a byte-aligned sync flush, and a
    raw inflate that starts there with the last 32 KiB as its dictionary
    decodes the rest of the stream."""
    ncores(cores)
    data = testing.mixed(3 << 20, 12)
    e = engine.DeflateEngine(6)
    pieces, ends, off = [], [], 0
    for step in (engine.CHUNK + engine.HOLDBACK, 1 << 20, 5 * engine.CHUNK // 2, len(data)):
        out = e.push(data[off : off + step])
        off = min(off + step, len(data))
        if len(out):
            pieces.append(out.tobytes())
            ends.append(off - len(e.pending))
    pieces.append(e.finish().tobytes())
    assert len(ends) >= 3
    for k, end in enumerate(ends):
        head = b"".join(pieces[: k + 1])
        # the empty stored block of a sync flush closes each piece
        assert head.endswith(b"\x00\x00\xff\xff")
        assert zlib.decompressobj(-15).decompress(head) == data[:end].tobytes()
        window = data[max(0, end - (32 * KB)) : end].tobytes()
        do = zlib.decompressobj(-15, zdict=window)
        assert do.decompress(b"".join(pieces[k + 1 :])) == data[end:].tobytes() and do.eof
