"""The port's numpy LZ77 (codec/lz77.py) and block splitter
(deflate_blocks.emit_block_adaptive), with its native library switched
off, against tpuzlib's with its library off, on the CPU.

Each level 1-9 searches 32 KiB of each corpus kind behind 32 KiB of
context: find_matches' (length, distance) per position, lazy_parse's
starts, take-match flags and effective lengths, and tokenize_chunk's
token tape must equal tpuzlib's exactly; tokenize_chunk is the
vectorized search with the port's library on too.  emit_block_adaptive
writes tapes of more than 16,384 tokens (its split threshold), one a
text|random transition that it splits, with tpuzlib's bytes.
"""

import numpy as np
import pytest
import torch

from tpuzlib.codec import bitsink as jbitsink
from tpuzlib.codec import deflate_blocks as jblocks
from tpuzlib.codec import lz77 as jlz77
from tpuzlib.native import bindings as jbindings
from tpuzlib_torch import testing
from tpuzlib_torch.codec import bitsink, deflate_blocks, huffman_encode, lz77, tables
from tpuzlib_torch.native import bindings

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

KB = 1 << 10
CHUNKS = {kind: testing.corpus(kind, 64 * KB, seed) for seed, kind in enumerate(testing.KINDS)}


@pytest.fixture
def off(monkeypatch):
    """Both packages without their native library: tpuzlib's as its own
    tests turn it off, the port's by its switch."""
    monkeypatch.setattr(jbindings, "_lib", None)
    monkeypatch.setattr(jbindings, "_tried", True)
    with testing.no_native():
        yield


def test_levels_match():
    assert tables.LEVELS == {lvl: (p.probes, p.lazy, p.max_lazy)
                             for lvl, p in jlz77.LEVELS.items()}
    assert lz77.TOO_FAR == jlz77.TOO_FAR == tables.TOO_FAR


@pytest.mark.parametrize("kind", sorted(CHUNKS))
@pytest.mark.parametrize("level", range(1, 10))
def test_tokens_match_tpuzlib(kind, level, off):
    data, ctx = CHUNKS[kind], 32 * KB
    got = lz77.find_matches(data, ctx, tables.LEVELS[level])
    want = jlz77.find_matches(data, ctx, jlz77.LEVELS[level])
    assert all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want))
    assert (got[0] > 0).any() == (kind != "random")
    parse = lz77.lazy_parse(*got, tables.LEVELS[level])
    jparse = jlz77.lazy_parse(*want, jlz77.LEVELS[level])
    assert all(np.array_equal(g, w) for g, w in zip(parse, jparse))
    tape = lz77.tokenize_chunk(data, ctx, level)
    jtape = jlz77.tokenize_chunk(data, ctx, level)
    assert all(np.array_equal(g, w) and g.dtype == w.dtype == np.int32
               for g, w in zip(tape, jtape))


def test_tokenize_chunk_is_the_vectorized_search(monkeypatch):
    """tokenize_chunk is the vectorized search with the library on and
    off (the engine calls the native matcher itself), with tpuzlib's
    tape without its library; switched off, the port's lib() raises."""
    data = CHUNKS["text"][: 8 * KB]
    on = lz77.tokenize_chunk(data, 0, 6)
    with testing.no_native():
        with pytest.raises(RuntimeError, match="switched off"):
            bindings.lib()
        off_tape = lz77.tokenize_chunk(data, 0, 6)
    monkeypatch.setattr(jbindings, "_lib", None)
    monkeypatch.setattr(jbindings, "_tried", True)
    want = jlz77.tokenize_chunk(data, 0, 6)
    assert all(np.array_equal(a, w) and np.array_equal(b, w)
               for a, b, w in zip(on, off_tape, want))
    assert lz77.tokenize_chunk(np.empty(0, np.uint8), 0, 6)[0].size == 0


def _emit(blocks, sink_cls, litlen, dist, raw, last, adaptive=True):
    sink = sink_cls()
    (blocks.emit_block_adaptive if adaptive else blocks.emit_block)(sink, litlen, dist, raw, last)
    body, val, nbits = sink.flush(final=True)
    return body.tobytes(), val, nbits


@pytest.mark.parametrize("last", [False, True])
def test_emit_block_adaptive_matches_tpuzlib(last, off):
    text, noise = testing.corpus("text", 48 * KB, 7), testing.corpus("random", 24 * KB, 8)
    split = 0
    for raw in (np.concatenate([text, noise]), testing.corpus("vertices", 96 * KB, 9)):
        litlen, dist = lz77.tokenize_chunk(raw, 0, 1)
        assert len(litlen) > 16384
        got = _emit(deflate_blocks, bitsink.BitSink, litlen, dist, raw, last)
        assert got == _emit(jblocks, jbitsink.BitSink, litlen, dist, raw, last)
        lsym, _, _, dsym, _, _ = huffman_encode.token_symbols(litlen, dist)
        freqs = huffman_encode.block_histograms(lsym, dsym, dist > 0)
        assert (deflate_blocks._segment_cost(*freqs, len(raw))
                == jblocks._segment_cost(*freqs, len(raw)) > 0)
        split += got != _emit(deflate_blocks, bitsink.BitSink, litlen, dist, raw, last, False)
    assert split >= 1
