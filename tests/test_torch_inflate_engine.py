"""The port's host inflate engine against tpuzlib's, on the CPU.

RawInflateEngine (codec/engine.py), InflateStream and inflate_raw
(native/api.py) are copies of tpuzlib's; here they meet the same inputs:
every stream of `testing.inflate_streams()` appended in pieces of 1, 7,
4,096 and 65,536 bytes (1-byte pieces on the 4 KiB streams; the first
pushes then run the vectorized decode, the rest the native decoder's
mid-block resume), corrupted copies of them (the same output a push and
the same error at the same push), raw streams with a preset dictionary
(clipped to 32K-1 bytes), and the native decoder's overflow resume on
streams that expand far beyond its first buffer (16 MiB of one byte).
Every comparison is exact: bytes, bit positions, statuses and messages.
"""

import zlib

import numpy as np
import pytest
import torch

from tpuzlib.codec.engine import RawInflateEngine as JEngine
from tpuzlib.native import api as jnative_api
from tpuzlib_torch import testing
from tpuzlib_torch.codec import tokenize as tk
from tpuzlib_torch.codec.engine import RawInflateEngine
from tpuzlib_torch.native import api as native_api
from tpuzlib_torch.native import bindings

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

STREAMS = testing.inflate_streams()
SMALL = testing.inflate_streams(1 << 12, seed=1)


def _drive(engine, raw: np.ndarray, split: int):
    """The engine's output a push over `raw` in pieces of `split` bytes,
    then its state; an error ends the run as (type name, message) at the
    push that raised it."""
    outs = []
    try:
        for i in range(0, len(raw), split):
            outs.append(engine.push(raw[i : i + split]).tobytes())
        outs.append(engine.push(None).tobytes())
    except (tk.DataError, ValueError) as e:
        outs.append((type(e).__name__, str(e)))
        return outs, None
    state = (engine.finished, engine.total_out, engine.bit_pos)
    if engine.finished:
        state += (engine.take_leftover().tobytes(),)
    return outs, state


def _same_run(raw, split, dictionary=None, want=None):
    got = _drive(RawInflateEngine(dictionary), raw, split)
    assert got == _drive(JEngine(dictionary), raw, split)
    if want is not None:
        outs, state = got
        assert b"".join(outs) == want.tobytes() and state[0]
    return got


@pytest.mark.parametrize("split", [7, 4096, 65536])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_engine_appends_match_tpuzlib(name, split):
    raw, data = STREAMS[name]
    _same_run(raw, split, want=data)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_engine_one_byte_appends_match_tpuzlib(name):
    raw, data = SMALL[name]
    _same_run(raw, 1, want=data)
    # bytes after the final block stay for the container's trailer
    outs, state = _same_run(np.concatenate([raw, np.arange(9, dtype=np.uint8)]), 1)
    assert state[3].endswith(bytes(range(9)))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_engine_errors_match_tpuzlib(name):
    """Flipped bits, a flipped byte and a cut: the same outputs and the
    same error, at 4,096 bytes a push, and at 1 for a flip and the cut."""
    raw, _ = SMALL[name]
    rng = np.random.default_rng(len(raw))
    bad = []
    for _ in range(3):
        b = raw.copy()
        i = int(rng.integers(0, len(b)))
        b[i] ^= np.uint8(1 << int(rng.integers(0, 8)))
        bad.append(b)
    b = raw.copy()
    b[len(b) // 3] ^= np.uint8(0xFF)
    bad += [b, raw[: len(raw) * 2 // 3]]
    for k, b in enumerate(bad):
        for split in (1, 4096) if k in (0, len(bad) - 1) else (4096,):
            _same_run(b, split)


def _dict_stream(data: np.ndarray, zdict: bytes) -> np.ndarray:
    c = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=zdict)
    return np.frombuffer(c.compress(data.tobytes()) + c.flush(), np.uint8)


@pytest.mark.parametrize("dict_len", [1, 512, 32767, 40000])
def test_dictionaries_match_tpuzlib(dict_len):
    """A raw stream written against a preset dictionary: the engine with the
    dictionary, set at start or by set_dictionary, and inflate_raw; a
    dictionary over 32K-1 bytes is clipped to its last 32K-1."""
    data = STREAMS["L6"][1]
    zdict = testing.corpus("text", dict_len, seed=dict_len)
    raw = _dict_stream(data, zdict.tobytes()[-32768:])
    for split in (1024, 65536):
        _same_run(raw, split, zdict, want=data)
    e, je = RawInflateEngine(), JEngine()
    e.set_dictionary(zdict)
    je.set_dictionary(zdict)
    assert _drive(e, raw, 4096) == _drive(je, raw, 4096)
    got = native_api.inflate_raw(raw, 0, zdict)
    assert got[0].tobytes() == data.tobytes()
    want = jnative_api.inflate_raw(raw, 0, zdict)
    assert got[0].tobytes() == want[0].tobytes() and got[1:] == want[1:]
    assert got[2] == native_api.STATUS_OK
    # without it the stream reaches before its first byte: the expansion's
    # error, as tpuzlib's (codec/expand.py); zlib finds no match in a
    # 1-byte dictionary, so that stream decodes without one
    outs, _ = _same_run(raw, 65536)
    if dict_len > 1:
        assert outs[-1] == ("DataError", "invalid distance too far back")


@pytest.mark.parametrize("split", [None, 4096])
def test_overflow_resume_matches_tpuzlib(split):
    """16 MiB of one byte expands ~1,000 times: InflateStream.push resumes
    from the C state with doubled buffers, through inflate_raw and
    through the engine's pushes."""
    data = np.full(16 << 20, 0x61, np.uint8)
    raw = np.frombuffer(testing.zlib_stream(data, 6, -15), np.uint8)
    assert len(data) > 4 * len(raw) + (1 << 16)
    if split is None:
        got, want = native_api.inflate_raw(raw), jnative_api.inflate_raw(raw)
        assert got[0].tobytes() == want[0].tobytes() == data.tobytes()
        assert got[1:] == want[1:] and got[2] == native_api.STATUS_OK
        return
    _same_run(raw, split, want=data)


def test_inflate_raw_entry_point():
    """tz_inflate_raw (a fresh state a call) gives InflateStream's bytes,
    bit count and status; a cut stream ends with STATUS_NEED_MORE."""
    raw, data = STREAMS["L9"]
    lib = bindings.lib()
    for src, status in ((raw, native_api.STATUS_OK), (raw[: len(raw) // 2],
                                                      native_api.STATUS_NEED_MORE)):
        dst = np.empty(len(data) + (1 << 16), np.uint8)
        out_len, consumed = bindings.out_scalars(np.int64, np.int64)
        got = lib.tz_inflate_raw(bindings.ptr(src), len(src), 0, bindings.ptr(dst), len(dst), 0,
                                 bindings.ptr(out_len), bindings.ptr(consumed))
        want = native_api.inflate_raw(src)
        assert got == want[2] == status and int(consumed[0]) == want[1]
        assert dst[: int(out_len[0])].tobytes() == want[0].tobytes()
