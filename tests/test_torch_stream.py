"""tpuzlib_torch's byte outputs against tpuzlib's: deflate_device_v3,
deflate() and DeviceDeflater, including a stream handed over mid-way
from tpuzlib's DeviceDeflater to the port's.  Every output must also
decode with python's zlib."""

import zlib

import numpy as np
import pytest
import torch

import tpuzlib
import tpuzlib_torch
from tpuzlib.kernels import deflate_device3 as jd3
from tpuzlib_torch import testing
from tpuzlib_torch.kernels import deflate_device3 as td3

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

CHUNK, BATCH = 1 << 14, 2
KB = 1 << 10


def _stream():
    """Five and a half chunks: text, an incompressible chunk (written as
    stored blocks), runs, vertex data and a partial last chunk."""
    return np.concatenate([
        testing.corpus("text", 24 * KB, 21), testing.corpus("random", 20 * KB, 22),
        testing.corpus("runs", 20 * KB, 23), testing.corpus("vertices", 12 * KB, 24),
        testing.corpus("text", 12 * KB + 777, 25),
    ])


def test_deflate_device_v3_bytes_match():
    data = _stream()
    assert -(-len(data) // CHUNK) > 2 * BATCH  # several batch groups
    want = np.asarray(jd3.deflate_device_v3(data, level=6, chunk=CHUNK, batch=BATCH))
    got = td3.deflate_device_v3(data, level=6, chunk=CHUNK, batch=BATCH, device="cpu")
    assert got.tobytes() == want.tobytes()
    assert zlib.decompress(got.tobytes(), -15) == data.tobytes()
    # the random chunk went out as stored blocks: the output holds it verbatim
    assert data[24 * KB + CHUNK // 2 : 24 * KB + CHUNK // 2 + 512].tobytes() in got.tobytes()


def test_deflate_matches_tpuzlib_device_route(monkeypatch):
    """1 MiB at level 6 in the zlib container: tpuzlib's device route
    (opt-in by TPUZLIB_DEVICE=1) and the port's (deflate()'s route on a
    card from 1 MiB, run here on the CPU) give the same bytes."""
    monkeypatch.setenv("TPUZLIB_DEVICE", "1")
    data = testing.mixed(1 << 20, 7)
    want = tpuzlib.deflate(data, level=6)
    got = testing.device_route(data, level=6)
    assert got.tobytes() == np.asarray(want).tobytes()
    assert zlib.decompress(got.tobytes()) == data.tobytes()


def _appends(d, data, sizes):
    outs, off = [], 0
    for n in sizes:
        outs.append(np.asarray(d.append(data[off : off + n])).tobytes())
        off += n
    return outs, off


SIZES = [5000, 40000, 1, 17000, 24000]  # ends after an encoded (not stored) chunk


def test_device_deflater_bytes_match():
    data = _stream()
    jd = jd3.DeviceDeflater(level=6, chunk=CHUNK, batch=BATCH)
    td = tpuzlib_torch.DeviceDeflater(level=6, chunk=CHUNK, batch=BATCH, device="cpu")
    want, off = _appends(jd, data, SIZES)
    got, _ = _appends(td, data, SIZES)
    assert got == want  # every append's output, not only the whole stream
    rest = data[off:]
    want.append(np.asarray(jd.append(rest)).tobytes() + np.asarray(jd.finish()).tobytes())
    got.append(np.asarray(td.append(rest)).tobytes() + np.asarray(td.finish()).tobytes())
    assert got == want
    assert zlib.decompress(b"".join(got), -15) == data.tobytes()
    with pytest.raises(RuntimeError):
        td.append(b"x")


def test_device_deflater_handover():
    """Stop tpuzlib's DeviceDeflater mid-stream, move its state into the
    port, finish both: the bytes are identical."""
    data = _stream()
    jd = jd3.DeviceDeflater(level=6, chunk=CHUNK, batch=BATCH)
    head, off = _appends(jd, data, SIZES)
    sink = jd._sink
    carry_val = int(sink._vals[0][0]) if sink._vals else 0
    carry_bits = sink.total_bits
    assert 0 < carry_bits < 8 and jd._ctx_valid > 0 and len(jd._pending)
    td = testing.device_deflater_from_numpy(
        6, CHUNK, BATCH, np.asarray(jd._ctx), jd._ctx_valid, jd._pending,
        carry_val, carry_bits, device="cpu",
    )
    rest = data[off:]
    want = np.asarray(jd.append(rest)).tobytes() + np.asarray(jd.finish()).tobytes()
    got = np.asarray(td.append(rest)).tobytes() + np.asarray(td.finish()).tobytes()
    assert got == want
    assert zlib.decompress(b"".join(head) + got, -15) == data.tobytes()


@pytest.mark.parametrize("size", [1000, 40000])
def test_device_deflater_keeps_its_own_pending_input(size):
    """A caller reuses one buffer between appends: the bytes that wait for
    a later append are the ones appended, not what the buffer holds later
    (tpuzlib's DeviceDeflater keeps a view and writes 2 * size B's)."""
    d = tpuzlib_torch.DeviceDeflater(level=6, chunk=CHUNK, batch=BATCH, device="cpu")
    buf = bytearray(b"A" * size)
    parts = [d.append(buf)]
    buf[:] = b"B" * size
    parts += [d.append(buf), d.finish()]
    wire = b"".join(np.asarray(p).tobytes() for p in parts)
    assert zlib.decompress(wire, -15) == b"A" * size + b"B" * size
