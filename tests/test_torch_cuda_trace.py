"""utils/trace.py on the card: profile() records the port's kernels, the
encoder's device-resident overflow counter adds no host sync and equals
the CPU's, and the copy counters give the bytes the code moves.

Every test here is marked `cuda` and skips without a CUDA card.  The CPU
tests (test_torch_trace.py) hold the telemetry and the counters to
tpuzlib's.  On a machine with a card (and no JAX, which tests/conftest.py
imports), from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_trace.py
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import tpuzlib_torch
from tpuzlib_torch import testing
from tpuzlib_torch.kernels import deflate_device3 as d3
from tpuzlib_torch.kernels import header_scan as HS
from tpuzlib_torch.kernels import inflate_device2 as d2
from tpuzlib_torch.utils import trace

pytestmark = pytest.mark.cuda

CHUNK, BATCH = 1 << 18, 8
# the kernels of a level-6 deflate() and of inflate() of its stream
DEFLATE_KERNELS = ("near_screen_kernel", "far_screen_kernel", "segment_parse_kernel",
                   "pack_words_kernel", "adler32_scalar_kernel")
INFLATE_KERNELS = ("inflate_lut_kernel", "inflate_decode_kernel", "adler32_scalar_kernel")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh():
    was = trace.telemetry_enabled()
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(was)
    trace.reset()


def _kernel_names(logdir) -> list:
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "kernel"]


def test_profile_records_the_kernels(dev, tmp_path):
    """A 1 MiB deflate() and inflate() on the card, each inside profile():
    the trace holds each kernel of its path, and the bytes are those of
    a run with the telemetry off."""
    data = testing.mixed(1 << 20, 5)
    wire = tpuzlib_torch.deflate(data, device=dev)
    assert tpuzlib_torch.inflate(wire, device=dev).tobytes() == data.tobytes()
    for name, fn, kernels in (
            ("deflate", lambda: tpuzlib_torch.deflate(data, device=dev), DEFLATE_KERNELS),
            ("inflate", lambda: tpuzlib_torch.inflate(wire, device=dev), INFLATE_KERNELS)):
        logdir = str(tmp_path / name)
        with trace.profile(logdir) as d:
            out = fn()
            torch.cuda.synchronize()
        assert d == logdir and not trace.telemetry_enabled()
        assert out.tobytes() == (wire if name == "deflate" else data).tobytes()
        names = _kernel_names(logdir)
        missing = [k for k in kernels if not any(k in n for n in names)]
        assert not missing, (name, missing)
    stages = trace.get_telemetry()
    assert {"deflate.encode_batch", "deflate.join", "inflate.plan",
            "inflate.tokenize_dispatch"} <= set(stages)


def _batch(dev, kind="text", chunk=CHUNK, batch=BATCH):
    data = testing.corpus(kind, chunk * batch, 3)
    return [torch.from_numpy(a).to(dev)
            for a in d3.batch_arrays(data, range(batch), chunk, batch)]


def test_overflow_counter_adds_no_sync(dev):
    """With the telemetry on, a warm encoder batch, its overflow counter
    included, runs under set_sync_debug_mode("error"): it uploads and
    reads back nothing."""
    enc = d3.make_encode_batch_v3(6, CHUNK, BATCH, d3.out_words_for(CHUNK))
    args = _batch(dev)
    trace.enable()
    enc(*args)
    torch.cuda.synchronize()
    trace.reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = enc(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(t.is_cuda for t in out)
    assert "deflate.ext_cap_overflow" in trace.get_counters()


@pytest.mark.parametrize("kind,count", [("text", 5039), ("vertices", 74), ("random", 0)])
def test_overflow_counter_equals_cpu(dev, kind, count):
    """The card's deflate.ext_cap_overflow equals the CPU's on the same
    batch (level 6, 4 chunks of 64 KiB, small enough for the plain
    versions), with the count the CPU gives for it."""
    chunk, batch = 1 << 16, 4
    enc = d3.make_encode_batch_v3(6, chunk, batch, d3.out_words_for(chunk))
    args = _batch(dev, kind, chunk, batch)
    trace.enable()
    got = {}
    for where, a in (("cuda", args), ("cpu", [t.cpu() for t in args])):
        trace.reset_counters()
        words, bits, ok = enc(*a)
        got[where] = (trace.get_counters()["deflate.ext_cap_overflow"],
                      np.asarray(bits.cpu()).tolist(), np.asarray(ok.cpu()).tolist())
    assert got["cuda"] == got["cpu"] and got["cpu"][0] == count


def test_copy_counters_of_deflate_and_inflate(dev):
    """copy.h2d_bytes and copy.d2h_bytes of a warm 2 MiB level-6 zlib
    deflate() and of inflate() of its stream equal the bytes the code
    moves: deflate() uploads one batch of 8 chunks with their 32 KiB
    contexts and its four int32 columns, then the input again for the
    Adler-32, and reads back the words (int64), the bits and ok (int32)
    and the 8-byte Adler-32; inflate() uploads the decode's inputs, the
    splice's cursor arrays and the output for the Adler-32, and reads back the highest slice start
    (int32), the splice's meta, the kept tokens and the Adler-32; its plan's
    header scan runs on the card over the decode's stream words (uploaded
    once) and reads back its two counts and first positions (int32)."""
    n = 2 << 20
    data = testing.mixed(n, 7)
    wire = tpuzlib_torch.deflate(data, device=dev)
    assert tpuzlib_torch.inflate(wire, device=dev).tobytes() == data.tobytes()
    trace.enable()
    before = trace.get_counters()
    assert tpuzlib_torch.deflate(data, device=dev).tobytes() == wire.tobytes()
    moved = testing.counters_since(before)
    rows, words = n // CHUNK, d3.out_words_for(CHUNK)
    assert moved["copy.h2d_bytes"] == rows * (d3.CTX + CHUNK) + 3 * 4 * rows + n
    assert moved["copy.d2h_bytes"] == rows * words * 8 + 2 * 4 * rows + 8
    trace.reset()
    before = trace.get_counters()
    assert tpuzlib_torch.inflate(wire, device=dev).tobytes() == data.tobytes()
    moved = testing.counters_since(before)
    t = trace.get_telemetry()
    assert "inflate.compact" not in t and "inflate.declined" not in t  # no repair, no decline
    buf = np.asarray(wire)[2:]
    lay = d2.plan_cursors(buf)
    a = lay.decode_args(buf, "cpu")
    splice = (lay.stops, lay.bstart, lay.first, lay.last, lay.expect_eob, lay.active)
    assert moved["copy.h2d_bytes"] == (trace.size_of((a.words, a.cur, a.tabs, a.lents, a.dents))
                                       + trace.size_of(splice) + n)
    assert moved["inflate.scan_card"] > 0
    scan = 4 * (2 + min(HS._first_cap(len(buf) * 8), HS.HEAD))
    assert moved["copy.d2h_bytes"] == (4 + t["inflate.splice_pull"]["bytes"]
                                       + t["inflate.comp_pull"]["bytes"] + 8 + scan)


def test_copy_counters_of_crc32(dev):
    """crc32() of a card tensor reads back 8 bytes and uploads nothing; of
    a host buffer it uploads the buffer too."""
    data = testing.mixed(1 << 18, 9)
    on_card = torch.from_numpy(data).to(dev)
    trace.enable()
    for source, h2d in ((on_card, 0), (data, len(data)), (data.tobytes(), len(data))):
        before = trace.get_counters()
        tpuzlib_torch.crc32(source)
        moved = testing.counters_since(before)
        assert moved.get("copy.h2d_bytes", 0) == h2d and moved["copy.d2h_bytes"] == 8
    t = trace.get_telemetry()
    assert t["crc32.call"]["calls"] == t["crc32.launch"]["calls"] == 3
