"""tpuzlib_torch.utils.trace against tpuzlib.utils.trace, on the CPU.

The same calls give the same telemetry (but its seconds and MB/s) and
the same counters; the Deflater and the Inflater record the same stages
as tpuzlib's for the same ragged appends; the decode's repair counters
(inflate.splice_repair, inflate.repair_bridge, inflate.repair_cap_exceeded)
equal tpuzlib's on the same seeded streams (its Pallas decode in
interpret mode, TPUZLIB_FORCE_REPAIR=1 for force_repair=True); and the
encoder's deflate.ext_cap_overflow equals tpuzlib's under
TPUZLIB_TRACE_EXT=1.  Then what the port alone has: its API counters,
the stage names of deflate() and inflate(), profile() writing a Chrome
trace, and a telemetry that records nothing while it is off.
"""

import functools
import glob
import json
import os
import shutil
import sys
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuzlib
import tpuzlib_torch
from tpuzlib.kernels import deflate_device3 as jd3
from tpuzlib.kernels import inflate_device2 as jd2
from tpuzlib.utils import trace as jtrace
from tpuzlib_torch import testing
from tpuzlib_torch.api import inflate_api
from tpuzlib_torch.kernels import deflate_device3 as td3
from tpuzlib_torch.kernels import inflate_device2 as td2
from tpuzlib_torch.utils import trace

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

STREAMS = testing.inflate_streams()
STRIDE, MAXC = 1 << 13, 256
CHUNK, BATCH = 1 << 14, 2
DATA = testing.mixed(300 << 10, 31)
WBITS = {"raw": -15, "deflate": 15, "gzip": 31}


@pytest.fixture(autouse=True)
def _fresh():
    """Both packages' telemetry empty and off, restored afterwards."""
    was = [m.telemetry_enabled() for m in (jtrace, trace)]
    for m in (jtrace, trace):
        m.enable(False)
        m.reset()
    yield
    for m, on in zip((jtrace, trace), was):
        m.enable(on)
        m.reset()


def _moved(before: dict, now: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}


def _shape(telemetry: dict) -> dict:
    """Telemetry without its clock: {stage: (calls, bytes)}."""
    return {k: (v["calls"], v["bytes"]) for k, v in telemetry.items()}


def _stages(m):
    with m.timed_stage("off", 5):
        pass  # telemetry off: nothing recorded
    m.enable()
    for n in (0, 7, 1 << 20):
        with m.timed_stage("a", n):
            pass
    with m.timed_stage("b"):
        pass
    with pytest.raises(KeyError):
        with m.timed_stage("c", 3):
            raise KeyError("a stage that raises still counts")
    got = [m.telemetry_enabled(), m.get_telemetry()]
    m.reset()
    return got + [m.get_telemetry()]


def _counters(m):
    m.reset_counters()
    m.count("x")
    m.count("x", 41)
    m.count("y", 0)
    got = [m.get_counters()]
    m.reset_counters()
    m.count("z", 3)
    return got + [m.get_counters()]


def _both(m):
    m.enable()
    with m.timed_stage("s", 9):
        m.count("n", 2)
    m.enable(False)
    with m.timed_stage("s", 9):
        m.count("n", 2)
    return [m.telemetry_enabled(), m.get_telemetry(), m.get_counters()["n"]]


@pytest.mark.parametrize("drive", [_stages, _counters, _both], ids=lambda f: f.__name__[1:])
def test_same_calls_same_telemetry(drive):
    want, got = drive(jtrace), drive(trace)
    for w, g in zip(want, got):
        if isinstance(w, dict) and w and isinstance(next(iter(w.values())), dict):
            assert _shape(g) == _shape(w)
            assert all(set(v) == {"calls", "bytes", "seconds", "self_seconds", "MBps"}
                       for v in g.values())
        else:
            assert g == w


def test_public_names():
    names = ("enable", "telemetry_enabled", "reset", "get_telemetry", "timed_stage", "count",
             "get_counters", "reset_counters", "profile")
    assert all(callable(getattr(trace, n)) for n in names)
    import tpuzlib.utils as ju
    import tpuzlib_torch.utils as tu

    assert tu.__all__ == ju.__all__ and all(hasattr(tu, n) for n in tu.__all__)


def _feed(obj, data, steps) -> None:
    """Append `data` to obj in pieces of `steps` in turn."""
    off = k = 0
    while off < len(data):
        n = steps[k % len(steps)]
        obj.append(data[off : off + n])
        off, k = off + n, k + 1


@pytest.mark.parametrize("steps", [[1 << 16], [1, 7, 4096, 65537]], ids=["64K", "ragged"])
def test_deflater_and_inflater_stages_match(steps):
    wire = tpuzlib_torch.deflate(DATA, level=6, device="cpu").tobytes()
    got = {}
    for pkg, m in ((tpuzlib, jtrace), (tpuzlib_torch, trace)):
        m.enable()
        d, i = pkg.Deflater(level=1), pkg.Inflater()
        _feed(d, DATA, steps)
        d.finish()
        _feed(i, wire, steps)
        assert i.finish().success
        got[pkg.__name__] = _shape(m.get_telemetry())
    assert got["tpuzlib_torch"] == got["tpuzlib"]
    assert set(got["tpuzlib"]) == {"deflate.append", "deflate.finish", "inflate.append"}


# (stream, the port's keywords, tpuzlib's environment)
REPAIR_CASES = {
    "L1 forced": ("L1", {"force_repair": True}, {"TPUZLIB_FORCE_REPAIR": "1"}),
    "fixed": ("fixed", {}, {}),
    "fixed forced": ("fixed", {"force_repair": True}, {"TPUZLIB_FORCE_REPAIR": "1"}),
    "hidden stored forced": ("hidden stored", {"force_repair": True},
                             {"TPUZLIB_FORCE_REPAIR": "1"}),
    "fixed, bridge cap 0": ("fixed", {"max_bridges": 0}, {"TPUZLIB_REPAIR_MAX_BRIDGES": "0"}),
}


@pytest.mark.parametrize("case", sorted(REPAIR_CASES))
def test_repair_counters_match(monkeypatch, case):
    name, kw, env = REPAIR_CASES[case]
    buf, src = STREAMS[name]
    monkeypatch.setenv("TPUZLIB_PALLAS_TOK", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    before = jtrace.get_counters()
    want = jd2.inflate_device_v2(buf, stride_bits=STRIDE, max_cursors=MAXC)
    jmoved = _moved(before, jtrace.get_counters())
    before = trace.get_counters()
    try:
        got = td2.decode(buf, stride_bits=STRIDE, max_cursors=MAXC, device="cpu", **kw)
    except td2.DeviceDeclined:
        got = None
    assert (got is None) == (want is None)
    assert got is None or got.tobytes() == src.tobytes()
    assert testing.counters_since(before) == jmoved
    assert jmoved  # every case counts: a repair, or a cap that declined


@functools.lru_cache(maxsize=None)
def _jax_tokens():
    """tpuzlib's encoder truncated after its tokens, where it takes the
    overflow count: one small program, traced (under TPUZLIB_TRACE_EXT=1)
    at its first call."""
    return jd3.make_encode_batch_v3(1, CHUNK, BATCH, td3.out_words_for(CHUNK), stage="tokens")


@pytest.mark.parametrize("kind,overflow", [("text", True), ("random", False)])
def test_ext_cap_overflow_matches(monkeypatch, kind, overflow):
    args = td3.batch_arrays(testing.corpus(kind, 2 * CHUNK, 1), (0, 1), CHUNK, BATCH)
    monkeypatch.setenv("TPUZLIB_TRACE_EXT", "1")
    jtrace.reset_counters()
    jax.block_until_ready(_jax_tokens()(*map(jnp.asarray, args)))
    jax.effects_barrier()
    want = jtrace.get_counters()
    trace.enable()
    trace.reset_counters()
    enc = td3.make_encode_batch_v3(1, CHUNK, BATCH, td3.out_words_for(CHUNK))
    enc(*map(torch.from_numpy, args))
    got = trace.get_counters()
    assert got == want and (got["deflate.ext_cap_overflow"] > 0) == overflow


@pytest.mark.parametrize("fmt", ["raw", "deflate", "gzip"])
def test_api_counters(fmt):
    """deflate()'s device route counts its input as deflate.device (never
    a fallback: it has none), its host route (device="cpu") counts
    nothing; inflate()'s device route counts its output as
    inflate.device, its host route (device="cpu") nothing."""
    before = trace.get_counters()
    host = tpuzlib_torch.deflate(DATA, format=fmt, device="cpu")
    assert testing.counters_since(before) == {}
    before = trace.get_counters()
    wire = testing.device_route(DATA, format=fmt)
    assert testing.counters_since(before) == {"deflate.device": len(DATA)}
    assert zlib.decompress(host.tobytes(), WBITS[fmt]) == DATA.tobytes()
    before = trace.get_counters()
    assert testing.inflate_device_route(wire).tobytes() == DATA.tobytes()
    assert testing.counters_since(before) == {"inflate.device": len(DATA)}
    before = trace.get_counters()
    assert tpuzlib_torch.inflate(wire, device="cpu").tobytes() == DATA.tobytes()
    assert testing.counters_since(before) == {}
    assert "deflate.device_fallback" not in trace.get_counters()


PHASES = ("deflate.encode.match", "deflate.encode.parse", "deflate.encode.trees",
          "deflate.encode.pack")


def test_main_path_stages():
    """deflate()'s and inflate()'s device routes run their pieces under
    the stages that chip_smoke.py's phase N reads, with the bytes each
    handles; the encoder's four phases nest in each deflate.encode_batch,
    the final flush in the last deflate.join, the header scan in
    inflate.plan, and each public call runs inside its root stage."""
    trace.enable()
    wire = testing.device_route(DATA, level=6)
    nbatch = -(-len(DATA) // (8 << 18))  # batches of 8 chunks of 256 KiB
    t = trace.get_telemetry()
    assert {k: t[k]["calls"] for k in t} == {
        "deflate.layout": nbatch, "deflate.encode_batch": nbatch, "deflate.pull": nbatch,
        "deflate.join": nbatch + 1, "deflate.checksum": 1, "deflate.flush": 1,
        **{k: nbatch for k in PHASES}}
    assert t["deflate.layout"]["bytes"] == t["deflate.encode_batch"]["bytes"] == len(DATA)
    assert t["deflate.checksum"]["bytes"] == len(DATA) == t["deflate.flush"]["bytes"]
    assert all(t[k]["bytes"] == len(DATA) for k in PHASES)
    # the phases partition the batch, the flush lies inside the last join
    assert sum(t[k]["seconds"] for k in PHASES) <= t["deflate.encode_batch"]["seconds"]
    assert t["deflate.encode_batch"]["self_seconds"] == pytest.approx(
        t["deflate.encode_batch"]["seconds"] - sum(t[k]["seconds"] for k in PHASES), abs=5e-6)
    assert t["deflate.flush"]["seconds"] <= t["deflate.join"]["seconds"]
    trace.reset()
    assert testing.inflate_device_route(wire).tobytes() == DATA.tobytes()
    t = trace.get_telemetry()
    assert set(t) == {"inflate.plan", "inflate.tokenize_dispatch", "inflate.pre_splice",
                      "inflate.splice_pull", "inflate.token_splice", "inflate.comp_pull",
                      "inflate.host_expand", "inflate.checksum"}
    assert all(v["calls"] == 1 for v in t.values())
    assert t["inflate.plan"]["bytes"] == len(wire) - 2 and t["inflate.checksum"]["bytes"] == len(DATA)
    trace.reset()
    raw = td2.decode(np.asarray(wire)[2:-4], device="cpu", device_expand=True, force_repair=True)
    assert raw.numpy().tobytes() == DATA.tobytes()
    assert {"inflate.repair_walk", "inflate.compact", "inflate.device_expand"} <= set(
        trace.get_telemetry())
    assert "inflate.host_expand" not in trace.get_telemetry()
    # a stream of several Huffman blocks: the plan scans its headers once
    text = testing.corpus("text", 600 << 10, 3)
    zraw = tpuzlib_torch.deflate(text, format="raw", device="cpu")
    trace.reset()
    before = trace.get_counters()
    assert testing.inflate_device_route(zraw).tobytes() == text.tobytes()
    t = trace.get_telemetry()
    nblocks = len(td2._plan_blocks(np.asarray(zraw)))
    assert nblocks > 1 and testing.counters_since(before)["inflate.plan_blocks"] == nblocks
    assert _shape({k: t[k] for k in ("inflate.plan", "inflate.plan.scan")}) == {
        "inflate.plan": (1, len(zraw)), "inflate.plan.scan": (1, len(zraw))}
    assert t["inflate.plan.scan"]["seconds"] <= t["inflate.plan"]["seconds"]
    # the public calls' root stages, around their routes' stages
    trace.reset()
    wire = tpuzlib_torch.deflate(DATA, format="gzip", device="cpu")
    assert tpuzlib_torch.inflate(wire, device="cpu").tobytes() == DATA.tobytes()
    assert tpuzlib_torch.crc32(DATA, device="cpu") == zlib.crc32(DATA.tobytes())
    t = trace.get_telemetry()
    assert _shape(t) == {"deflate.call": (1, len(DATA)), "deflate.append": (1, len(DATA)),
                         "deflate.finish": (1, 0), "inflate.call": (1, len(wire)),
                         "inflate.append": (1, len(wire)), "crc32.call": (1, 0),
                         "crc32.launch": (1, len(DATA))}
    for root, inner in (("deflate.call", ("deflate.append", "deflate.finish")),
                        ("inflate.call", ("inflate.append",)), ("crc32.call", ("crc32.launch",))):
        assert t[root]["self_seconds"] == pytest.approx(
            t[root]["seconds"] - sum(t[k]["seconds"] for k in inner), abs=5e-6)


@pytest.mark.parametrize("given", [True, False], ids=["logdir", "no_logdir"])
def test_profile_writes_a_trace(tmp_path, given):
    """profile() writes a Chrome trace of the stages' spans into the
    logdir given, or, given none, into a new directory of its own."""
    logdir = str(tmp_path / "profile") if given else None
    with trace.profile(logdir, device="cpu") as d:
        assert (d == logdir if given else os.path.basename(d).startswith("tpuzlib_torch_profile_"))
        assert trace.telemetry_enabled()
        deflater = tpuzlib_torch.Deflater(level=6)
        deflater.append(DATA[:100_000])
        deflater.append(DATA[100_000:])
        deflater.finish()
    assert not trace.telemetry_enabled()
    assert _shape(trace.get_telemetry()) == {"deflate.append": (2, len(DATA)),
                                             "deflate.finish": (1, 0)}
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    if not given:
        shutil.rmtree(d)
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(spans) == ["deflate.append", "deflate.append", "deflate.finish"]


def test_profile_never_drops_the_card(monkeypatch, tmp_path):
    """Asked for a CUDA device it cannot trace, profile() raises, and
    leaves the telemetry as it was."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cannot trace a CUDA device"):
        with trace.profile(str(tmp_path), device="cuda"):
            pass
    assert not trace.telemetry_enabled() and not os.listdir(tmp_path)


def test_telemetry_off_records_nothing():
    before = trace.get_counters()
    wire = testing.device_route(DATA)
    testing.inflate_device_route(wire)
    tpuzlib_torch.inflate(wire, device="cpu")
    assert trace.get_telemetry() == {}
    # the encoder's device counter is taken only while telemetry is on
    assert "deflate.ext_cap_overflow" not in testing.counters_since(before)


def test_crc32_launch_opens_no_span(tmp_path):
    """Under a profiler, crc32() opens its crc32.call span alone: its
    crc32.launch stage is timed but opens no record_function."""
    with trace.profile(str(tmp_path), device="cpu"):
        assert tpuzlib_torch.crc32(DATA, device="cpu") == zlib.crc32(DATA.tobytes())
    assert _shape(trace.get_telemetry()) == {"crc32.call": (1, 0), "crc32.launch": (1, len(DATA))}
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert [e["name"] for e in events if e.get("cat") == "user_annotation"] == ["crc32.call"]


def test_self_seconds_of_nested_stages():
    """A stage's self seconds are its seconds less those of the stages
    opened directly inside it on its thread; a second thread's stages
    keep their own stack and take nothing from the first's."""
    trace.enable()
    opened = threading.Event()
    finish = threading.Event()

    def other():
        with trace.timed_stage("thread.outer"):
            with trace.timed_stage("thread.inner"):
                opened.set()
                finish.wait(10)

    worker = threading.Thread(target=other)
    with trace.timed_stage("outer"):
        worker.start()
        opened.wait(10)
        time.sleep(0.01)
        with trace.timed_stage("mid"):
            with trace.timed_stage("inner"):
                time.sleep(0.01)
            time.sleep(0.01)
        with trace.timed_stage("mid"):
            pass
        finish.set()
        worker.join(10)
    assert not worker.is_alive()
    t = trace.get_telemetry()
    secs = {k: v["seconds"] for k, v in t.items()}
    own = {k: v["self_seconds"] for k, v in t.items()}
    assert own["inner"] == secs["inner"] and own["thread.inner"] == secs["thread.inner"]
    assert own["mid"] == pytest.approx(secs["mid"] - secs["inner"], abs=5e-6)
    assert own["outer"] == pytest.approx(secs["outer"] - secs["mid"], abs=5e-6)
    assert own["outer"] >= 0.009  # the sleep before mid, and not the thread's stages
    assert own["thread.outer"] == pytest.approx(secs["thread.outer"] - secs["thread.inner"],
                                                abs=5e-6)
    assert t["mid"]["calls"] == 2


def test_stages_from_many_threads():
    """More threads than cores open nested stages at once, with a short
    switch interval: no call is lost, and each thread's stack keeps the
    outer stages' self seconds to their own."""
    trace.enable()
    nthreads, reps = (os.cpu_count() or 1) + 2, 200
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work():
            for _ in range(reps):
                with trace.timed_stage("outer", 1):
                    with trace.timed_stage("inner", 2):
                        pass

        workers = [threading.Thread(target=work) for _ in range(nthreads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(was)
    t = trace.get_telemetry()
    n = nthreads * reps
    assert _shape(t) == {"outer": (n, n), "inner": (n, 2 * n)}
    assert t["outer"]["self_seconds"] == pytest.approx(
        t["outer"]["seconds"] - t["inner"]["seconds"], abs=1e-4)
    assert t["inner"]["self_seconds"] == t["inner"]["seconds"]


def test_count_copy_rules():
    """The copy counters count only with the telemetry on, never a copy
    whose card side is the CPU, and size tensors, arrays and tuples."""
    before = trace.get_counters()
    trace.count_copy("h2d", "cuda", np.zeros(10, np.uint8))
    assert testing.counters_since(before) == {}
    trace.enable()
    trace.count_copy("h2d", "cuda", np.zeros(10, np.uint8), torch.zeros(3, dtype=torch.int64))
    trace.count_copy("d2h", torch.device("cuda", 1), (torch.zeros(2, 5, dtype=torch.int32),))
    trace.count_copy("h2d", "cpu", np.zeros(10, np.uint8))
    trace.count_copy("d2h", torch.device("cpu"), torch.zeros(4))
    assert testing.counters_since(before) == {"copy.h2d_bytes": 34, "copy.d2h_bytes": 40}


def _zlib_wire():
    return tpuzlib_torch.deflate(DATA, device="cpu")


def _declines(monkeypatch):
    def decline(*args, **kwargs):
        raise td2.DeviceDeclined("declined for the test")

    monkeypatch.setattr(inflate_api, "decode_stream", decline)


def _mismatches(monkeypatch):
    monkeypatch.setattr(inflate_api, "adler32", lambda *args, **kwargs: 0)


@pytest.mark.parametrize("force,counter", [(_declines, "inflate.device_fallback"),
                                           (_mismatches, "inflate.device_mismatch_fallback")],
                         ids=["declined", "mismatch"])
def test_declined_attempt_is_recorded(monkeypatch, force, counter):
    """A device-route attempt that ends on the host engine adds one
    inflate.declined call with the stream's bytes; one that succeeds adds
    none."""
    wire = _zlib_wire()
    trace.enable()
    assert testing.inflate_device_route(wire).tobytes() == DATA.tobytes()
    assert "inflate.declined" not in trace.get_telemetry()
    force(monkeypatch)
    before = trace.get_counters()
    assert testing.inflate_device_route(wire) is None
    moved = testing.counters_since(before)
    assert moved[counter] == 1 and "inflate.device" not in moved
    t = trace.get_telemetry()
    assert _shape({"inflate.declined": t["inflate.declined"]}) == {
        "inflate.declined": (1, len(wire))}
    assert t["inflate.declined"]["seconds"] > 0


def test_new_stages_record_nothing_while_off(monkeypatch):
    """With the telemetry off, a declined attempt, the public calls, the
    encoder's phases and the plan's scan record no stage, and no copy or
    plan counter moves."""
    text = testing.corpus("text", 600 << 10, 3)
    zraw = tpuzlib_torch.deflate(text, format="raw", device="cpu")
    wire = _zlib_wire()
    before = trace.get_counters()
    testing.device_route(DATA)
    testing.inflate_device_route(zraw)
    tpuzlib_torch.inflate(wire, device="cpu")
    tpuzlib_torch.crc32(DATA, device="cpu")
    _declines(monkeypatch)
    assert testing.inflate_device_route(wire) is None
    assert trace.get_telemetry() == {}
    assert set(testing.counters_since(before)) == {"deflate.device", "inflate.device",
                                                   "inflate.device_fallback"}
