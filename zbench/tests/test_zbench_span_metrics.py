"""The per-layer metrics that read the port's encoder phases, final flush,
plan scan and loop, declined attempts, copy counters and crc32 launch
stage: each reads its number from a fabricated run, and reads nothing
from a run of a program without those stages, counters and self
seconds."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from zbench import harness  # noqa: E402

MiB = 1 << 20
IN, OUT = 64 * MiB, 32 * MiB  # two calls' bytes in and out


def metric(name):
    return harness.load_module(os.path.join(ROOT, "zbench", "metrics", name + ".py")).read


def run(entry, stages=None, counters=None, calls=2, own=True):
    """A run of `calls` calls; stages: {name: seconds} or {name: (seconds,
    self seconds)}; own=False: a program whose stages carry no self
    seconds."""
    each = [harness.Call(0.0, 1.0, IN // calls, OUT // calls) for _ in range(calls)]
    out = {}
    for k, s in (stages or {}).items():
        secs, self_secs = s if isinstance(s, tuple) else (s, s)
        out[k] = {"calls": 1, "bytes": 0, "seconds": secs, "MBps": None}
        if own:
            out[k]["self_seconds"] = self_secs
    return harness.Run(entry, "cpu", 1.0, 2.0, each, out, counters or {}, {}, None)


# (metric, entry, stages, counters, value): the stage's seconds over the
# MiB of the metric's side, the counter over the bytes of its side
CASES = [
    ("match_ms_per_MiB.deflate", "deflate", {"deflate.encode.match": 0.32}, {}, 5.0),
    ("parse_ms_per_MiB.deflate", "deflate", {"deflate.encode.parse": 0.064}, {}, 1.0),
    ("trees_ms_per_MiB.deflate", "deflate", {"deflate.encode.trees": 0.128}, {}, 2.0),
    ("pack_ms_per_MiB.deflate", "deflate", {"deflate.encode.pack": 0.016}, {}, 0.25),
    ("flush_ms_per_MiB.deflate", "deflate", {"deflate.flush": 0.64}, {}, 10.0),
    ("h2d_bytes_per_byte.deflate", "deflate", {}, {"copy.h2d_bytes": IN * 17 // 8}, 2.125),
    ("d2h_bytes_per_byte.deflate", "deflate", {}, {"copy.d2h_bytes": IN * 5 // 2}, 2.5),
    ("plan_scan_ms_per_MiB.inflate", "inflate", {"inflate.plan.scan": 0.16}, {}, 5.0),
    ("declined_ms_per_MiB.inflate", "inflate",
     {"inflate.call": 2.0, "inflate.declined": 0.64}, {}, 20.0),
    ("declined_ms_per_MiB.inflate", "inflate", {"inflate.call": 2.0}, {}, 0.0),
    ("plan_loop_ms_per_MiB.inflate", "inflate", {"inflate.plan": (0.5, 0.128)}, {}, 4.0),
    ("plan_us_per_block.inflate", "inflate", {"inflate.plan": (0.5, 0.128)},
     {"inflate.plan_blocks": 400}, 320.0),
    ("h2d_bytes_per_byte.inflate", "inflate", {},
     {"copy.h2d_bytes": OUT * 11 // 8, "inflate.device": OUT}, 1.375),
    ("h2d_bytes_per_byte.inflate", "inflate", {},
     {"copy.h2d_bytes": OUT * 11 // 8, "inflate.device": OUT // 2}, 2.75),
    ("launch_us_per_call.crc32", "crc32", {"crc32.launch": 20e-6}, {}, 10.0),
]


@pytest.mark.parametrize("name,entry,stages,counters,value", CASES, ids=[c[0] for c in CASES])
def test_metric_reads_its_stage_or_counter(name, entry, stages, counters, value):
    assert metric(name)(run(entry, stages, counters)) == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("name", sorted({c[0] for c in CASES}))
def test_metric_reads_nothing_without_the_instrumentation(name):
    """A run of a program without the new stages and counters (its other
    stages and counters present), and a run of another entry point, give
    none: the line then leaves the metric out."""
    entry = next(c[1] for c in CASES if c[0] == name)
    old = run(entry, {"deflate.join": 1.0, "inflate.plan": 1.0},
              {"inflate.device": OUT, "deflate.device": IN}, own=False)
    assert metric(name)(old) is None
    for c in CASES:
        if c[0] == name:
            other = "crc32" if entry != "crc32" else "deflate"
            assert metric(name)(run(other, c[2], c[3])) is None
            assert metric(name)(run(entry, c[2], c[3], calls=0)) is None


def test_inflate_copies_over_the_device_route_bytes():
    """h2d_bytes_per_byte.inflate divides by the bytes the device route
    returned, not all output: a window where the route returned nothing
    gives none, and the host engine's output leaves the reading as it
    is."""
    read = metric("h2d_bytes_per_byte.inflate")
    assert read(run("inflate", {}, {"copy.h2d_bytes": OUT, "inflate.device": 0})) is None
    assert read(run("inflate", {}, {"copy.h2d_bytes": OUT})) is None
    half = run("inflate", {}, {"copy.h2d_bytes": OUT, "inflate.device": OUT // 2})
    assert read(half) == 2.0


def test_plan_metrics_read_the_self_seconds():
    """The plan's loop is inflate.plan's self seconds, not its seconds, and
    a window that planned no block gives no time a block."""
    stages = {"inflate.plan": (1.0, 0.25), "inflate.plan.scan": (0.75, 0.75)}
    assert metric("plan_loop_ms_per_MiB.inflate")(run("inflate", stages)) == 0.25e3 / 32
    assert metric("plan_us_per_block.inflate")(run("inflate", stages)) is None
    assert metric("plan_us_per_block.inflate")(
        run("inflate", stages, {"inflate.plan_blocks": 0})) is None
