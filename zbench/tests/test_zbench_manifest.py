"""BENCHMARK.json against the benchmark's contract, and a cell, a
configuration, a per-layer metric and an entry driver added as new files
and entries alone."""

import json
import os
import re
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from zbench import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes(manifest):
    assert set(manifest) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[part]:
            extra = {"workloads"} if part in ("end_to_end", "per_layer") else set()
            assert KEYS[part] <= set(e) <= KEYS[part] | extra, e
    assert 1 <= len(manifest["configs"]) <= 24
    assert 1 <= len(manifest["workloads"]) <= 24
    assert 1 <= len(manifest["end_to_end"]) <= 16
    assert 1 <= len(manifest["per_layer"]) <= 128
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51


def test_command_and_paths(manifest):
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p)) and not p.endswith("_torch")
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        assert not w.startswith("/") and ".." not in w.split("/")
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w == p or w.startswith(p + "/") for p in manifest["paths"]), w


def test_names_units_and_lines(manifest):
    names = []
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[part]:
            assert NAME.match(e["name"]), e["name"]
            names.append((part in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for key in {"configs": ("why", "source"), "workloads": ("why",),
                        "per_layer": ("layer",)}.get(part, ()):
                assert _line(e[key]), e[key]
    assert len(names) == len(set(names))
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
    for c in manifest["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in manifest["end_to_end"]}


def test_cells_and_files(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c["file"].startswith("zbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
    used = set()
    pairs = set()
    for w in manifest["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        used.add(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.isfile(os.path.join(ROOT, "zbench", "traffic", w["traffic"] + ".json"))
    assert used == set(configs)
    fours = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert fours <= max(1, len(manifest["workloads"]) // 4)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "zbench", "metrics", m["name"] + ".py")), m["name"]


def test_every_cell_reports_what_its_metrics_move(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    reports = {c: {n for n, m in e2e.items() if c in m.get("workloads", [c])} for c in cells}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e, m
        for c in m.get("workloads", cells):
            assert c in cells and m["moves"] in reports[c], (m["name"], c)
    for c in cells:
        cell = harness.load_cell(ROOT, c)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, c
        assert cell.per_layer, c


def test_a_cell_config_and_metric_added_as_files(tmp_path, manifest):
    """A new configuration, traffic mix, cell and per-layer metric are new
    files and manifest entries; no file of zbench/ is edited, and the
    harness finds them and reads the metric in a run."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "zbench"), root / "zbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "zbench").rglob("*") if p.is_file()}
    cfg = json.loads((root / "zbench/configs/ckpt-zlib6.json").read_text())
    cfg.update(name="ckpt-zlib1", level=1)
    (root / "zbench/configs/ckpt-zlib1.json").write_text(json.dumps(cfg))
    (root / "zbench/traffic/deflate-2p-small.json").write_text(json.dumps(
        {"entry": "deflate", "piece_bytes": 1 << 17,
         "trace_seconds": 0.2}))
    (root / "zbench/metrics/calls_per_client.deflate.py").write_text(
        "def read(run):\n    return len(run.calls) / 2 if run.entry == 'deflate' else None\n")
    m = json.loads(json.dumps(manifest))
    m["configs"].append({"name": "ckpt-zlib1", "source": "zlib manual: level 1",
                         "file": "zbench/configs/ckpt-zlib1.json", "reduced": [], "why": "shallow"})
    cell = "ckpt-zlib1.deflate-2p-small"
    m["workloads"].append({"name": cell, "config": "ckpt-zlib1", "traffic": "deflate-2p-small",
                           "chips": 1, "why": "a throwaway cell"})
    for e in m["end_to_end"]:
        if e["name"] in ("deflate_MBps", "size_ratio"):
            e["workloads"].append(cell)
    m["per_layer"].append({"name": "calls_per_client.deflate", "unit": "calls", "better": "higher",
                           "source": "host_clock", "layer": "API", "moves": "deflate_MBps",
                           "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    found = harness.load_cell(str(root), cell)
    assert found.config["level"] == 1 and found.traffic["piece_bytes"] == 1 << 17
    assert [x["name"] for x in found.per_layer] == ["calls_per_client.deflate"]
    line = harness.run_cell(found, 5, 0.3, True, "cpu", 0.0)
    assert line["correct"] and line["metrics"]["calls_per_client.deflate"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before


# An entry driver of a BGZF-like framing: gzip members of at most 65,280
# input bytes, each with a BC subfield that holds the member's size less
# one, and an empty member at the end.  It times inflate(), member by
# member, and gives its own check and control.
MEMBERS_DRIVER = """
import struct
import zlib

import numpy as np

from .. import corpus
from ..reference import zlib_ref

TIMES = "inflate"
BLOCK = 0xFF00


def member(data, level):
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = c.compress(data) + c.flush()
    head = struct.pack("<4BI2BH2sHH", 31, 139, 8, 4, 0, 0, 255, 6, b"BC", 2, len(body) + 25)
    return head + body + struct.pack("<II", zlib.crc32(data), len(data))


def members(stream):
    at = 0
    while at < len(stream):
        size = int(stream[at + 16]) | int(stream[at + 17]) << 8
        yield stream[at: at + size + 1]
        at += size + 1


def program(api, config, device):
    def call(stream):
        return np.concatenate([api.inflate(m, device=device) for m in members(stream)])

    return call


class Driver:
    def __init__(self, config, traffic, seed, device):
        n = traffic["piece_bytes"]
        self.pieces = [corpus.corpus("text", n, [seed, k]) for k in range(traffic["pool"])]
        self.streams = [np.frombuffer(b"".join(
            [member(p[i: i + BLOCK].tobytes(), config["level"]) for i in range(0, n, BLOCK)]
            + [member(b"", config["level"])]), np.uint8) for p in self.pieces]
        self.calls = 0
        self.outputs = []

    def warm(self, fn):
        for stream in self.streams:
            fn(stream)

    def call(self, fn):
        k = self.calls % len(self.streams)
        out = fn(self.streams[k])
        self.outputs.append((k, out))
        self.calls += 1
        return len(self.streams[k]), len(out)


def check(config, traffic, d):
    bad = sum(not zlib_ref.equal(out, d.pieces[k]) for k, out in d.outputs)
    return {"bad_outputs": (bad, 0)}, {"outputs_checked": len(d.outputs)}


def control(api, config, device):
    # zlib's decode stops after the first member: every member but one lost
    def call(stream):
        return np.frombuffer(zlib.decompressobj(31).decompress(stream.tobytes()), np.uint8)

    return call
"""


def test_a_cell_with_its_own_entry_driver_added_as_files(tmp_path, manifest):
    """A cell whose driver is new (its own streams, check and control,
    timing inflate()) is new files and manifest entries alone: its lines
    carry the inflate cell's metrics, it is correct, its control and both
    faults are refused, and no file of zbench/ is edited.  A driver that
    times an entry point no reader keys on stops the run before set-up."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "zbench"), root / "zbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "zbench").rglob("*") if p.is_file()}
    (root / "zbench/entries/bgzf_like.py").write_text(MEMBERS_DRIVER)
    (root / "zbench/entries/gunzip_like.py").write_text(
        MEMBERS_DRIVER.replace('TIMES = "inflate"', 'TIMES = "gunzip"').replace(
            "        n = traffic", "        raise AssertionError('set-up ran')\n        n = traffic"))
    (root / "zbench/configs/bgzf-like6.json").write_text(json.dumps(
        {"name": "bgzf-like6", "container": "gzip", "level": 6, "window_bits": 15,
         "mem_level": 8}))
    for traffic, driver in (("members-1c", "bgzf_like"), ("gunzip-1c", "gunzip_like")):
        (root / "zbench/traffic" / (traffic + ".json")).write_text(json.dumps(
            {"entry": driver, "piece_bytes": 150000, "pool": 2, "trace_seconds": 0.2}))
    m = json.loads(json.dumps(manifest))
    m["configs"].append({"name": "bgzf-like6", "source": "SAM/BAM format specification, 4.1 BGZF",
                         "file": "zbench/configs/bgzf-like6.json", "reduced": [],
                         "why": "block gzip"})
    cell, stray = "bgzf-like6.members-1c", "bgzf-like6.gunzip-1c"
    for name, traffic in ((cell, "members-1c"), (stray, "gunzip-1c")):
        m["workloads"].append({"name": name, "config": "bgzf-like6", "traffic": traffic,
                               "chips": 1, "why": "a throwaway cell"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "inflate_MBps" in (e["name"], e.get("moves")):
            e["workloads"] += [cell, stray]
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    found = harness.load_cell(str(root), cell)
    ref = harness.load_cell(str(root), "pylogs-gzip9.inflate-1c")
    ref.traffic.update(piece_bytes=150000, trace_seconds=0.2)
    assert {x["name"] for x in found.per_layer} == {x["name"] for x in ref.per_layer}
    for trace in (False, True):
        line = harness.run_cell(found, 3000000021, 0.3, trace, "cpu", 0.0)
        assert line["correct"] and line["compared"]["bad_outputs"]["value"] == 0, line["compared"]
        # the device route's metrics read nothing without a card, in either cell
        want = set(harness.run_cell(ref, 3000000021, 0.3, trace, "cpu", 0.0)["metrics"])
        assert set(line["metrics"]) == want
        assert want == {"inflate_MBps", "setup_s"} if not trace else "call_p90_ms.inflate" in want
    assert harness.stand_in(found, "control").__module__ == "zbench.entries.bgzf_like"
    for name in ("control", "alter", "half"):
        line = harness.run_cell(found, 3000000022, 0.3, False, "cpu", 0.0,
                                harness.stand_in(found, name))
        assert not line["correct"], (name, line["compared"])
    with pytest.raises(harness.UnknownEntry, match="gunzip"):
        harness.run_cell(harness.load_cell(str(root), stray), 5, 0.3, False, "cpu", 0.0)
    assert {p: p.read_bytes() for p in before} == before
