"""BENCHMARK.json against the benchmark's contract, and a cell, a
configuration and a per-layer metric added as new files and entries alone."""

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
