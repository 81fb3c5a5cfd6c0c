"""The harness on the CPU at tiny sizes: the corpus, the frozen trace
split, the reference, the import check, the exit without a card, and, in
every cell of BENCHMARK.json, a sound run and the check refusing the
control (the driver's own where it gives one) and every planted fault."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from zbench import corpus, harness, trace_split  # noqa: E402
from zbench.entries import blend  # noqa: E402
from zbench.reference import control, zlib_ref  # noqa: E402

torch.set_num_threads(1)

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = tuple(w["name"] for w in json.load(f)["workloads"])
QUICK = "ckpt-zlib6.crc32-dev"  # the cell the run.py tests start
TINY = {"piece_bytes": 1 << 16, "record_bytes": 1 << 14, "trace_seconds": 0.2}


def tiny_cell(name):
    cell = harness.load_cell(ROOT, name)
    cell.traffic.update({k: v for k, v in TINY.items() if k in cell.traffic})
    return cell


BLEND = {"blend": {"text": 0.45, "vertices": 0.25, "runs": 0.2, "random": 0.1},
         "piece_bytes": 1 << 16}


def test_corpus_is_fixed_by_the_seed():
    a = np.concatenate(blend(BLEND, 20 << 16, [3000000001, 2]))
    assert np.array_equal(a, np.concatenate(blend(BLEND, 20 << 16, [3000000001, 2])))
    b = blend(BLEND, 20 << 16, [3000000001, 3])
    assert not np.array_equal(a, np.concatenate(b))
    # the same pieces in another order: the work does not change with the seed
    digests = lambda pieces: sorted(hashlib.sha256(p.tobytes()).hexdigest() for p in pieces)
    assert digests(blend(BLEND, 20 << 16, [3000000001, 2])) == digests(b)
    # the frozen copy's bytes: a change here moves every cell's inputs
    assert hashlib.sha256(corpus.corpus("text", 1 << 18, 7).tobytes()).hexdigest()[:16] == "218d99e31de825fa"
    assert hashlib.sha256(a.tobytes()).hexdigest()[:16] == "16ca59fe985e9e3c"


def test_blend_gives_every_seed_the_same_pieces(monkeypatch):
    """Each seed: the same count of each kind (largest remainders) and the
    same sizes, in its own order."""
    kinds = list(corpus.KINDS)
    monkeypatch.setattr(corpus, "corpus",
                        lambda kind, n, seed: np.full(n, kinds.index(kind), np.uint8))
    orders = set()
    for seed in (1, 2, 3000000001):
        pieces = blend(BLEND, 20 << 16, seed)
        assert [len(p) for p in pieces] == [1 << 16] * 20
        tags = [int(p[0]) for p in pieces]
        assert sorted(tags) == [0] * 9 + [1] * 5 + [2] * 4 + [3] * 2
        orders.add(tuple(tags))
    assert len(orders) == 3
    assert [len(p) for p in blend(BLEND, 3 << 15, 1)] == [3 << 15]
    assert sorted(len(p) for p in blend(BLEND, (5 << 16) + 3, 1)) == [1 << 16] * 4 + [(1 << 16) + 3]


def _trace(path, events):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "host.1.pt.trace.json"), "w") as f:
        json.dump({"traceEvents": events}, f)


def test_trace_split_on_two_threads(tmp_path):
    """Stage spans on two threads (the port's worker threads), device
    operations that overlap, a gap under each stage."""
    ev = [
        {"cat": "user_annotation", "name": "zbench.window", "ts": 0, "dur": 100, "tid": 1},
        {"cat": "user_annotation", "name": "deflate.encode_batch", "ts": 0, "dur": 40, "tid": 2},
        {"cat": "user_annotation", "name": "deflate.join", "ts": 50, "dur": 50, "tid": 3},
        {"cat": "kernel", "name": "void near_screen<4>(int*)", "ts": 10, "dur": 20},
        {"cat": "kernel", "name": "at::native::vectorized_elementwise_kernel<4>(int)", "ts": 20,
         "dur": 20},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70, "dur": 10},
        {"cat": "kernel", "name": "late", "ts": 120, "dur": 5},
    ]
    _trace(tmp_path, ev)
    s = trace_split.trace_split(str(tmp_path), "zbench.window")
    assert s["wall_ms"] == 0.1 and s["device_busy_ms"] == pytest.approx(0.04)
    assert s["idle_share"] == pytest.approx(0.6) and s["device_ops"] == 3
    assert [o["op"] for o in s["top_ops"]] == ["near_screen<4>", "vectorized_elementwise_kernel<4>",
                                               "Memcpy DtoH"]
    gaps = {(g["stage"], g["ms"]) for g in s["longest_gaps"]}
    assert gaps == {("deflate.encode_batch", 0.01), ("deflate.join", 0.03),
                    ("deflate.join", 0.02)}


def test_reference_on_tiny_inputs():
    cfg = {"container": "deflate", "level": 6, "window_bits": 15, "mem_level": 8}
    data = np.concatenate(blend(BLEND, 50000, 1))
    z = zlib_ref.compress(data, cfg)
    assert z == zlib.compress(data.tobytes(), 6)
    assert zlib_ref.decodes_to(np.frombuffer(z, np.uint8), cfg, data)
    bad = bytearray(z)
    bad[-1] ^= 1
    assert not zlib_ref.decodes_to(np.frombuffer(bytes(bad), np.uint8), cfg, data)
    assert not zlib_ref.decodes_to(np.frombuffer(z[:-5], np.uint8), cfg, data)
    assert not zlib_ref.decodes_to(np.frombuffer(z + b"\0", np.uint8), cfg, data)
    assert not zlib_ref.decodes_to(np.frombuffer(z, np.uint8), dict(cfg, container="gzip"), data)
    g = zlib_ref.compress(data, dict(cfg, container="gzip", level=9))
    assert g[:8] == b"\x1f\x8b\x08\x00\x00\x00\x00\x00"  # no flags (no name), MTIME 0
    assert zlib.decompress(g, 31) == data.tobytes()
    assert zlib_ref.crc32(np.frombuffer(b"123456789", np.uint8)) == 0xCBF43926
    assert zlib_ref.equal(data.copy(), data) and not zlib_ref.equal(data[:-1], data)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = harness.run_cell(tiny_cell(name), 3000000011, 0.3, False, "cpu", 0.0)
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "compared"
    assert {m["name"] for m in tiny_cell(name).end_to_end} == set(line["metrics"])


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("stand_in", ["control", *control.FAULTS])
def test_control_and_faults_are_not_correct(name, stand_in):
    """The control (the reference with a guarantee broken) and each fault
    a cell can have (an answer altered where it is produced, half the
    input left out) make `correct` false."""
    cell = tiny_cell(name)
    line = harness.run_cell(cell, 3000000012, 0.3, False, "cpu", 0.0,
                            harness.stand_in(cell, stand_in))
    assert not line["correct"], line["compared"]


def test_dry_run_imports_no_jax():
    """A run of every cell on the CPU loads no module whose top-level name
    is jax, jaxlib, flax or tpuzlib (names compared whole)."""
    code = """
import json, sys
sys.path.insert(0, %r)
from zbench import harness
for name in %r:
    cell = harness.load_cell(harness.ROOT, name)
    cell.traffic.update({k: v for k, v in %r.items() if k in cell.traffic})
    assert harness.run_cell(cell, 5, 0.2, True, "cpu", 0.0)["correct"]
print(json.dumps(harness.leaked_modules()))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""" % (ROOT, CELLS, TINY)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    leaked, loaded = (json.loads(x) for x in res.stdout.strip().splitlines()[-2:])
    assert leaked == [] and "tpuzlib_torch" in loaded and "zbench" in loaded
    sys.modules["tpuzlib"] = sys.modules["json"]  # a stand-in module of that name
    try:
        assert harness.leaked_modules() == ["tpuzlib"]
    finally:
        del sys.modules["tpuzlib"]


def _run(cwd, *extra):
    return subprocess.run([sys.executable, os.path.join(cwd, "zbench", "run.py"), "--workload",
                           QUICK, "--seed", "3000000013", "--seconds", "1", "--trace", "0",
                           *extra], capture_output=True, text=True, timeout=600, cwd=cwd)


def test_no_card_no_result(tmp_path):
    """Without a CUDA card (or, with one, without the port beside the
    benchmark) a run exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    res = _run(ROOT)
    assert res.returncode == 2 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_alone_in_a_directory_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "zbench"), tmp_path / "zbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    res = _run(str(tmp_path))
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.cuda
def test_one_short_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _run(ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["metrics"]["crc32_GBps"]["value"] > 0
