"""The mesh layer (tpuzlib_torch.parallel.mesh / pipeline), the mesh
branch of inflate_device_v2 and entry.dryrun_multichip, on the CPU over
gloo, against tpuzlib's pipelines on the conftest's virtual CPU devices.

World size 1 runs in this process (a gloo group on a HashStore, made and
destroyed by a fixture); world sizes 2 and 4 run as worker processes
that rendezvous on a free localhost port, each with a time limit, and
write their results to a temporary directory.  The shard boundaries, and
so the bytes, depend on the number of shards, so each comparison holds
the same number on both sides: make_mesh(ndev, platform="cpu") for
tpuzlib, a gloo group of ndev ranks for the port.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpuzlib.parallel import make_mesh as jmake_mesh
from tpuzlib.parallel import pipeline as jpipeline
from tpuzlib_torch import testing
from tpuzlib_torch.entry import dryrun_multichip
from tpuzlib_torch.kernels.inflate_device2 import inflate_device_v2
from tpuzlib_torch.parallel import make_mesh, make_multihost_mesh, pipeline
from tpuzlib_torch.parallel import sharded_deflate, sharded_inflate

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ranks -> the shard length of its cases (4-16 KiB)
SHARD = {1: 16 << 10, 2: 8 << 10, 4: 4 << 10}
LEVELS = (1, 6)
# a stream's valid length: none; well below (ndev - 1) * shard_len, so the
# last shards are empty (a final empty stored block closes the stream);
# 777 bytes short of full
LENGTHS = {"empty": lambda w: 0, "short": lambda w: SHARD[w] // 3 + 5,
           "full": lambda w: w * SHARD[w] - 777}
INFLATE_STREAMS = ("L6", "fixed", "stored", "hidden stored")


def _data(world: int, kind: str) -> np.ndarray:
    """The case's bytes (the workers make them the same way)."""
    n = LENGTHS[kind](world)
    return testing.mixed(n + 1, seed=n)[:n]


def _inflate_inputs() -> dict:
    streams = testing.inflate_streams(1 << 15, seed=5)
    out = {name: streams[name] for name in INFLATE_STREAMS}
    # an empty stored stream: both decodes decline it (None)
    out["empty stored"] = (np.frombuffer(testing.zlib_stream(np.empty(0, np.uint8), 0, -15),
                                         np.uint8), np.empty(0, np.uint8))
    return out


# a worker: rank, world size, port, directory; reads cases.json there
# (the deflate cases' level, valid length and shard length, the inflate
# streams' files) and writes <rank>.json
_WORKER = r"""
import datetime, json, sys
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%s" % port, rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=120))
try:
    from tpuzlib_torch import testing
    from tpuzlib_torch.parallel import make_mesh, sharded_deflate, sharded_inflate
    mesh = make_mesh(world, "cpu")
    with open(out + "/cases.json") as f:
        cases = json.load(f)
    res = {}
    for key, level, n, shard_len in cases["deflate"]:
        data = testing.mixed(n + 1, seed=n)[:n]
        wire, adler, crc = sharded_deflate(data, mesh, level, shard_len)
        res[key] = [wire.tobytes().hex(), adler, crc]
    for key, path in cases["inflate"]:
        got = sharded_inflate(np.load(path), mesh)
        res[key] = None if got is None else got.tobytes().hex()
    with open("%s/%d.json" % (out, rank), "w") as f:
        json.dump(res, f)
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """world size -> the results of rank 0, after checking every rank gave
    the same: gloo worker processes at world sizes 2 and 4, all started
    together."""
    runs = {}
    for world in (2, 4):
        out = tmp_path_factory.mktemp("world%d" % world)
        cases = {"deflate": [["deflate %d %s" % (level, kind), level, LENGTHS[kind](world),
                              SHARD[world]] for level in LEVELS for kind in LENGTHS],
                 "inflate": []}
        if world == 2:
            for name, (raw, _) in _inflate_inputs().items():
                np.save(out / (name + ".npy"), raw)
                cases["inflate"].append(["inflate " + name, str(out / (name + ".npy"))])
        (out / "cases.json").write_text(json.dumps(cases))
        port = str(_free_port())
        env = {**os.environ, "PYTHONPATH": REPO}
        runs[world] = out, [
            subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), port, str(out)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
            for r in range(world)]
    results = {}
    for world, (out, procs) in runs.items():
        logs = []
        for p in procs:
            try:
                log, _ = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
                log, _ = p.communicate()
            logs.append(log.decode(errors="replace"))
        for r, p in enumerate(procs):
            assert p.returncode == 0, "world %d rank %d:\n%s" % (world, r, logs[r][-3000:])
        ranks = [json.loads((out / ("%d.json" % r)).read_text()) for r in range(world)]
        assert all(res == ranks[0] for res in ranks), "the ranks returned different results"
        results[world] = ranks[0]
    return results


@pytest.fixture
def mesh1():
    """A world-size-1 gloo group in this process, destroyed after the test."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh(1, "cpu")
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _jmesh(ndev: int):
    return jmake_mesh(ndev, platform="cpu")


_JBUILD = jpipeline.build_sharded_deflate


@functools.lru_cache(maxsize=None)
def _jbuild(mesh, shard_len, level=6, ctx=None):
    return _JBUILD(mesh, shard_len, level, ctx)


@pytest.fixture
def jsharded(monkeypatch):
    """tpuzlib's sharded_deflate with its step built once a (mesh, shard,
    level): each call otherwise traces and compiles the step again."""
    monkeypatch.setattr(jpipeline, "build_sharded_deflate", _jbuild)
    return jpipeline.sharded_deflate


@pytest.mark.parametrize("shard_len,ndev,n", [(4096, 1, None), (4096, 4, 4096 * 3 + 5),
                                              (1 << 18, 2, 0), (8192, 8, 1 << 20)])
def test_shard_shift_matrix_bits_match_tpuzlib(shard_len, ndev, n):
    got = pipeline._shard_shift_matrix_bits(shard_len, ndev, n)
    assert got.dtype == np.int32 and got.shape == (ndev, 32, 32)
    assert np.array_equal(got, jpipeline._shard_shift_matrix_bits(shard_len, ndev, n))


@pytest.mark.parametrize("kind", sorted(LENGTHS))
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_deflate_matches_tpuzlib(world, level, kind, worlds, jsharded, request):
    data = _data(world, kind)
    if world == 1:
        mesh = request.getfixturevalue("mesh1")
        wire, adler, crc = sharded_deflate(data, mesh, level, SHARD[world])
        wire = wire.tobytes()
    else:
        hexwire, adler, crc = worlds[world]["deflate %d %s" % (level, kind)]
        wire = bytes.fromhex(hexwire)
    jwire, jadler, jcrc = jsharded(data, _jmesh(world), level, SHARD[world])
    assert wire == np.asarray(jwire).tobytes()
    assert (adler, crc) == (jadler, jcrc) == (zlib.adler32(data.tobytes()),
                                              zlib.crc32(data.tobytes()))
    assert zlib.decompress(wire) == data.tobytes()


@pytest.mark.parametrize("name", sorted(INFLATE_STREAMS) + ["empty stored"])
def test_sharded_inflate_matches_tpuzlib(name, worlds):
    """At world size 2: the same bytes, or the same None, as tpuzlib's
    sharded_inflate and as the port's unsharded inflate_device_v2."""
    raw, data = _inflate_inputs()[name]
    got = worlds[2]["inflate " + name]
    got = None if got is None else bytes.fromhex(got)
    want = jpipeline.sharded_inflate(raw, _jmesh(2))
    alone = inflate_device_v2(raw, stride_bits=1 << 15, max_cursors=4096, device="cpu")
    for other in (want, alone):
        assert (got is None and other is None) or got == np.asarray(other).tobytes()
    assert got is None if name == "empty stored" else got == data.tobytes()


def test_sharded_inflate_world_size_1(mesh1):
    """The mesh branch at world size 1: the decode of every cursor on this
    rank, then the same splice; the same bytes as without a mesh."""
    raw, data = _inflate_inputs()["L6"]
    assert sharded_inflate(raw, mesh1).tobytes() == data.tobytes()


def test_sharded_inflate_size_hint(mesh1):
    """tpuzlib's size_hint, by keyword and in its position (before the
    dictionary), below and above the output: the same bytes."""
    raw, data = _inflate_inputs()["L6"]
    for n in (1, 2 * len(data)):
        assert sharded_inflate(raw, mesh1, size_hint=n).tobytes() == data.tobytes()
        assert sharded_inflate(raw, mesh1, 1 << 15, 4096, n, None).tobytes() == data.tobytes()


def test_dryrun_multichip(mesh1):
    dryrun_multichip(1, device="cpu", shard_len=1 << 15)


def test_mesh_checks(mesh1):
    """A mesh of the group's size and backend only; shards that cannot hold
    the input are refused."""
    assert mesh1 == (dist.group.WORLD, 0, 1, torch.device("cpu"))
    assert make_multihost_mesh("cpu") == mesh1  # the group is initialised already
    for args, error in (((2, "cpu"), "n_devices is 2"), ((1, "cuda"), "needs the nccl backend"),
                        ((1, "tpu"), "platform must be")):
        with pytest.raises(ValueError, match=error):
            make_mesh(*args)
    with pytest.raises(ValueError, match="cannot hold"):
        sharded_deflate(np.zeros(5000, np.uint8), mesh1, 6, 4096)


def test_make_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised"):
        make_mesh(1, "cpu")


def test_sharded_deflate_builds_its_step_once(mesh1, monkeypatch):
    """The step is built once a (mesh, shard, level, ctx): a second
    sharded_deflate, and deflate_shards with its ok flags, build no
    encoder; another level builds one."""
    from tpuzlib_torch.kernels import deflate_device3

    built = []
    make = deflate_device3.make_encode_batch_v3

    def spy(*args, **kwargs):
        built.append(args[:2])
        return make(*args, **kwargs)

    monkeypatch.setattr(deflate_device3, "make_encode_batch_v3", spy)
    data = testing.corpus("text", 16 << 10, seed=3)  # text: no cap overflows
    first = sharded_deflate(data, mesh1, 6, 16 << 10)
    assert built == [(6, 16 << 10)]
    body, adler, crc, ok = pipeline.deflate_shards(data, mesh1, 6, 16 << 10)
    assert sharded_deflate(data, mesh1, 6, 16 << 10)[0].tobytes() == first[0].tobytes()
    assert built == [(6, 16 << 10)] and ok.tolist() == [1]
    assert (adler, crc) == first[1:] == (zlib.adler32(data.tobytes()), zlib.crc32(data.tobytes()))
    assert zlib.decompress(body.tobytes(), -15) == data.tobytes()
    sharded_deflate(data, mesh1, 1, 16 << 10)
    assert built == [(6, 16 << 10), (1, 16 << 10)]
