"""The mesh layer and the speculative host inflate on the card.

Every test here is marked `cuda` and skips without a CUDA card.  A
world-size-1 NCCL group (a free localhost port) carries
sharded_deflate at ragged lengths, whose streams and checksums must equal
the same step's on the CPU (a gloo group over the same rank) and zlib's,
with the encoder's four kernels and the two checksum scalars launched on
the card; sharded_inflate decodes on the card through the mesh branch;
dryrun_multichip(1) runs at its production shard of 256 KiB; and
inflate_parallel_container verifies its trailer on the card.  On a host
with two cards or more, one NCCL worker process a card runs
sharded_deflate (the halo by send/recv between the cards) and
sharded_inflate, against a gloo group over the same ranks on the CPU;
with one card that test skips.  On a machine with a card (and no JAX,
which tests/conftest.py imports), from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_mesh.py
"""

import gzip
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

from tpuzlib_torch import testing
from tpuzlib_torch.entry import dryrun_multichip
from tpuzlib_torch.kernels import _build
from tpuzlib_torch.parallel import make_mesh, sharded_deflate, sharded_inflate
from tpuzlib_torch.parallel.mesh import Mesh
from tpuzlib_torch.parallel.speculative import inflate_parallel_container

pytestmark = pytest.mark.cuda

ENCODER = ("near_screen", "far_screen", "segment_parse", "pack_words")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def meshes():
    """(the NCCL mesh on card 0, a gloo mesh of the same rank on the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:%d" % _free_port(), rank=0,
                            world_size=1)
    try:
        yield make_mesh(1, "cuda"), Mesh(dist.new_group([0], backend="gloo"), 0, 1,
                                         torch.device("cpu"))
    finally:
        dist.destroy_process_group()


def _launched(fn):
    """fn()'s result and the launches it made."""
    _build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _build.LAUNCHES.items() if v}


@pytest.mark.parametrize("level", [1, 6])
@pytest.mark.parametrize("n", [0, 1, 4095, (256 << 10) - 1, (3 << 20) + 7])
def test_sharded_deflate_on_card_matches_cpu(meshes, n, level):
    card, cpu = meshes
    data = testing.mixed(n + 1, seed=n)[:n]
    (wire, adler, crc), launched = _launched(lambda: sharded_deflate(data, card, level))
    cwire, cadler, ccrc = sharded_deflate(data, cpu, level)
    assert wire.tobytes() == cwire.tobytes() and (adler, crc) == (cadler, ccrc)
    assert (adler, crc) == (zlib.adler32(data.tobytes()), zlib.crc32(data.tobytes()))
    assert zlib.decompress(wire.tobytes()) == data.tobytes()
    assert all(launched.get(k, 0) >= 1 for k in ENCODER), launched
    scalars = 1 if n else 0  # an empty shard's checksums need no launch
    assert launched.get("adler32_scalar", 0) == launched.get("crc32_scalar", 0) == scalars


def test_sharded_inflate_on_card(meshes):
    card, _ = meshes
    data = testing.mixed(8 << 20, seed=21)
    raw = np.frombuffer(testing.zlib_stream(data, 6, -15), np.uint8)
    out, launched = _launched(lambda: sharded_inflate(raw, card))
    assert out is not None and out.tobytes() == data.tobytes()
    assert launched.get("inflate_decode") == 1 and launched.get("inflate_lut") == 1


def test_dryrun_multichip_on_card(meshes):
    _, launched = _launched(lambda: dryrun_multichip(1))
    assert all(launched.get(k, 0) >= 1 for k in ENCODER), launched
    assert launched.get("inflate_decode") == 1


@pytest.mark.parametrize("fmt", ["zlib", "gzip"])
def test_inflate_parallel_container_on_card(meshes, fmt):
    data = testing.mixed(4 << 20, seed=22)
    wire = (zlib.compress(data.tobytes(), 6) if fmt == "zlib"
            else gzip.compress(data.tobytes(), 6, mtime=0))
    out, launched = _launched(lambda: inflate_parallel_container(wire, 4, 4, device="cuda"))
    assert out.tobytes() == data.tobytes()
    # the trailer's one checksum launch, and no decode on the card
    assert launched.get("adler32_scalar" if fmt == "zlib" else "crc32_scalar") == 1, launched
    assert not any(k.startswith("inflate") or k in ENCODER for k in launched), launched
    bad = wire[:-1] + bytes([wire[-1] ^ 1])
    with pytest.raises(ValueError, match="Data integrity check failed"):
        inflate_parallel_container(bad, 4, 4, device="cuda")


# a worker a card: rank, world size, port, output file.  Its NCCL mesh and a
# gloo mesh over the same ranks run the same calls; it writes whether each
# pair agreed and zlib decoded the stream.
_WORKER = r"""
import datetime, json, sys, zlib
import numpy as np, torch
import torch.distributed as dist
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("nccl", init_method="tcp://127.0.0.1:%s" % port, rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=300))
try:
    from tpuzlib_torch import testing
    from tpuzlib_torch.kernels import _build
    from tpuzlib_torch.parallel import make_mesh, sharded_deflate, sharded_inflate
    from tpuzlib_torch.parallel.mesh import Mesh
    card = make_mesh(world, "cuda")
    cpu = Mesh(dist.new_group(backend="gloo"), rank, world, torch.device("cpu"))
    res = {}
    for level in (1, 6):
        for n in (0, 5000, (1 << 20) + 7, world * (1 << 20) - 777):
            data = testing.mixed(n + 1, seed=n)[:n]
            _build.reset_launches()
            got = sharded_deflate(data, card, level, 1 << 20)
            launched = _build.LAUNCHES["near_screen"]
            want = sharded_deflate(data, cpu, level, 1 << 20)
            res["deflate %d %d" % (level, n)] = bool(
                got[0].tobytes() == want[0].tobytes() and got[1:] == want[1:]
                and got[1:] == (zlib.adler32(data.tobytes()), zlib.crc32(data.tobytes()))
                and zlib.decompress(got[0].tobytes()) == data.tobytes() and launched > 0)
    data = testing.mixed(8 << 20, seed=23)
    raw = np.frombuffer(testing.zlib_stream(data, 6, -15), np.uint8)
    got = sharded_inflate(raw, card)
    res["inflate"] = got is not None and got.tobytes() == data.tobytes()
    with open(out, "w") as f:
        json.dump(res, f)
finally:
    dist.destroy_process_group()
"""


def test_sharded_pipelines_across_cards(tmp_path):
    """One NCCL worker a card, when the host has two cards or more."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    world = torch.cuda.device_count()
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), port,
                               str(tmp_path / ("%d.json" % r))],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
             for r in range(world)]
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
        logs.append(log.decode(errors="replace"))
    for r, p in enumerate(procs):
        assert p.returncode == 0, "rank %d:\n%s" % (r, logs[r][-3000:])
    results = [json.loads((tmp_path / ("%d.json" % r)).read_text()) for r in range(world)]
    assert all(res == results[0] for res in results)
    assert len(results[0]) == 9 and all(results[0].values()), results[0]
