"""The port's forward step and multi-device dry run, as tpuzlib's
__graft_entry__ gives them.

entry(device) returns (fn, example_args): fn is the batched
dynamic-Huffman encoder at level 6, two 64 KiB chunks a batch, and the
args are one batch of seeded English-like text on `device`, laid out as
tpuzlib's entry() lays out its text (the first chunk without history,
the second with the first's last 32 KiB as its window, and last).

dryrun_multichip(n_devices, device) runs one sharded-deflate step on
the mesh of an initialised process group and round-trips its stream.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from . import testing
from .kernels.deflate_device3 import batch_arrays, make_encode_batch_v3, out_words_for

CHUNK, BATCH, LEVEL = 1 << 16, 2, 6


def entry(device="cuda"):
    """Returns (fn, example_args); fn(*example_args) gives (words,
    total_bits, ok) for the batch."""
    fn = make_encode_batch_v3(LEVEL, CHUNK, BATCH, out_words_for(CHUNK))
    text = testing.corpus("text", BATCH * CHUNK, seed=0)
    arrays = batch_arrays(text, range(BATCH), CHUNK, BATCH)
    return fn, tuple(torch.from_numpy(a).to(device) for a in arrays)


def dryrun_multichip(n_devices: int, device="cuda", shard_len: int = 1 << 18) -> None:
    """One sharded-deflate step on an n_devices mesh at production shard
    sizes (256 KiB a rank, dynamic trees at level 6, a 32 KiB halo, a valid
    length 12,345 bytes short of full), then the checks of tpuzlib's
    dryrun_multichip (__graft_entry__.py:63): every shard's ok flag, the
    assembled stream decoded by zlib, its Adler-32 and CRC-32 equal to
    zlib's, and sharded_inflate decoding it back on the mesh.  Every rank
    of an initialised process group of n_devices ranks, with the device's
    backend (parallel/mesh.make_mesh), calls it; the data is seeded text
    (testing.corpus); the step, the join and the checksums' finish are
    sharded_deflate's (parallel/pipeline.deflate_shards).  shard_len
    shrinks the step for a CPU test.  Raises RuntimeError, naming the
    check, where one fails."""
    from .parallel.mesh import make_mesh
    from .parallel.pipeline import deflate_shards, sharded_inflate

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise RuntimeError("dryrun_multichip: " + what)

    mesh = make_mesh(n_devices, platform=torch.device(device).type)
    # exercise the valid-length masking
    text = testing.corpus("text", shard_len * n_devices - 12345, seed=0)
    body, adler, crc, ok = deflate_shards(text, mesh, level=6, shard_len=shard_len)
    check(ok.all(), "a mesh shard overflowed the encoder's caps")

    # the sharded stream must decode and checksum correctly
    check(zlib.decompress(body.tobytes(), -15) == text.tobytes(),
          "the sharded stream did not round-trip")
    check(adler == zlib.adler32(text.tobytes()), "the sharded Adler-32 differs from zlib's")
    # the mesh's GF(2) CRC combine must finish to the exact crc32
    check(crc == zlib.crc32(text.tobytes()), "the sharded CRC-32 differs from zlib's")

    # mesh-parallel inflate: decode the sharded stream back on the mesh
    out = sharded_inflate(body, mesh)
    check(out is not None, "sharded_inflate declined the stream")
    check(out.tobytes() == text.tobytes(), "sharded_inflate did not round-trip")
