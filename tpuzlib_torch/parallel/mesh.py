"""Mesh construction over torch.distributed.

Counterpart of tpuzlib/parallel/mesh.py.  The codec's parallelism is
one-dimensional data parallelism over independent compressed units (the
"shards" axis of tpuzlib's jax Mesh) with nearest-neighbour halo flow:
the window context travels by point-to-point send/recv, the checksums
combine by all_reduce, and every rank gathers every shard's output.

A jax Mesh is one process holding every device; a torch.distributed
group is one process a device.  So a `Mesh` here is this process's view
of its group: the group, its rank and world size, and the rank's device.
Every rank runs the same SPMD function on its own shard, as a shard_map
step runs once a device.  The backend follows the platform: NCCL for
"cuda", gloo for "cpu"; a mesh on the card never runs on gloo.
tpuzlib's shard_map_compat is a shim over jax versions' shard_map
signatures and has no counterpart.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


class Mesh(NamedTuple):
    group: object  # the torch.distributed process group
    rank: int
    size: int  # the number of shards (tpuzlib's mesh.devices.size)
    device: torch.device


def make_mesh(n_devices: int | None = None, platform: str = "cuda") -> Mesh:
    """The mesh of the default process group, which the caller has
    initialised (torch.distributed.init_process_group, or
    make_multihost_mesh) with the platform's backend: NCCL for "cuda",
    gloo for "cpu".  n_devices, when given, must be its world size.  On
    "cuda", rank r takes card r modulo the cards this host has."""
    if platform not in BACKENDS:
        raise ValueError("platform must be one of %s" % sorted(BACKENDS))
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    group = dist.group.WORLD
    backend = dist.get_backend(group)
    if backend != BACKENDS[platform]:
        raise ValueError("a %s mesh needs the %s backend; the process group has %s"
                         % (platform, BACKENDS[platform], backend))
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_devices is not None and n_devices != size:
        raise ValueError("n_devices is %d; the process group has %d ranks" % (n_devices, size))
    if platform == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    return Mesh(group, rank, size, device)


def make_multihost_mesh(platform: str = "cuda") -> Mesh:
    """The mesh over every rank of a multi-process (and multi-host) run.

    Initialises the default process group from torchrun's variables
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE: init_method "env://"),
    where tpuzlib called jax.distributed.initialize() from the
    coordinator's, unless a group is initialised already.  Shards follow
    the ranks' order, so the in-order gather (pipeline.py) gives the
    stream's order across hosts."""
    if platform not in BACKENDS:
        raise ValueError("platform must be one of %s" % sorted(BACKENDS))
    if not dist.is_initialized():
        dist.init_process_group(BACKENDS[platform], init_method="env://")
    return make_mesh(platform=platform)
