"""Host-parallel and multi-device layers: the mesh over torch.distributed
(mesh.py), the sharded deflate and inflate pipelines over it
(pipeline.py), concatenated gzip members (members.py), and the
speculative segment-parallel inflate with the device inflate's header
scan (speculative.py)."""

from .mesh import make_mesh, make_multihost_mesh
from .pipeline import build_sharded_deflate, sharded_deflate, sharded_inflate
from .members import compress_members, decompress_members
from .speculative import inflate_parallel, inflate_parallel_container

__all__ = [
    "make_mesh",
    "make_multihost_mesh",
    "build_sharded_deflate",
    "sharded_deflate",
    "sharded_inflate",
    "compress_members",
    "decompress_members",
    "inflate_parallel",
    "inflate_parallel_container",
]
