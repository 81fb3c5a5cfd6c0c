"""tpuzlib_torch — tpuzlib's device DEFLATE encoder, decoder and checksums in PyTorch and CUDA.

The port of tpuzlib (JAX on a TPU) to PyTorch on an NVIDIA Hopper GPU.
It mirrors tpuzlib's layout; its kernels are CUDA C++ under
kernels/csrc/, built on first use.  Every one-shot entry point takes
`device=` (default "cuda"): on a CUDA device the kernels run, on "cpu"
their plain torch versions run.  The streaming Deflater and Inflater are
host objects, as tpuzlib's are; deflate() runs the host engine too on
"cpu", below 1 MiB or with a preset dictionary (tpuzlib's route rule).

Public API:
    deflate, DeflaterOptions   one-shot raw / zlib / gzip compression: the device
                               encoder on a card from 1 MiB, else the host engine
    Deflater                   streaming compression on the host engine
    inflate                    one-shot raw / zlib / gzip decompression: the
                               device route, the host engine where it declines
    inflate_members            one-shot decompression of concatenated gzip
                               members (BGZF), all of them: one batched
                               device decode, the host engine where it
                               declines
    Inflater, InflaterOptions, streaming decompression on the host engine,
      InflateResult            its options and its verdict
    DeviceDeclined             the error of a stream the device decode declines
                               (inflate() falls back, and never raises it)
    DeviceDeflater             streaming compression, window on the device
    adler32, crc32             checksums on the device, chained by seed
    mergeBuffers, u8_view      buffer helpers
"""

from .api.checksums import adler32, crc32
from .api.deflate_api import Deflater, DeflaterOptions, deflate
from .api.inflate_api import InflateResult, Inflater, InflaterOptions, inflate, inflate_members
from .common import mergeBuffers, u8_view
from .kernels.deflate_device3 import DeviceDeflater
from .kernels.inflate_device2 import DeviceDeclined

__all__ = ["deflate", "Deflater", "DeflaterOptions", "DeviceDeflater", "inflate",
           "inflate_members", "Inflater",
           "InflaterOptions", "InflateResult", "DeviceDeclined", "adler32", "crc32",
           "mergeBuffers", "u8_view"]
