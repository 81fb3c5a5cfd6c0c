"""Public adler32 / crc32.

Counterpart of tpuzlib/api/checksums.py: ``adler32(source, seed=1)``,
``crc32(source, seed=0)``; results chain by feeding the previous checksum
in as the next call's seed.  Returns are unsigned 32-bit ints.

A 1-D contiguous uint8 tensor is checksummed where it lies; any host
buffer tpuzlib accepts (bytes, bytearray, memoryview, an ndarray of any
dtype) is uploaded to `device` first.  On a CUDA device the kernels run,
on the CPU their plain versions: the device decides, not the size.

Telemetry (utils/trace.py): crc32() runs as the stage crc32.call, around
the kernel's crc32.launch; the upload of a host buffer counts as
copy.h2d_bytes.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..common import u8_view
from ..kernels import adler32 as _adler
from ..kernels import crc32 as _crc
from ..utils import trace


def _u8_tensor(source, device) -> torch.Tensor:
    """`source` as a tensor: a tensor as it is (the kernels' wrappers take
    only 1-D contiguous uint8), a host buffer as uint8 uploaded to
    `device`."""
    if torch.is_tensor(source):
        return source
    view = np.ascontiguousarray(u8_view(source))
    with warnings.catch_warnings():
        # a read-only buffer (bytes) is only read, on the host or by the copy
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        out = torch.from_numpy(view).to(device)
    trace.count_copy("h2d", device, view)
    return out


def adler32(source, seed: int = 1, *, device="cuda") -> int:
    return _adler.adler32_device(_u8_tensor(source, device), seed)


def crc32(source, seed: int = 0, *, device="cuda") -> int:
    with trace.timed_stage("crc32.call"):
        return _crc.crc32_device(_u8_tensor(source, device), seed)
