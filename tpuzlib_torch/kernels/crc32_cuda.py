"""CRC-32 linear forms of 1 KiB blocks or 256 KiB spans (one kernel, two modes).

Counterpart of tpuzlib/kernels/crc32_pallas.py.  `crc32_forms(data, pad,
tile)` returns one raw linear form (crc32.py) per `tile` 1 KiB blocks of
zeros(pad) | data, as int32 bit patterns:

  tile=1    one form per block: the contract of crc32_pallas_forms;
  tile=256  one form per 256 KiB span: the contract of the run function
            of crc32_pallas._fused_kernel_fn.

On a CUDA tensor the wrapper launches csrc/crc32.cu (counted as
`crc32_forms` or `crc32_spans`); on a CPU tensor it runs the plain
version, crc32_forms_plain.  The front padding is never copied: the
kernel reads index i - pad < 0 as 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .crc32 import DEVICE_BLOCK, TILE, _combine_mat, _combine_tables, _table8
from .deflate_device3 import _as_i32

TILES = (1, TILE)
LEVELS = TILE.bit_length() - 1  # combine levels inside a span


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    """The CRC table (256) and A^(1024 * 2^l) for l < LEVELS as packed
    columns (LEVELS * 32), int32 bit patterns on `device`."""
    cols = np.concatenate([_combine_mat(DEVICE_BLOCK, lvl) for lvl in range(LEVELS)])
    return tuple(
        torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(device) for a in (_table8(), cols)
    )


def _check(data: torch.Tensor, pad: int, tile: int) -> int:
    """Raise unless zeros(pad) | data is whole forms of `tile` blocks and
    pad is shorter than one form; returns the number of 1 KiB blocks."""
    _build.check_bytes("crc32_forms", data)
    if tile not in TILES:
        raise ValueError("crc32_forms: tile must be one of %s, got %r" % (TILES, tile))
    size = DEVICE_BLOCK * tile
    if not 0 <= pad < size or (data.numel() + pad) % size:
        raise ValueError("crc32_forms: pad %d does not make %d bytes whole %d-byte forms"
                         % (pad, data.numel(), size))
    return (data.numel() + pad) // DEVICE_BLOCK


def crc32_forms_plain(data: torch.Tensor, pad: int, tile: int) -> torch.Tensor:
    """The table fold vectorised over blocks, then the span tree; exact
    on any device."""
    _check(data, pad, tile)
    dev = data.device
    table = torch.from_numpy(_table8().astype(np.int64)).to(dev)
    blocks = torch.cat([data.new_zeros(pad), data]).view(-1, DEVICE_BLOCK)
    crc = torch.zeros(blocks.shape[0], dtype=torch.int64, device=dev)
    for j in range(DEVICE_BLOCK):
        crc = table[(crc ^ blocks[:, j]) & 0xFF] ^ (crc >> 8)
    crc = crc.view(-1, tile)
    for lvl in range(tile.bit_length() - 1):
        t = torch.from_numpy(_combine_tables(DEVICE_BLOCK, lvl).astype(np.int64)).to(dev)
        a = crc[:, 0::2]
        crc = (t[0][a & 0xFF] ^ t[1][(a >> 8) & 0xFF] ^ t[2][(a >> 16) & 0xFF]
               ^ t[3][a >> 24] ^ crc[:, 1::2])
    return _as_i32(crc[:, 0])


def crc32_forms(data: torch.Tensor, pad: int, tile: int) -> torch.Tensor:
    """Raw CRC linear forms of zeros(pad) | data: int32[(len + pad) /
    (1024 * tile)], one per `tile` 1 KiB blocks.  `data` is a 1-D
    contiguous uint8 tensor starting at any byte."""
    if _build.on_cpu(data):
        return crc32_forms_plain(data, pad, tile)
    nb = _check(data, pad, tile)
    out = torch.empty(nb // tile, dtype=torch.int32, device=data.device)
    if nb == 0:
        return out
    table, cols = _constants(data.device)
    _build.launch(
        "crc32_spans" if tile == TILE else "crc32_forms", "tz_crc32_forms", data.device,
        data.data_ptr(), data.numel(), pad, table.data_ptr(), cols.data_ptr(), out.data_ptr(),
        nb, tile,
    )
    return out
