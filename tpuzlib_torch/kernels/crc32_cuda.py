"""CRC-32 linear forms of 1 KiB blocks or 256 KiB spans, and the whole
CRC-32 on the card (one kernel, csrc/crc32.cu).

Counterpart of tpuzlib/kernels/crc32_pallas.py.  `crc32_forms(data, pad,
tile)` returns one raw linear form (crc32.py) per `tile` 1 KiB blocks of
zeros(pad) | data, as int32 bit patterns:

  tile=1    one form per block: the contract of crc32_pallas_forms;
  tile=256  one form per 256 KiB span: the contract of the run function
            of crc32_pallas._fused_kernel_fn.

`crc32_device_scalar(data, seed)` is the CRC-32 itself as a 0-d int64
tensor on data's device, the counterpart of crc32_pallas.crc32_device_jit:
the forms (per span from 256 KiB up, per block below), their tree and the
seed finish, in one launch.

On a CUDA tensor the wrappers launch csrc/crc32.cu (counted as
`crc32_forms` or `crc32_spans` by mode; `crc32_scalar` also counts its
launch under the mode its fold runs in); on a CPU tensor they run the
plain versions, crc32_forms_plain and crc32_device_scalar_plain.  The
front padding is never copied: the kernel reads index i - pad < 0 as 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build, gf2
from .crc32 import _MASK32, DEVICE_BLOCK, SPAN, TILE, _combine_tables, _table8, powers
from .deflate_device3 import _as_i32

TILES = (1, TILE)
_MODE = {1: "crc32_forms", TILE: "crc32_spans"}
_LOG_BLOCK = DEVICE_BLOCK.bit_length() - 1


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    """The CRC table (256) and A^(2^k) for k < 64 as packed columns
    (64 * 32), int32 bit patterns on `device`."""
    return tuple(
        torch.from_numpy(a.reshape(-1).astype(np.uint32).view(np.int32)).to(device)
        for a in (_table8(), powers())
    )


@functools.lru_cache(maxsize=None)
def _power_tables(device: torch.device) -> torch.Tensor:
    """A^(2^k) for k < 64 as byte lookup tables, int64 (64, 4, 256) on
    `device` (gf2.lookup_tables)."""
    t = np.stack([gf2.lookup_tables(m) for m in powers()]).astype(np.int64)
    return torch.from_numpy(t).to(device)


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
        _MODE[tile], "tz_crc32_forms", data.device,
        data.data_ptr(), data.numel(), pad, table.data_ptr(), cols.data_ptr(), out.data_ptr(),
        nb, tile,
    )
    return out


def _layout(n: int) -> tuple[int, int]:
    """(tile, pad) of an n-byte CRC: span forms from one span up, block
    forms below, front-padded to whole forms."""
    tile = TILE if n >= SPAN else 1
    return tile, (-n) % (DEVICE_BLOCK * tile)


def crc32_device_scalar_plain(data: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """crc32_device_scalar in torch ops on data's device: the plain forms,
    a tree over them front-padded to a power of two, and A^n applied to
    the raw seed by the bits of n; exact on any device."""
    _build.check_bytes("crc32_device_scalar", data)
    n, dev = data.numel(), data.device
    if n == 0:
        return torch.tensor(int(seed) & _MASK32, dtype=torch.int64, device=dev)
    tile, pad = _layout(n)
    pw = _power_tables(dev)

    def shift(k, v):  # A^(2^k) v
        t = pw[k]
        return t[0][v & 0xFF] ^ t[1][(v >> 8) & 0xFF] ^ t[2][(v >> 16) & 0xFF] ^ t[3][v >> 24]

    g = crc32_forms_plain(data, pad, tile).long() & _MASK32
    size = 1 << (g.numel() - 1).bit_length()
    g = torch.cat([g.new_zeros(size - g.numel()), g])
    k = _LOG_BLOCK + (tile.bit_length() - 1)  # log2 bytes a form
    while g.numel() > 1:
        g = shift(k, g[0::2]) ^ g[1::2]
        k += 1
    raw = torch.tensor((int(seed) & _MASK32) ^ _MASK32, dtype=torch.int64, device=dev)
    for k in range(n.bit_length()):
        if n >> k & 1:
            raw = shift(k, raw)
    return (g[0] ^ raw) ^ _MASK32


def crc32_device_scalar(data: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """The CRC-32 of `data` (a 1-D contiguous uint8 tensor starting at any
    byte) chained from `seed`, as a 0-d int64 tensor on data's device.

    Counterpart of tpuzlib/kernels/crc32_pallas.py:188 crc32_device_jit
    (which takes no seed): on a card, one launch of csrc/crc32.cu folds
    the forms (per span from 256 KiB up, per block below), and its last
    CUDA block combines them and finishes with the seed; nothing runs on
    the host."""
    if _build.on_cpu(data):
        return crc32_device_scalar_plain(data, seed)
    _build.check_bytes("crc32_device_scalar", data)
    n, dev = data.numel(), data.device
    if n == 0:
        return torch.full((), int(seed) & _MASK32, dtype=torch.int64, device=dev)
    tile, pad = _layout(n)
    nb = (n + pad) // DEVICE_BLOCK
    forms = torch.empty(nb // tile, dtype=torch.int32, device=dev)
    crc = torch.empty((), dtype=torch.int64, device=dev)
    table, cols = _constants(dev)
    ticket = _build.ticket(dev)
    _build.launch(
        ("crc32_scalar", _MODE[tile]), "tz_crc32_scalar", dev,
        data.data_ptr(), n, pad, table.data_ptr(), cols.data_ptr(), forms.data_ptr(),
        ticket.data_ptr(), crc.data_ptr(), nb, tile, (int(seed) & _MASK32) ^ _MASK32,
    )
    return crc
