"""Adler-32 per-block sums, their mod-65521 combine, and the whole
Adler-32 on the card (csrc/adler32.cu).

Counterpart of tpuzlib/kernels/adler32_pallas.py.  `adler32_blocks(data,
pad)` returns, for each 2 KiB block b of zeros(pad) | data, the exact
S_b = sum x_i and W_b = sum (2048 - i) x_i; `adler32_totals` combines them
mod 65521 as adler32_pallas.py's run function does:

  S = sum S_b,  W = sum (W_b + 2048 (nb - 1 - b) S_b)

The weights count from the end, so front zeros add nothing.

`adler32_device_scalar(data, seed)` is the Adler-32 itself as a 0-d int64
tensor on data's device, the counterpart of
adler32_pallas.adler32_device_jit: the block sums, their combine and the
seed finish in one launch.

On a CUDA tensor the wrappers launch csrc/adler32.cu's two kernels
(counted as `adler32` and `adler32_scalar`; the scalar takes the block
sums in its own kernel, through the shared block_sums, so it does not
launch `adler32`'s); on a CPU tensor they run the plain versions,
adler32_blocks_plain and adler32_device_scalar_plain.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .adler32 import _MASK32, MOD, _split

BLOCK = 2048  # bytes per block; W_b <= 255 * B * (B + 1) / 2 < 2^31
WEIGHTS = np.arange(BLOCK, 0, -1, dtype=np.int32)
WARPS = 8  # blocks a CUDA block takes at a time, a warp each
# the scalar's grid at most: the 4 CUDA blocks of 256 threads an SM that its
# 61 registers a thread leave room for (more, or a block a warp, measured
# slower on 256 MiB: probes/adler_breakdown.py)
CTAS_PER_SM = 4


def _check(data: torch.Tensor, pad: int) -> int:
    """Raise unless zeros(pad) | data is whole blocks and pad is shorter
    than one; returns the number of blocks."""
    _build.check_bytes("adler32_blocks", data)
    if not 0 <= pad < BLOCK or (data.numel() + pad) % BLOCK:
        raise ValueError("adler32_blocks: pad %d does not make %d bytes whole %d-byte blocks"
                         % (pad, data.numel(), BLOCK))
    return (data.numel() + pad) // BLOCK


def adler32_blocks_plain(data: torch.Tensor, pad: int) -> torch.Tensor:
    _check(data, pad)
    x = torch.cat([data.new_zeros(pad), data]).view(-1, BLOCK).to(torch.int32)
    w = torch.from_numpy(WEIGHTS).to(data.device)
    return torch.stack([x.sum(1), (x * w).sum(1)], 1).to(torch.int32)


def adler32_blocks(data: torch.Tensor, pad: int) -> torch.Tensor:
    """int32[(len + pad) / 2048, 2]: (S_b, W_b) of each 2 KiB block of
    zeros(pad) | data.  `data` is a 1-D contiguous uint8 tensor starting
    at any byte."""
    if _build.on_cpu(data):
        return adler32_blocks_plain(data, pad)
    nb = _check(data, pad)
    out = torch.empty((nb, 2), dtype=torch.int32, device=data.device)
    if nb:
        _build.launch("adler32", "tz_adler32_blocks", data.device,
                      data.data_ptr(), data.numel(), pad, out.data_ptr(), nb)
    return out


def adler32_totals(sw: torch.Tensor) -> torch.Tensor:
    """(S, W) mod 65521 from the per-block sums, as an int64 pair on their
    device.  Each term is reduced mod 65521 before the sum, which then
    stays far below 2^63."""
    nb = sw.shape[0]
    s = sw[:, 0].long() % MOD
    w = sw[:, 1].long() % MOD
    coef = torch.arange(nb - 1, -1, -1, dtype=torch.int64, device=sw.device) * BLOCK % MOD
    terms = (w + coef * s % MOD) % MOD
    return torch.stack([s.sum(), terms.sum()]).remainder(MOD)


def adler32_device_scalar_plain(data: torch.Tensor, seed: int = 1) -> torch.Tensor:
    """adler32_device_scalar in torch ops on data's device: the plain block
    sums, their combine and the seed finish; exact on any device."""
    _build.check_bytes("adler32_device_scalar", data)
    n, dev = data.numel(), data.device
    s1_0, s2_0 = _split(seed)
    if n == 0:
        return torch.tensor((s2_0 << 16) | s1_0, dtype=torch.int64, device=dev)
    s_total, w_total = adler32_totals(adler32_blocks_plain(data, (-n) % BLOCK))
    s1 = (s1_0 + s_total) % MOD
    s2 = (s2_0 + (n % MOD) * s1_0 + w_total) % MOD
    return s2 * 65536 + s1


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def adler32_device_scalar(data: torch.Tensor, seed: int = 1) -> torch.Tensor:
    """The Adler-32 of `data` (a 1-D contiguous uint8 tensor starting at any
    byte) chained from `seed`, as a 0-d int64 tensor on data's device.

    Counterpart of tpuzlib/kernels/adler32_pallas.py:119 adler32_device_jit
    (which takes no seed): on a card, one launch of csrc/adler32.cu takes
    the block sums and weights them, and its last CUDA block adds every
    CUDA block's sums and finishes with the seed; nothing runs on the
    host."""
    if _build.on_cpu(data):
        return adler32_device_scalar_plain(data, seed)
    _build.check_bytes("adler32_device_scalar", data)
    n, dev = data.numel(), data.device
    if n == 0:
        return torch.full((), int(seed) & _MASK32, dtype=torch.int64, device=dev)
    pad = (-n) % BLOCK
    nb = (n + pad) // BLOCK
    grid = min(-(-nb // WARPS), CTAS_PER_SM * _sms(dev))
    partials = torch.empty(2 * grid, dtype=torch.int64, device=dev)
    adler = torch.empty((), dtype=torch.int64, device=dev)
    _build.launch(
        "adler32_scalar", "tz_adler32_scalar", dev,
        data.data_ptr(), n, pad, nb, grid, partials.data_ptr(), _build.ticket(dev).data_ptr(),
        int(seed) & _MASK32, adler.data_ptr(),
    )
    return adler
