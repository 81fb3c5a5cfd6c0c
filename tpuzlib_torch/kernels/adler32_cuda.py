"""Adler-32 per-block sums and their mod-65521 combine.

Counterpart of tpuzlib/kernels/adler32_pallas.py.  `adler32_blocks(data,
pad)` returns, for each 2 KiB block b of zeros(pad) | data, the exact
S_b = sum x_i and W_b = sum (2048 - i) x_i; `adler32_totals` combines them
mod 65521 as adler32_pallas.py's run function does:

  S = sum S_b,  W = sum (W_b + 2048 (nb - 1 - b) S_b)

The weights count from the end, so front zeros add nothing.  On a CUDA
tensor the wrapper launches csrc/adler32.cu (counted as `adler32`); on a
CPU tensor it runs the plain version, adler32_blocks_plain.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .adler32 import MOD

BLOCK = 2048  # bytes per block; W_b <= 255 * B * (B + 1) / 2 < 2^31
WEIGHTS = np.arange(BLOCK, 0, -1, dtype=np.int32)


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


def adler32_totals(sw: torch.Tensor) -> tuple[int, int]:
    """(S, W) mod 65521 from the per-block sums, combined on their device.
    Each term is reduced mod 65521 before the sum, which then stays far
    below 2^63."""
    nb = sw.shape[0]
    s = sw[:, 0].long() % MOD
    w = sw[:, 1].long() % MOD
    coef = torch.arange(nb - 1, -1, -1, dtype=torch.int64, device=sw.device) * BLOCK % MOD
    terms = (w + coef * s % MOD) % MOD
    s_total, w_total = torch.stack([s.sum(), terms.sum()]).remainder(MOD).tolist()
    return s_total, w_total
