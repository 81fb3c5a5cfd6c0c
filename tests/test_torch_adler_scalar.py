"""tpuzlib_torch's Adler-32 finished on the device, on the CPU.

adler32_cuda.adler32_device_scalar runs its plain version here
(adler32_device_scalar_plain): held to tpuzlib's adler32_device_jit,
which runs its Pallas block kernel in interpret mode as
tests/test_checksums.py runs it, and to zlib with seeds, at lengths
around a 2 KiB block, whole and ragged spans of the scalar's CUDA blocks
(8 blocks of 2 KiB), and the public adler32 that reads it.  Every
comparison is exact integer equality; inputs come from numpy seeds.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuzlib_torch
from tpuzlib.kernels import adler32_pallas as jadler_p
from tpuzlib_torch.kernels import adler32, adler32_cuda

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

BLOCK = adler32_cuda.BLOCK
SPAN = BLOCK * adler32_cuda.WARPS  # the bytes one CUDA block of the scalar takes at a time
SIZES = [1, 2047, 2048, 2049, SPAN, 3 * SPAN + 777, 300_000]


def _data(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("n", SIZES)
def test_scalar_plain_matches_adler32_device_jit(n):
    d = _data(n, n)
    want = int(jadler_p.adler32_device_jit(jnp.asarray(d)))
    assert want == zlib.adler32(d.tobytes())
    got = adler32_cuda.adler32_device_scalar(torch.from_numpy(d))
    assert got.dtype == torch.int64 and got.shape == () and int(got) == want
    assert int(adler32_cuda.adler32_device_scalar_plain(torch.from_numpy(d), 1)) == want


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF, 0xFFF0FFF0])
@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 2 * SPAN + 1])
def test_scalar_plain_matches_zlib(n, seed):
    d = _data(n, n + 7)
    got = adler32_cuda.adler32_device_scalar_plain(torch.from_numpy(d), seed)
    assert got.dtype == torch.int64 and got.shape == ()
    assert int(got) == zlib.adler32(d.tobytes(), seed)
    assert adler32.adler32_device(torch.from_numpy(d), seed) == zlib.adler32(d.tobytes(), seed)
    assert adler32.adler32_host(d, seed) == zlib.adler32(d.tobytes(), seed)


def test_public_adler32_chains_through_the_scalar():
    """A chain of ragged pieces, each a view into one buffer at an odd
    offset, gives the whole input's Adler-32."""
    d = _data(5 * SPAN + 333, 11)
    cuts = [0, 1, 2048, 2049, 7777, 3 * SPAN, len(d)]
    adl = 1
    for lo, hi in zip(cuts, cuts[1:]):
        adl = tpuzlib_torch.adler32(torch.from_numpy(d)[lo:hi], adl)
    assert adl == zlib.adler32(d.tobytes())
    assert tpuzlib_torch.adler32(d[3:], device="cpu") == zlib.adler32(d[3:].tobytes())
