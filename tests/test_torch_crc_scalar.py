"""tpuzlib_torch's CRC-32 finished on the device, on the CPU.

crc32_cuda.crc32_device_scalar runs its plain version here
(crc32_device_scalar_plain): held to tpuzlib's crc32_device_jit, which
runs its Pallas span kernel in interpret mode as tests/test_checksums.py
runs it, and to zlib with seeds.  The power table its kernel applies is
held to gf2.matpow and to tpuzlib's shift_matrix.  Every comparison is
exact integer equality; inputs come from numpy seeds.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuzlib.kernels import crc32 as jcrc
from tpuzlib.kernels import crc32_pallas as jcrc_p
from tpuzlib_torch.kernels import crc32, crc32_cuda, gf2

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

SPAN = crc32.SPAN


def _data(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("n", [1, 1023, 300_000, SPAN, 2 * SPAN + 12345])
def test_scalar_plain_matches_crc32_device_jit(n):
    d = _data(n, n)
    want = int(jcrc_p.crc32_device_jit(jnp.asarray(d)))
    got = crc32_cuda.crc32_device_scalar(torch.from_numpy(d))
    assert got.dtype == torch.int64 and got.shape == () and int(got) == want
    assert int(crc32_cuda.crc32_device_scalar_plain(torch.from_numpy(d), 0)) == want


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF])
@pytest.mark.parametrize("n", [0, 1, 2049, SPAN - 1, SPAN + 1])
def test_scalar_plain_matches_zlib(n, seed):
    d = _data(n, n + 7)
    got = crc32_cuda.crc32_device_scalar_plain(torch.from_numpy(d), seed)
    assert got.dtype == torch.int64 and got.shape == ()
    assert int(got) == zlib.crc32(d.tobytes(), seed)
    assert crc32.crc32_device(torch.from_numpy(d), seed) == zlib.crc32(d.tobytes(), seed)


@pytest.mark.parametrize("n", [1, 1024, SPAN, 3 << 20, (1 << 32) + 5])
def test_power_table_composes_shift_matrices(n):
    """A^n as the product of the table's A^(2^k) over the bits of n, as the
    kernel's finish applies it."""
    p = crc32.powers()
    assert p.shape == (64, 32) and p.dtype == np.uint32
    m = gf2.identity()
    for k in range(n.bit_length()):
        if n >> k & 1:
            m = gf2.matmul(p[k], m)
    assert np.array_equal(m, gf2.matpow(crc32.byte_shift_matrix(), n))
    assert np.array_equal(m, jcrc.shift_matrix(n))
