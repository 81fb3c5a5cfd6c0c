"""tpuzlib_torch's checksums against tpuzlib's and python's zlib, on the CPU.

The port's constants, its CRC forms (per block and per span) and its
Adler block sums are held to tpuzlib's Pallas kernels, which run in
interpret mode here as the JAX package's own tests run them; the
public crc32 / adler32 are held to zlib.  Every comparison is exact
integer equality.  Inputs come from numpy seeds.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuzlib_torch
from tpuzlib.kernels import adler32 as jadler
from tpuzlib.kernels import adler32_pallas as jadler_p
from tpuzlib.kernels import crc32 as jcrc
from tpuzlib.kernels import crc32_pallas as jcrc_p
from tpuzlib.kernels import gf2 as jgf2
from tpuzlib_torch.kernels import _build, adler32, adler32_cuda, crc32, crc32_cuda, gf2

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

SPAN = crc32.SPAN
SIZES = [0, 1, 100, 2049, SPAN, 2 * SPAN + 12345]
SEEDS = [0, 1, 0xDEADBEEF]


def _data(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _u32(t):
    return t.numpy().view(np.uint32)


CONSTANTS = {
    "table": lambda m: m._table8(),
    "byte_shift_matrix": lambda m: m.byte_shift_matrix(),
    "shift_matrix": lambda m: np.stack([m.shift_matrix(n) for n in (0, 1, 1023, SPAN, 3 << 20)]),
    "block_matrix_bits": lambda m: m.block_matrix_bits(1024),
    "combine_mat": lambda m: np.stack([m._combine_mat(1024, lvl) for lvl in range(10)]),
    "combine_tables": lambda m: np.stack([m._combine_tables(1024, lvl) for lvl in range(8)]),
    "lookup_tables": lambda m: m.gf2.lookup_tables(m.shift_matrix(777)),
}


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_crc_constants_match(name):
    want, got = CONSTANTS[name](jcrc), CONSTANTS[name](crc32)
    assert want.dtype == got.dtype and np.array_equal(want, got)


def test_adler_weights_match():
    rhs = jadler_p._rhs(adler32_cuda.BLOCK)
    assert np.array_equal(rhs[:, 1] + 16 * rhs[:, 2] + 256 * rhs[:, 3], adler32_cuda.WEIGHTS)
    assert (jadler_p.BLOCK, jadler.MOD) == (adler32_cuda.BLOCK, adler32.MOD)
    assert (jcrc_p.BLOCK, jcrc_p.TILE) == (crc32.DEVICE_BLOCK, crc32.TILE)


def test_gf2_matches():
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, 1 << 32, 32, dtype=np.uint64).astype(np.uint32) for _ in range(2))
    vecs = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(gf2.identity(), jgf2.identity())
    assert gf2.apply(a, 0x9ABCDEF1) == jgf2.apply(a, 0x9ABCDEF1)
    assert np.array_equal(gf2.apply_many(a, vecs), jgf2.apply_many(a, vecs))
    assert np.array_equal(gf2.matmul(a, b), jgf2.matmul(a, b))
    assert np.array_equal(gf2.matpow(a, 12345), jgf2.matpow(a, 12345))
    t = gf2.lookup_tables(b)
    assert np.array_equal(t, jgf2.lookup_tables(b))
    assert np.array_equal(gf2.apply_tables(t, vecs), jgf2.apply_tables(t, vecs))


@pytest.mark.parametrize("n", [SPAN + 5000, 2 * SPAN - 700])
def test_crc_forms_match_pallas(n):
    """tile=1 against crc32_pallas_forms on the same front-padded blocks."""
    d = _data(n, n)
    padded = np.concatenate([np.zeros((-n) % SPAN, np.uint8), d]).reshape(-1, 1024)
    want = np.asarray(jcrc_p.crc32_pallas_forms(jnp.asarray(padded)))
    got = crc32_cuda.crc32_forms(torch.from_numpy(d), (-n) % 1024, 1)
    assert got.dtype == torch.int32
    # the port pads to whole blocks only: tpuzlib's extra front blocks are 0
    assert np.array_equal(want[: len(want) - len(got)], np.zeros(len(want) - len(got)))
    assert np.array_equal(want[len(want) - len(got):], _u32(got))


@pytest.mark.parametrize("n", [SPAN, 3 * SPAN - 12345])
def test_crc_spans_match_fused_pallas(n):
    """tile=256 against _fused_kernel_fn(1024, 256), with a front pad."""
    d = _data(n, n)
    pad = (-n) % SPAN
    blocks = jnp.asarray(np.concatenate([np.zeros(pad, np.uint8), d]).reshape(-1, 1024))
    want = np.asarray(jcrc_p._fused_kernel_fn(1024, 256)(blocks, jnp.zeros((8, 128), jnp.int32)))
    got = crc32_cuda.crc32_forms(torch.from_numpy(d), pad, 256)
    assert np.array_equal(want, _u32(got))


def test_crc_forms_are_the_bit_matrix_product():
    """The contract: L(block) = bits(block) @ block_matrix_bits(1024) mod 2."""
    d = _data(5 * 1024, 9)
    bits = np.unpackbits(d.reshape(5, 1024, 1), axis=2, bitorder="little").reshape(5, -1)
    cols = (bits.astype(np.int64) @ crc32.block_matrix_bits(1024).astype(np.int64)) & 1
    want = (cols << np.arange(32)).sum(1).astype(np.uint32)
    assert np.array_equal(want, _u32(crc32_cuda.crc32_forms(torch.from_numpy(d), 0, 1)))


@pytest.mark.parametrize("n", [512 * 1024, 2 * 512 * 1024 - 777])
def test_adler_totals_match_pallas(n):
    """Block sums (exact, against numpy) and their mod-65521 totals
    (against adler32_pallas._kernel_fn(2048, 256) on tpuzlib's padding)."""
    d = _data(n, n)
    pad = (-n) % 2048
    sw = adler32_cuda.adler32_blocks(torch.from_numpy(d), pad)
    x = np.concatenate([np.zeros(pad, np.int64), d]).reshape(-1, 2048)
    assert sw.dtype == torch.int32
    assert np.array_equal(sw.numpy(), np.stack([x.sum(1), x @ np.arange(2048, 0, -1)], 1))
    blocks = np.concatenate([np.zeros((-n) % (512 * 1024), np.uint8), d]).reshape(-1, 2048)
    want = [int(v) for v in jadler_p._kernel_fn(2048, 256)(jnp.asarray(blocks))]
    assert adler32_cuda.adler32_totals(sw).tolist() == want


@pytest.mark.parametrize("n", SIZES)
def test_device_checksums_match(n):
    d = _data(n, n + 1)
    t = torch.from_numpy(d)
    for seed in SEEDS:
        want = zlib.crc32(d.tobytes(), seed)
        assert crc32.crc32_device(t, seed) == want
        assert jcrc_p.crc32_device_pallas(d, seed) == want
        aseed = seed or 1
        want = zlib.adler32(d.tobytes(), aseed)
        assert adler32.adler32_device(t, aseed) == want
        assert jadler_p.adler32_device_pallas(d, aseed) == want


def test_combine_matches():
    a, b = _data(33333, 1), _data(SPAN + 7, 2)
    whole = a.tobytes() + b.tobytes()
    ca, cb = zlib.crc32(a.tobytes()), zlib.crc32(b.tobytes())
    aa, ab = zlib.adler32(a.tobytes()), zlib.adler32(b.tobytes())
    assert crc32.crc32_combine(ca, cb, len(b)) == jcrc.crc32_combine(ca, cb, len(b)) == zlib.crc32(whole)
    assert (adler32.adler32_combine(aa, ab, len(b)) == jadler.adler32_combine(aa, ab, len(b))
            == zlib.adler32(whole))


def test_public_checksums_take_buffers_and_chain():
    d = _data(5000, 3)
    b = d.tobytes()
    f32 = np.random.default_rng(4).random(300, dtype=np.float32)
    for fn, ref in ((tpuzlib_torch.crc32, zlib.crc32), (tpuzlib_torch.adler32, zlib.adler32)):
        for x in (b, bytearray(b), memoryview(b), d, torch.from_numpy(d), d[::-1]):
            assert fn(x, device="cpu") == ref(np.asarray(x).tobytes() if isinstance(x, np.ndarray) else b)
        assert fn(f32, device="cpu") == ref(f32.tobytes())
        sizes = [100, 5000, 1, 0, 70000, SPAN + 3, 1023]  # seven uneven pieces
        pieces = np.split(_data(sum(sizes), 5), np.cumsum(sizes)[:-1])
        acc = ref(b"")
        for p in pieces:
            acc = fn(p, acc, device="cpu")
        assert acc == ref(b"".join(p.tobytes() for p in pieces))


def test_checksum_wrappers_check_their_inputs():
    m = torch.zeros(2048, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        crc32_cuda.crc32_forms(m, 0, 1)
    with pytest.raises(ValueError):
        adler32_cuda.adler32_blocks(m, 0)
    x = torch.zeros(3000, dtype=torch.uint8)
    with pytest.raises(ValueError):  # pad does not make whole blocks
        crc32_cuda.crc32_forms(x, 0, 1)
    with pytest.raises(ValueError):  # a pad of a whole block
        crc32_cuda.crc32_forms(x, 1024 + 72, 1)
    with pytest.raises(ValueError):
        crc32_cuda.crc32_forms(x, 72, 16)
    with pytest.raises(ValueError):
        adler32_cuda.adler32_blocks(x, 1)
    with pytest.raises(TypeError):
        adler32_cuda.adler32_blocks(x.int(), 1096)
    with pytest.raises(ValueError):
        crc32_cuda.crc32_forms(x[::2], 548, 1)
    with pytest.raises(ValueError):
        tpuzlib_torch.crc32(x.reshape(3, 1000), device="cpu")
    with pytest.raises(TypeError):
        tpuzlib_torch.adler32(x.int(), device="cpu")
    with pytest.raises(TypeError):
        tpuzlib_torch.adler32(3.5, device="cpu")
    assert {"crc32_forms", "crc32_spans", "adler32"} <= set(_build.LAUNCHES)
