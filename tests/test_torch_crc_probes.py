"""The CRC probe kernels of tpuzlib_torch against the tools' Pallas kernels.

The port's plain versions (what the wrappers run on CPU tensors) are held
to the Pallas kernels of tools/probe_crc.py, probe_crc2.py and
probe_crc3.py, run in interpret mode on the same seeded numpy bytes, with
exact integer equality.  make_forms_kernel and make_forms_seeded are
loaded from the tools' files (tools/ is no package); probe_crc2's kernels
are nested in its main(), so their bodies are copied here with their
line ranges.  Each probe of tpuzlib_torch/tools runs on the CPU.
"""

import functools
import importlib.util
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpuzlib.kernels import crc32 as jcrc
from tpuzlib_torch import tools
from tpuzlib_torch.kernels import crc32, crc32_probe
from tpuzlib_torch.tools import probe_crc, probe_crc2, probe_crc3

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, tile, blocks): tiles of the tools' kernels at small shapes
SHAPES = [(1024, 8, 16), (4096, 4, 8)]


@functools.lru_cache()
def _tool(name):
    spec = importlib.util.spec_from_file_location("tool_" + name,
                                                  os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bytes(nb, block, seed):
    return np.random.default_rng(seed).integers(0, 256, (nb, block), dtype=np.uint8)


def _packed(cols):
    """The tool's packing of parity columns to forms (probe_crc.py:186-191)."""
    return np.sum(cols.astype(np.uint32) << np.arange(32, dtype=np.uint32)[None, :], axis=1,
                  dtype=np.uint32)


@pytest.mark.parametrize("block", [1024, 4096])
def test_plane_matrix_matches_the_tools(block):
    m_raw = jcrc.block_matrix_bits(block)
    want = np.concatenate([m_raw[i::8] for i in range(8)])  # probe_crc.py:75
    got = crc32.plane_matrix_bits(block)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("mode", probe_crc.MODES)
@pytest.mark.parametrize("block,tile,nb", SHAPES)
def test_forms_match_make_forms_kernel(mode, block, tile, nb):
    """All four modes of the tool's forms kernel; the port's columns, its
    packed forms, and the CRC through its host combine."""
    x = _bytes(nb, block, block + tile)
    want = np.asarray(_tool("probe_crc").make_forms_kernel(block, tile, mode)(jnp.asarray(x)))
    dtype = mode.split("_")[1]
    got = crc32_probe.crc_forms_mm(torch.from_numpy(x), dtype, crc32_probe.TILES[0])
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(crc32_probe.pack_forms(got).numpy().view(np.uint32), _packed(want))
    assert tools.forms_crc(got, block, x.size) == zlib.crc32(x.tobytes())


@pytest.mark.parametrize("block,tile,nb", SHAPES)
def test_forms_match_make_forms_seeded(block, tile, nb):
    x = _bytes(nb, block, 3 * block + tile)
    run = _tool("probe_crc3").make_forms_seeded(block, tile)
    want = np.asarray(run(jnp.asarray(x), jnp.zeros((8, 128), jnp.int32)))
    for dtype in crc32_probe.DTYPES:
        assert np.array_equal(crc32_probe.crc_forms_mm(torch.from_numpy(x), dtype).numpy(), want)


# tools/probe_crc2.py:92-95
def _sum_kernel(b_ref, o_ref):
    o_ref[:] = jnp.sum(
        b_ref[:].astype(jnp.int32), axis=1, keepdims=True
    ) * jnp.ones((1, 128), jnp.int32)


# tools/probe_crc2.py:125-145
def _unpack_kernel(tile, block, mode):
    def kernel(b_ref, o_ref):
        if mode == "u8":
            raw = b_ref[:]
            acc = jnp.zeros((tile, block), jnp.uint8)
            for i in range(8):
                acc = acc + ((raw >> i) & 1)
            acc32 = acc.astype(jnp.int32)
        elif mode == "i32":
            raw = b_ref[:].astype(jnp.int32)
            acc32 = jnp.zeros((tile, block), jnp.int32)
            for i in range(8):
                acc32 = acc32 + ((raw >> i) & 1)
        else:  # bf16: includes the conversion the matmul needs
            raw = b_ref[:].astype(jnp.int32)
            accb = jnp.zeros((tile, block), jnp.bfloat16)
            for i in range(8):
                accb = accb + ((raw >> i) & 1).astype(jnp.bfloat16)
            acc32 = accb.astype(jnp.int32)
        o_ref[:] = jnp.sum(acc32, axis=1, keepdims=True) * jnp.ones(
            (1, 128), jnp.int32
        )

    return kernel


# tools/probe_crc2.py:179-187
def _mm_kernel(tile, block):
    def mm_kernel(bits_ref, m_ref, o_ref):
        acc = jnp.zeros((tile, 32), jnp.float32)
        for i in range(8):
            acc = acc + jnp.dot(
                bits_ref[:, i * block : (i + 1) * block],
                m_ref[i * block : (i + 1) * block, :].astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            )
        o_ref[:] = acc.astype(jnp.int32) & 1

    return mm_kernel


def _row_call(kernel, x, tile):
    """The tools' row kernels' call (probe_crc2.py:100-107, :150-157)."""
    nb, block = x.shape
    return np.asarray(pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((nb, 128), jnp.int32),
        grid=(nb // tile,),
        in_specs=[pl.BlockSpec((tile, block), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((tile, 128), lambda i: (i, 0)),
        interpret=True,
    )(jnp.asarray(x)))


def _lanes_equal(want, got):
    """The tool's sum, broadcast over 128 lanes, against one int32 a row."""
    assert (want == want[:, :1]).all()
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want[:, 0])


@pytest.mark.parametrize("seed", [0, 1])
def test_rowsum_matches_the_tools_sum_kernel(seed):
    x = _bytes(16, 1024, seed)
    x[3] = 255  # a row at the largest sum
    _lanes_equal(_row_call(_sum_kernel, x, 8), crc32_probe.crc_rowsum(torch.from_numpy(x)))


@pytest.mark.parametrize("mode", sorted(crc32_probe.MODES))
def test_unpack_matches_the_tools_unpack_kernel(mode):
    x = _bytes(16, 1024, 5)
    x[2], x[9] = 0, 255
    got = crc32_probe.crc_unpack(torch.from_numpy(x), mode)
    _lanes_equal(_row_call(_unpack_kernel(8, 1024, mode), x, 8), got)
    assert np.array_equal(got.numpy(), np.unpackbits(x, axis=1).sum(1))


def test_gf2_bits_mm_matches_the_tools_mm_kernel():
    """Bits unpacked beforehand, plane-major (probe_crc2.py:206-210)."""
    tile, block, nb = 8, 1024, 16
    x = _bytes(nb, block, 11)
    bits = np.zeros((nb, 8 * block), np.float32)
    for i in range(8):
        bits[:, i * block : (i + 1) * block] = (x >> i) & 1
    m_bits = crc32.plane_matrix_bits(block)
    want = np.asarray(pl.pallas_call(
        _mm_kernel(tile, block),
        out_shape=jax.ShapeDtypeStruct((nb, 32), jnp.int32),
        grid=(nb // tile,),
        in_specs=[pl.BlockSpec((tile, 8 * block), lambda i: (i, 0)),
                  pl.BlockSpec((block * 8, 32), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((tile, 32), lambda i: (i, 0)),
        interpret=True,
    )(jnp.asarray(bits, jnp.bfloat16), jnp.asarray(m_bits)))
    tbits = torch.from_numpy(bits).to(torch.bfloat16)
    assert torch.equal(crc32_probe.plane_bits(torch.from_numpy(x)), tbits)
    got = crc32_probe.gf2_bits_mm(tbits, crc32_probe.form_matrix(block, torch.bfloat16,
                                                                 torch.device("cpu")))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, crc32_probe.crc_forms_mm(torch.from_numpy(x)))


@pytest.mark.parametrize("fill", ["random", "ones"])
@pytest.mark.parametrize("K", [128, 256, 384, 640, 1024, 2048, 4096])
def test_gf2_bits_mm_matches_the_tools_mm_kernel_on_random_matrices(K, fill):
    """The tool's kernel at more shapes, K = 8 x block (block 16 to 512),
    on random 0/1 M and random bits or all ones (a column's sum then its
    count of ones in M, up to K): the plain version gives its columns."""
    tile, block, nb = 8, K // 8, 16
    rng = np.random.default_rng(K)
    bits = (np.ones((nb, K), np.float32) if fill == "ones"
            else rng.integers(0, 2, (nb, K)).astype(np.float32))
    m = rng.integers(0, 2, (K, 32)).astype(np.float32)
    want = np.asarray(pl.pallas_call(
        _mm_kernel(tile, block),
        out_shape=jax.ShapeDtypeStruct((nb, 32), jnp.int32),
        grid=(nb // tile,),
        in_specs=[pl.BlockSpec((tile, K), lambda i: (i, 0)),
                  pl.BlockSpec((K, 32), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((tile, 32), lambda i: (i, 0)),
        interpret=True,
    )(jnp.asarray(bits, jnp.bfloat16), jnp.asarray(m)))
    tbits, tm = (torch.from_numpy(a).to(torch.bfloat16) for a in (bits, m))
    got = crc32_probe.gf2_bits_mm(tbits, tm)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(want, (bits.astype(np.int64) @ m.astype(np.int64)) & 1)


def test_plain_versions_work_in_row_slices(monkeypatch):
    """Slices of a few rows give what one slice gives, for every kernel."""
    x = torch.from_numpy(_bytes(37, 1024, 13))
    bits = crc32_probe.plane_bits(x)
    m = crc32_probe.form_matrix(1024, torch.bfloat16, torch.device("cpu"))
    calls = [lambda: crc32_probe.crc_rowsum(x), lambda: crc32_probe.gf2_bits_mm(bits, m),
             lambda: crc32_probe.crc_forms_mm(x, "i8")]
    calls += [functools.partial(crc32_probe.crc_unpack, x, mode) for mode in crc32_probe.MODES]
    whole = [c() for c in calls]
    monkeypatch.setattr(crc32_probe, "_WORK", 1)  # one row a slice
    for c, w in zip(calls, whole):
        assert torch.equal(c(), w)
    assert crc32_probe.crc_rowsum(x[:0]).shape == (0,)
    assert crc32_probe.crc_forms_mm(x[:0]).shape == (0, 32)


def test_probe_wrappers_check_their_inputs():
    x = torch.zeros(4, 1024, dtype=torch.uint8)
    bits = torch.zeros(4, 256, dtype=torch.bfloat16)
    m = torch.zeros(256, 32, dtype=torch.bfloat16)
    for call, exc in (
        (lambda: crc32_probe.crc_rowsum(x.int()), TypeError),
        (lambda: crc32_probe.crc_rowsum(x[:, ::2]), ValueError),
        (lambda: crc32_probe.crc_rowsum(x.reshape(-1)), ValueError),
        (lambda: crc32_probe.crc_rowsum(x[:, :0]), ValueError),
        (lambda: crc32_probe.crc_unpack(x, "u16"), ValueError),
        (lambda: crc32_probe.crc_forms_mm(x[:, :512].contiguous()), ValueError),
        (lambda: crc32_probe.crc_forms_mm(x, "fp8"), ValueError),
        (lambda: crc32_probe.crc_forms_mm(x, "bf16", 300), ValueError),
        (lambda: crc32_probe.gf2_bits_mm(bits.float(), m), TypeError),
        (lambda: crc32_probe.gf2_bits_mm(bits[:, :200].contiguous(), m[:200]), ValueError),
        (lambda: crc32_probe.gf2_bits_mm(bits, m[:, :16].contiguous()), ValueError),
    ):
        with pytest.raises(exc):
            call()


@pytest.mark.parametrize("probe", [probe_crc, probe_crc2, probe_crc3],
                         ids=["probe_crc", "probe_crc2", "probe_crc3"])
def test_probe_runs_on_the_cpu(probe, capsys):
    """Each probe prints its card line, then one JSON line a measurement
    under the tool's names, every check passing."""
    probe.main(["--device", "cpu", "--mib", "1", "--reps", "1"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"nvidia_smi": None, "device": "cpu", "clock": "host"}
    names = [d["name"] for d in lines[1:]]
    assert all(d["bytes"] > 0 and d["ms_per_pass"] > 0 for d in lines[1:])
    want = {
        probe_crc: ["read+sum", "read+sum", "full (r4 baseline)"]
        + ["forms %s B%d T%d" % (mode, b, t)
           for mode in probe_crc.MODES for b, t in probe_crc.PAIRS],
        probe_crc2: ["read2d", "pallas read+rowsum", "pallas unpack u8", "pallas unpack i32",
                     "pallas unpack bf16", "matmul-only (8MB data)"],
        probe_crc3: ["forms(copy-free) B%d T%d" % p for p in probe_crc3.PAIRS]
        + ["full crc (copy-free)", "adler"],
    }[probe]
    assert names == want
