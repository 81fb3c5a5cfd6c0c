"""crc_unpack and vec_cond_while, the two probe kernels redesigned for the
card, against their plain versions on the card.

Every test here is marked `cuda` and skips without a CUDA card.  The CPU
tests (test_torch_crc_probes.py, test_torch_prim_probes.py) hold the
plain versions to the tools' Pallas kernels; these hold each kernel to
its plain version on the same card tensors, exactly:

  crc_unpack   every mode (and crc_rowsum, whose row loop it shares) on
               rows of 1 to 65,537 bytes starting at every offset 0-15 of
               a 16-byte boundary, on random bytes and on bytes all 0xFF,
               where each bf16 half reaches 256, the most it holds exact;
  vec_cond_while
               each route (registers, shared memory, device memory) at its
               edges (1, 1,023, 1,024 and 8,192 lanes, the register limit
               and the shared-memory limit one lane either side), on
               inputs that stop after 0, 1, 63 and 64 steps and one that
               the 64-step cap stops; each launch counted under its
               route's name.

On a machine with a card (and no JAX, which tests/conftest.py imports),
from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_unpack.py
"""

import numpy as np
import pytest
import torch

from tpuzlib_torch.kernels import _build, crc32_probe as cp, gather_probe as gp
from tpuzlib_torch.kernels import inflate_prims as ip

pytestmark = pytest.mark.cuda

ROWS = [1, 2, 15, 16, 17, 31, 127, 511, 512, 513, 1024, 4096, 4113, 8192 + 13, 65537]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows_at(dev, a: np.ndarray, offset: int) -> torch.Tensor:
    """The uint8 rows `a` as a card tensor whose first byte is `offset`
    bytes past a 16-byte boundary."""
    buf = torch.empty(a.size + 16, dtype=torch.uint8, device=dev)
    assert buf.data_ptr() % 16 == 0
    t = buf[offset : offset + a.size].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


@pytest.mark.parametrize("offset", range(16))
@pytest.mark.parametrize("mode", ["sum", *cp.MODES])
def test_row_kernels_on_ragged_rows(dev, mode, offset):
    rng = np.random.default_rng(16 * len(mode) + offset)
    for row in ROWS:
        nb = max(1, min(37, (1 << 20) // row))
        for fill in ("random", 0xFF):
            a = (rng.integers(0, 256, (nb, row), dtype=np.uint8) if fill == "random"
                 else np.full((nb, row), 0xFF, np.uint8))
            x = _rows_at(dev, a, offset)
            name = "crc_rowsum" if mode == "sum" else "crc_unpack_" + mode
            before = _build.LAUNCHES[name]
            if mode == "sum":
                got, want = cp.crc_rowsum(x), cp.crc_rowsum_plain(x)
            else:
                got, want = cp.crc_unpack(x, mode), cp.crc_unpack_plain(x, mode)
            torch.cuda.synchronize()
            assert _build.LAUNCHES[name] == before + 1
            assert torch.equal(got, want), (mode, offset, row, fill)
            bits = np.unpackbits(a, axis=1).sum(1) if mode != "sum" else a.sum(1, dtype=np.int64)
            assert np.array_equal(got.cpu().numpy(), bits), (mode, offset, row, fill)


def _lanes(dev, name: str) -> int:
    staged = gp.staged_words(dev)
    return {"reg limit - 1": ip.REG_LANES - 1, "reg limit": ip.REG_LANES,
            "reg limit + 1": ip.REG_LANES + 1, "staged": staged,
            "staged + 1": staged + 1}.get(name) or int(name)


# (lanes, the route they take)
EDGES = [("1", "regs"), ("1023", "regs"), ("1024", "regs"), ("1025", "regs"), ("2049", "regs"),
         ("4097", "regs"), ("reg limit - 1", "regs"), ("reg limit", "regs"),
         ("reg limit + 1", "smem"), ("staged", "smem"), ("staged + 1", "global"),
         ("100000", "global")]
# the lowest lane's value: the loop's steps are min(64, 100 - it)
STOPS = {"0 steps": 100, "1 step": 99, "63 steps": 37, "64 steps": 36, "the cap": -500}


@pytest.mark.parametrize("lanes,route", EDGES, ids=[e[0] for e in EDGES])
@pytest.mark.parametrize("stop", sorted(STOPS))
def test_vec_cond_while_routes(dev, lanes, route, stop):
    lanes = _lanes(dev, lanes)
    assert ip.while_route(lanes, gp.staged_words(dev)) == route
    rng = np.random.default_rng(lanes)
    low = STOPS[stop]
    x = rng.integers(low, 1000, (1, lanes), dtype=np.int32)
    if lanes > 1:
        x[0, -1] = np.iinfo(np.int32).max
    x[0, rng.integers(max(1, lanes - 1))] = low  # one lane at the lowest, anywhere
    x = torch.from_numpy(x).to(dev)
    counts = {r: _build.LAUNCHES["vec_cond_while_" + r] for r in ip.WHILE_ROUTES}
    total = _build.LAUNCHES["vec_cond_while"]
    got = ip.vec_cond_while(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["vec_cond_while"] == total + 1
    assert {r: _build.LAUNCHES["vec_cond_while_" + r] - counts[r] for r in ip.WHILE_ROUTES} == {
        r: int(r == route) for r in ip.WHILE_ROUTES}
    want = ip.vec_cond_while_plain(x)
    assert torch.equal(got, want)
    steps = min(64, max(0, 100 - low))
    assert int((got.long() - x.long()).max()) == steps
