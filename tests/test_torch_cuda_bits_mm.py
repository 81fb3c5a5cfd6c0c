"""gf2_bits_mm, redesigned for the card, against its plain version on the
card.

Every test here is marked `cuda` and skips without a CUDA card.  The CPU
tests (test_torch_crc_probes.py, test_torch_kernel_orders.py) hold the
plain version to the tool's Pallas kernel and check the wrapper's inputs;
these hold the kernel to its plain version on the same card tensors,
exactly, and assert each launch and its route (crc32_probe.BITS_ROUTES):

  random 0/1 bits and matrices at nb of 1 to 8,192 rows (one and two
  rows past a CUDA block of 128, a ragged last block) and K of 128 (fewer
  stages than the cluster's blocks at most take), 384, 1,024, 8,192 and
  16,384, with the bits on a 16-byte boundary (route "tma") and 2, 3
  and 4 elements past one (route "ldg": 3 by the funnel-shift loads of
  words off a 4-byte boundary, 2 and 4 by the loads of whole words); all
  ones at K = 8,192, where each sum reaches 8,192.

On a machine with a card (and no JAX, which tests/conftest.py imports),
from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_bits_mm.py
"""

import pytest
import torch

from tpuzlib_torch.kernels import _build, crc32_probe as cp

pytestmark = pytest.mark.cuda

NB = [1, 33, 127, 128, 129, 4097, 8192]
KS = [128, 384, 1024, 8192, 16384]
OFFSETS = [(0, "tma"), (2, "ldg"), (3, "ldg"), (4, "ldg")]  # elements past 16 bytes


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _at(dev, a: torch.Tensor, offset: int) -> torch.Tensor:
    """a as a bf16 card tensor `offset` elements past a 16-byte boundary."""
    buf = torch.empty(a.numel() + 8, dtype=torch.bfloat16, device=dev)
    assert buf.data_ptr() % 16 == 0
    t = buf[offset : offset + a.numel()].view(a.shape)
    t.copy_(a)
    return t


def _launched(x, m, route):
    before, routes = _build.LAUNCHES["gf2_bits_mm"], dict(cp.BITS_ROUTES)
    got = cp.gf2_bits_mm(x, m)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gf2_bits_mm"] == before + 1
    assert {r: cp.BITS_ROUTES[r] - routes[r] for r in cp.ROUTES} == {
        r: int(r == route) for r in cp.ROUTES}
    return got


@pytest.mark.parametrize("offset,route", OFFSETS)
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("nb", NB)
def test_gf2_bits_mm_on_random_bits(dev, nb, K, offset, route):
    g = torch.Generator(device=dev)
    g.manual_seed(31 * nb + K + offset)
    bits = torch.randint(0, 2, (nb, K), generator=g, device=dev).to(torch.bfloat16)
    m = torch.randint(0, 2, (K, 32), generator=g, device=dev).to(torch.bfloat16)
    x = _at(dev, bits, offset)
    assert cp.bits_mm_route(x) == route
    got = _launched(x, m, route)
    assert got.shape == (nb, 32) and got.dtype == torch.int32
    assert torch.equal(got, cp.gf2_bits_mm_plain(x, m)), (nb, K, route)


@pytest.mark.parametrize("matrix", ["ones", "random"])
@pytest.mark.parametrize("offset,route", OFFSETS)
@pytest.mark.parametrize("nb", NB)
def test_gf2_bits_mm_all_ones(dev, nb, offset, route, matrix):
    """Every bit set at K = 8,192: a column's sum is its count of ones in
    M, 8,192 for a column of ones (parity 0)."""
    K = 8192
    g = torch.Generator(device=dev)
    g.manual_seed(nb + offset)
    m = (torch.ones(K, 32, device=dev) if matrix == "ones"
         else torch.randint(0, 2, (K, 32), generator=g, device=dev)).to(torch.bfloat16)
    x = _at(dev, torch.ones(nb, K, dtype=torch.bfloat16, device=dev), offset)
    got = _launched(x, m, route)
    want = (m.sum(0, dtype=torch.int64) & 1).int().expand(nb, 32)
    assert torch.equal(got, want)
    assert torch.equal(got, cp.gf2_bits_mm_plain(x, m))
