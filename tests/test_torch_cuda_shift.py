"""shift_screen, redesigned for the card, against its plain version on the
card.

Every test here is marked `cuda` and skips without a CUDA card.  The CPU
tests (test_torch_prim_probes.py, test_torch_kernel_orders.py) hold the
plain version to the tool's Pallas kernel and replay the register route's
split of a chunk and its lanes; these hold the kernel to its plain version
on the same card tensors, exactly, and assert each launch and its route
(gather_probe.SHIFT_ROUTES):

  steps 0, 1, 15, 16 (the register route, up to SHIFT_WINDOW), 17, 40
  and 4,096 (the staged route) on chunks of 1, 3 and 10 words (all of
  them screened one at a time, shifts that wrap more than once), 129 and
  294,912 (a body of whole int4s between them), with x 0 to 3 words past
  a 16-byte boundary (the output lies as far past one); 65,535 chunks of
  1, 3 and 10 words.

On a machine with a card (and no JAX, which tests/conftest.py imports),
from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_shift.py
"""

import numpy as np
import pytest
import torch

from tpuzlib_torch.kernels import _build, gather_probe as gp

pytestmark = pytest.mark.cuda

STEPS = [0, 1, 15, 16, 17, 40, gp.MAX_STEPS]
CHUNKS = [1, 3, 10, 129, 294912]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(dev, a: np.ndarray, offset: int) -> torch.Tensor:
    """a as an int32 card tensor `offset` words past a 16-byte boundary."""
    buf = torch.empty(a.size + 4, dtype=torch.int32, device=dev)
    assert buf.data_ptr() % 16 == 0
    t = buf[offset : offset + a.size].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


def _screened(x, steps):
    route = gp._shift_design(steps)
    assert gp.shift_route(x, steps) == route
    before, routes = _build.LAUNCHES["shift_screen"], dict(gp.SHIFT_ROUTES)
    got = gp.shift_screen(x, steps)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["shift_screen"] == before + 1
    assert {r: gp.SHIFT_ROUTES[r] - routes[r] for r in gp.SHIFT_DESIGNS} == {
        r: int(r == route) for r in gp.SHIFT_DESIGNS}
    assert got.shape == x.shape and got.dtype == torch.int32
    assert got.data_ptr() % 16 == x.data_ptr() % 16
    assert torch.equal(got, gp.shift_screen_plain(x, steps)), (tuple(x.shape), steps)


@pytest.mark.parametrize("offset", range(4))
@pytest.mark.parametrize("n", CHUNKS)
@pytest.mark.parametrize("steps", STEPS)
def test_shift_screen_routes(dev, steps, n, offset):
    rng = np.random.default_rng(n + steps + offset)
    b = 3 if n > 1000 else 7
    x = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, (b, 1, n), dtype=np.int32)
    _screened(_on(dev, x, offset), steps)


@pytest.mark.parametrize("steps", [16, 40])
@pytest.mark.parametrize("n", [1, 3, 10])
def test_shift_screen_most_chunks(dev, n, steps):
    rng = np.random.default_rng(n)
    x = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, (65535, 1, n),
                     dtype=np.int32)
    _screened(_on(dev, x, 1), steps)
