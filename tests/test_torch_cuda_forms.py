"""crc_forms_mm and take_along_loop against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA card.  The CPU
tests (test_torch_kernel_orders.py) hold the kernels' orders to the plain
versions and the tools' Pallas kernels; these hold the kernels themselves,
bit for bit, on card tensors: crc_forms_mm's wgmma kernel in both dtypes
and every tile, on both routes of its rows (TMA from a 16-byte boundary,
the consumers' own loads at offset 3), at row counts around its 64-row
wgmma tiles and its CUDA blocks, on seeded, all-zero and all-0xFF bytes;
take_along_loop's staged and read-only-cache designs at the staged limit
and one word past it, with 0, 1 and 64 steps and indices whose step wraps
int32.  Each case asserts the launch count and the route the wrapper
chose.  On a machine with a card (and no JAX, which tests/conftest.py
imports), from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_forms.py
"""

import numpy as np
import pytest
import torch

from tpuzlib_torch.kernels import _build, crc32_probe as cp, gather_probe as gp

pytestmark = pytest.mark.cuda

I32 = np.iinfo(np.int32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _routed(kernel, routes, route, fn):
    """fn()'s result, checking that it launched `kernel` once, by `route`
    (a key of the module's counter `routes`)."""
    before, taken = _build.LAUNCHES[kernel], routes[route]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + 1
    assert routes[route] == taken + 1, route
    return out


def _rows(nb, block, offset, fill, dev):
    """(nb, block) bytes on the card, seeded or all `fill`, starting
    `offset` bytes into a 16-byte aligned allocation."""
    if fill is None:
        data = np.random.default_rng(nb * 7 + block + offset).integers(
            0, 256, nb * block, dtype=np.uint8)
    else:
        data = np.full(nb * block, fill, np.uint8)
    buf = torch.zeros(nb * block + offset, dtype=torch.uint8, device=dev)
    assert buf.data_ptr() % 16 == 0
    buf[offset:] = torch.from_numpy(data).to(dev)
    return buf[offset:].view(nb, block)


@pytest.mark.parametrize("fill", [None, 0, 255])
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("block", cp.FORM_BLOCKS)
@pytest.mark.parametrize("nb", [1, 63, 64, 65, 257, 4097])
def test_crc_forms_mm(dev, nb, block, offset, fill):
    x = _rows(nb, block, offset, fill, dev)
    route = "tma" if offset == 0 else "ldg"
    assert cp.forms_route(x) == route
    for dtype in sorted(cp.DTYPES):
        want = cp.crc_forms_mm_plain(x, dtype)
        for tile in cp.TILES:
            got = _routed("crc_forms_mm_" + dtype, cp.FORM_ROUTES, route,
                          lambda: cp.crc_forms_mm(x, dtype, tile))
            assert got.dtype == torch.int32 and got.shape == (nb, 32)
            assert torch.equal(got, want), (dtype, tile)


def test_crc_forms_mm_without_rows_launches_nothing(dev):
    x = torch.zeros(0, 1024, dtype=torch.uint8, device=dev)
    before = dict(cp.FORM_ROUTES)
    for dtype in cp.DTYPES:
        assert cp.crc_forms_mm(x, dtype).shape == (0, 32)
    assert cp.FORM_ROUTES == before


def _loop_case(shape, axis, iters, seed, dev):
    rng = np.random.default_rng(seed)
    n = shape[axis]
    x = rng.integers(I32.min, I32.max, shape, dtype=np.int32)
    idx = rng.integers(-2 * n, 2 * n, shape, dtype=np.int32)
    edges = [I32.max, I32.max - 30, I32.max - 63, I32.min, -1, n, n - 1]
    idx.reshape(-1)[: len(edges)] = edges[: idx.size]
    return torch.from_numpy(x).to(dev), torch.from_numpy(idx).to(dev)


@pytest.mark.parametrize("iters", [0, 1, 64])
@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_loop_at_the_staged_limit(dev, axis, step, iters):
    """A line of exactly staged_words() words along the axis (staged) and
    one word more (read-only cache)."""
    n = gp.staged_words(dev) + step
    shape = (n, 3) if axis == 0 else (2, n)
    x, idx = _loop_case(shape, axis, iters, n + axis + iters, dev)
    design = "staged" if step == 0 else "ldg"
    assert gp.loop_design(x, axis) == design
    got = _routed("take_along_loop", gp.LOOP_ROUTES, design,
                  lambda: gp.take_along_loop(x, idx, axis, iters))
    assert torch.equal(got, gp.take_along_loop_plain(x, idx, axis, iters))


@pytest.mark.parametrize("iters", [0, 1, 64])
@pytest.mark.parametrize("axis,shape", [(0, (4352, 128)), (0, (1024, 128)), (1, (1024, 128)),
                                        (0, (129, 5)), (1, (3, 1)), (0, (1, 7)), (1, (9, 4353)),
                                        (0, (300, 129)), (1, (130, 20))])
def test_take_along_loop_staged_shapes(dev, axis, shape, iters):
    """The tools' shapes, a one-element line, lines not a multiple of the
    block's 8 (ragged column groups), rows not a multiple of 4 words (the
    staging's 4-byte copies)."""
    x, idx = _loop_case(shape, axis, iters, sum(shape) * 3 + axis + iters, dev)
    got = _routed("take_along_loop", gp.LOOP_ROUTES, "staged",
                  lambda: gp.take_along_loop(x, idx, axis, iters))
    assert torch.equal(got, gp.take_along_loop_plain(x, idx, axis, iters))
    assert torch.equal(got, gp.take_along_loop_stepped(x, idx, axis, iters))
