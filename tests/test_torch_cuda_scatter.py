"""scatter_max's two routes against its plain version, on the card.

Every test here is marked `cuda` and skips without a CUDA card.  The smem
route (a chunk's slab of columns max-scattered in shared memory, every
output word written by the kernel) takes rows up to staged_words(); the
global route (an atomic an element into zeros) takes more.  Each case
asserts its route through gather_probe.SCATTER_ROUTES and its launch, at
ragged widths (1, 4, 127, 128, 129 columns) and rows (1, 7, 2,304, 4,353,
staged_words() + 1), with idx off a 16-byte boundary, duplicates in one
column, wrapped and dropped indices, and negative values that lose to
the zeros.  Every comparison is exact.  On a machine with a card (and no
JAX, which tests/conftest.py imports), from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_scatter.py
"""

import numpy as np
import pytest
import torch

from tpuzlib_torch.kernels import _build, gather_probe as gp

pytestmark = pytest.mark.cuda

I32 = np.iinfo(np.int32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(dev, a, offset=0):
    """A numpy array as an int32 card tensor, `offset` words into its buffer
    (an offset of 1 starts it off a 16-byte boundary)."""
    a = np.ascontiguousarray(a).view(np.int32)
    buf = torch.empty(a.size + offset, dtype=torch.int32, device=dev)
    t = buf[offset:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


def _inputs(rng, shape, rows):
    """Seeded indices over [-rows, rows) with a column of duplicates and the
    rule's edges (wrapped, dropped, int32's ends), and non-negative values
    with negative ones that lose to the zeros."""
    idx = rng.integers(-rows, rows, shape, dtype=np.int32)
    idx[..., 0] = 0  # a column of duplicates
    flat = idx.reshape(-1)
    flat[1:7] = [rows, -rows - 1, I32.min, I32.max, -1, rows - 1][: max(0, flat.size - 1)]
    vals = rng.integers(0, I32.max, shape, dtype=np.int32)
    vals.reshape(-1)[-3:] = -5  # negative values lose to the zeros
    vals.reshape(-1)[:1] = I32.min
    return idx, vals


def _routed(route, fn, plain):
    """fn() launches scatter_max once, by `route`, and equals plain()."""
    before, routes = _build.LAUNCHES["scatter_max"], dict(gp.SCATTER_ROUTES)
    got = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["scatter_max"] == before + 1
    assert {r: gp.SCATTER_ROUTES[r] - routes[r] for r in gp.SCATTER_DESIGNS} == {
        r: int(r == route) for r in gp.SCATTER_DESIGNS}
    want = plain()
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("rows", [1, 7, 2304, 4353, "staged+1"])
@pytest.mark.parametrize("w", [1, 4, 127, 128, 129])
def test_scatter_routes(dev, w, rows, offset):
    staged = gp.staged_words(dev)
    rows = staged + 1 if rows == "staged+1" else rows
    route = "global" if rows > staged else "smem"
    rng = np.random.default_rng(w * 7 + rows % 1000 + offset)
    shape = (3, 37, w)
    idx, vals = _inputs(rng, shape, rows)
    idx, vals = _on(dev, idx, offset), _on(dev, vals)
    assert gp.scatter_route(idx, rows) == route
    zeros = torch.zeros_like(vals)
    for v in (vals, zeros):
        got = _routed(route, lambda: gp.scatter_max(idx, v, rows),
                      lambda: gp.scatter_max_plain(idx, v, rows))
    assert not got.any()


@pytest.mark.parametrize("shape,rows", [((8, 2304, 128), 2304), ((256, 128), 256),
                                        ((1, 1), 1), ((4353, 129), 7), ((3, 5, 127), 4353),
                                        ((2, 600, 12), 58112)])
def test_scatter_shapes(dev, shape, rows):
    """The encoder batch's and the tool's shapes, one element, many rows
    into few, few into many, and a slab of one column at the staged limit."""
    staged = gp.staged_words(dev)
    route = "global" if rows > staged else "smem"
    rng = np.random.default_rng(sum(shape) + rows)
    idx, vals = _inputs(rng, shape, rows)
    idx, vals = _on(dev, idx), _on(dev, vals, 1)
    _routed(route, lambda: gp.scatter_max(idx, vals, rows),
            lambda: gp.scatter_max_plain(idx, vals, rows))


@pytest.mark.parametrize("cols", [1, 2, 3, 4, 8, 12, 16])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape,rows", [((8, 2304, 128), 2304), ((2, 33, 132), 300),
                                        ((1, 9, 5), 4353)])
def test_scatter_slab_widths(dev, shape, rows, cols, offset):
    """The smem route at every slab width the probe times (and 3, 12), each
    with its block from scatter_threads, through the entry point: a last
    slab narrower than the rest, units of 4 columns and of 1; a slab past
    the shared memory (4,353 rows of 16 columns) is refused."""
    rng = np.random.default_rng(cols * 31 + rows + offset)
    idx, vals = _inputs(rng, shape, rows)
    idx, vals = _on(dev, idx, offset), _on(dev, vals)
    b, r, w = shape
    out = torch.empty(b, rows, w, dtype=torch.int32, device=dev)
    args = (idx.data_ptr(), vals.data_ptr(), b, r, w, rows, cols,
            gp.scatter_threads(r, w, rows, cols), out.data_ptr())
    if rows * cols > gp.staged_words(dev):
        with pytest.raises(RuntimeError):
            _build.launch("scatter_max", "tz_scatter_max", dev, *args)
        return
    _build.launch("scatter_max", "tz_scatter_max", dev, *args)
    torch.cuda.synchronize()
    assert torch.equal(out, gp.scatter_max_plain(idx, vals, rows))
    assert torch.equal(out.cpu(), gp.slab_scatter_plain(idx.cpu(), vals.cpu(), rows, cols))


def test_scatter_refuses_a_slab_past_shared_memory(dev):
    """The entry point refuses a slab that does not fit, and a block
    narrower than its slab or not a multiple of 32."""
    staged = gp.staged_words(dev)
    idx = torch.zeros(1, 2, 4, dtype=torch.int32, device=dev)
    out = torch.empty(1, staged + 1, 4, dtype=torch.int32, device=dev)
    for rows, cols, threads in ((staged + 1, 1, 32), (staged // 2 + 1, 2, 32), (8, 4, 48),
                                (8, 4, 1024), (8, 64, 32)):
        with pytest.raises(RuntimeError):
            _build.launch("scatter_max", "tz_scatter_max", dev, idx.data_ptr(), idx.data_ptr(),
                          1, 2, 4, rows, cols, threads, out.data_ptr())
