"""take_along and flat_gather against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA card.  Both
kernels of csrc/gather_probe.cu choose a design by shape: 16-byte index
and output streams where the index row's width is a multiple of 4 and
every pointer is 16-byte aligned, else one element at a time; an axis-1
row of x, or flat_gather's table, staged in shared memory up to
gather_probe.staged_words() words, else gathered through the read-only
cache.  These cases hold every design to its plain version, exactly: the
widths 1, 3, 4, 5, 127, 128, 129 and 4,352; a row and a table at the
staged limit and one word either side; x, idx and out each one word off a
16-byte boundary; negative, out-of-range and int32's extreme indices with
both fills; fewer than 4 indices; 3-D indices; offsets past 2^31 words;
a call on a side stream queued behind a sleep (the launch must use the
current stream); and a call on a second card (skipped with one).  On a
machine with a card (and no JAX, which tests/conftest.py imports), from
the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_gather.py
"""

import numpy as np
import pytest
import torch

from tpuzlib_torch.kernels import _build, gather_probe as gp

pytestmark = pytest.mark.cuda

I32 = np.iinfo(np.int32)
WIDTHS = [1, 3, 4, 5, 127, 128, 129, 4352]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def staged(dev):
    """The widest row or table the kernels stage in shared memory."""
    words = gp.staged_words(dev)
    assert words * 4 >= 48 * 1024  # a Hopper card opts in to 227 KB
    return words


def _on(dev, a, offset=0):
    """A numpy array as an int32 card tensor, `offset` words into its buffer
    (an offset of 1 starts it off a 16-byte boundary)."""
    a = np.ascontiguousarray(a).view(np.int32)
    buf = torch.empty(a.size + offset, dtype=torch.int32, device=dev)
    t = buf[offset:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


def _out(like, offset):
    """An int32 card tensor of like's shape, `offset` words into its buffer."""
    buf = torch.full((like.numel() + offset,), 7, dtype=torch.int32, device=like.device)
    return buf[offset:].view(like.shape)


def _indices(rng, n, shape):
    """Indices over every rule: in range, [-n, 0), below -n, n and above,
    int32's ends, at the front; the rest in [-n, n)."""
    idx = rng.integers(-n, n, shape, dtype=np.int32)
    edges = np.array([0, n - 1, -1, -n, -n - 1, n, n + 72, I32.min, I32.max], np.int32)
    flat = idx.reshape(-1)
    flat[: min(flat.size, edges.size)] = edges[: flat.size]
    return idx


def _take_into(x, idx, axis, fill, out):
    """take_along's kernel writing into `out` (a view the wrapper would not
    allocate): one launch."""
    _build.launch("take_along", "tz_take_along", x.get_device(), x.data_ptr(), x.shape[0],
                  x.shape[1], idx.data_ptr(), idx.shape[0], idx.shape[1], axis, fill,
                  out.data_ptr())
    return out


def _flat_into(table, idx, out):
    _build.launch("flat_gather", "tz_flat_gather", table.get_device(), table.data_ptr(),
                  table.numel(), idx.data_ptr(), idx.numel(), out.data_ptr())
    return out


def _same(kernel, fn, plain):
    """fn() launches `kernel` once and equals plain() exactly."""
    before = _build.LAUNCHES[kernel]
    got = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + 1
    want = plain()
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    return got


# ---- take_along ------------------------------------------------------------------

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_widths(dev, axis, width):
    """Index rows of each width, x as tall or as wide as the tools'."""
    rng = np.random.default_rng(width * 2 + axis)
    xshape = (300, width) if axis == 0 else (5, 4352)
    ishape = (7, width) if axis == 0 else (5, width)
    n = xshape[axis]
    x = _on(dev, rng.integers(I32.min, I32.max, xshape, dtype=np.int32))
    idx = _on(dev, _indices(rng, n, ishape))
    for fill in (gp.INT32_MIN, -1):
        _same("take_along", lambda: gp.take_along(x, idx, axis, fill),
              lambda: gp.take_along_plain(x, idx, axis, fill))


@pytest.mark.parametrize("where", ["x", "idx", "out"])
@pytest.mark.parametrize("axis,xshape,ishape", [
    (1, (64, 4352), (64, 4352)), (1, (3, 128), (3, 129)), (0, (4352, 128), (4352, 128)),
    (0, (9, 4), (2, 4)),
])
def test_take_along_off_a_boundary(dev, axis, xshape, ishape, where):
    """x, idx or out one word past a 16-byte boundary: the kernel takes
    the element-at-a-time stream, or stages x's row 4 bytes a copy."""
    rng = np.random.default_rng(sum(xshape) + sum(ishape) + len(where))
    x = _on(dev, rng.integers(I32.min, I32.max, xshape, dtype=np.int32), where == "x")
    idx = _on(dev, _indices(rng, xshape[axis], ishape), where == "idx")
    out = _out(idx, where == "out")
    _same("take_along", lambda: _take_into(x, idx, axis, -1, out),
          lambda: gp.take_along_plain(x, idx, axis, -1))


@pytest.mark.parametrize("step", [-1, 0, 1])
@pytest.mark.parametrize("ic", [4352, 129, 2])
def test_take_along_at_the_staged_width(dev, staged, step, ic):
    """Rows of x at the staged limit (staged, 227 KB of shared memory on an
    H100) and one word either side (staged, gathered through the cache)."""
    xc = staged + step
    rng = np.random.default_rng(xc + ic)
    x = _on(dev, rng.integers(I32.min, I32.max, (3, xc), dtype=np.int32))
    idx = _indices(rng, xc, (3, ic))
    idx[:, -1] = xc - 1  # the row's last word
    idx = _on(dev, idx)
    _same("take_along", lambda: gp.take_along(x, idx, 1),
          lambda: gp.take_along_plain(x, idx, 1))


@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_past_2_31_words(dev, axis):
    """x of more than 2^31 words: the 64-bit offsets; the gathers reach
    its last rows and columns."""
    cols = 128 if axis == 0 else 4352
    rows = (1 << 31) // cols + 1
    x = torch.randint(I32.min, I32.max, (rows, cols), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(axis)
    if axis == 0:
        idx = rng.integers(rows - 1000, rows, (5, cols), dtype=np.int32)
        idx[0, :3] = [-1, rows - 1, rows]
    else:
        idx = rng.integers(cols - 8, cols, (rows, 4), dtype=np.int32)
    idx = _on(dev, idx)
    _same("take_along", lambda: gp.take_along(x, idx, axis),
          lambda: gp.take_along_plain(x, idx, axis))


def test_take_along_on_the_current_stream(dev):
    """A call under torch.cuda.stream(s), s queued behind a sleep and the
    inputs written on s after it: a launch on any other stream would run
    before them and read the zeros."""
    rng = np.random.default_rng(5)
    x_host = torch.from_numpy(rng.integers(I32.min, I32.max, (64, 4352), dtype=np.int32))
    i_host = torch.from_numpy(rng.integers(0, 4352, (64, 4352), dtype=np.int32))
    x = torch.zeros(64, 4352, dtype=torch.int32, device=dev)
    idx = torch.zeros_like(x)
    x_src, i_src = x_host.to(dev), i_host.to(dev)
    torch.cuda.synchronize()
    s = torch.cuda.Stream(dev)
    with torch.cuda.stream(s):
        torch.cuda._sleep(100_000_000)  # ~50 ms
        x.copy_(x_src)
        idx.copy_(i_src)
        got = gp.take_along(x, idx, 1)
        got0 = gp.take_along(x, idx, 0)
        fgot = gp.flat_gather(x[:8], idx)
    s.synchronize()
    assert torch.equal(got.cpu(), gp.take_along_plain(x_host, i_host, 1))
    assert torch.equal(got0.cpu(), gp.take_along_plain(x_host, i_host, 0))
    assert torch.equal(fgot.cpu(), gp.flat_gather_plain(x_host[:8].contiguous(), i_host))


# ---- flat_gather -----------------------------------------------------------------

@pytest.mark.parametrize("tshape,ishape", [
    ((256, 128), (8, 2304, 128)), ((1,), (1, 1)), ((8, 128), (129, 127)), ((4353,), (3, 4353)),
    ((7,), (3,)), ((5, 3), (2, 1)), ((64,), (1, 2, 3)), ((256, 128), (4, 5, 6)),
])
def test_flat_gather_shapes(dev, tshape, ishape):
    """The tools' table, 1-D to 3-D indices, fewer than 4 of them."""
    rng = np.random.default_rng(sum(ishape) + len(tshape))
    T = int(np.prod(tshape))
    idx = rng.integers(-2 * T, 2 * T, ishape, dtype=np.int32)
    idx.reshape(-1)[:8] = [-1, T - 1, T, 5 * T, -T, -T - 1, I32.min, I32.max][: idx.size]
    table = _on(dev, rng.integers(I32.min, I32.max, tshape, dtype=np.int32))
    idx = _on(dev, idx)
    _same("flat_gather", lambda: gp.flat_gather(table, idx),
          lambda: gp.flat_gather_plain(table, idx))


@pytest.mark.parametrize("where", ["table", "idx", "out"])
@pytest.mark.parametrize("T,n", [(32768, 8 * 2304 * 128), (4097, 4353), (100, 3)])
def test_flat_gather_off_a_boundary(dev, T, n, where):
    """table, idx or out one word past a 16-byte boundary."""
    rng = np.random.default_rng(T + n + len(where))
    table = _on(dev, rng.integers(I32.min, I32.max, (T,), dtype=np.int32), where == "table")
    idx = _on(dev, rng.integers(-T - 5, T + 5, (n,), dtype=np.int32), where == "idx")
    out = _out(idx, where == "out")
    _same("flat_gather", lambda: _flat_into(table, idx, out),
          lambda: gp.flat_gather_plain(table, idx))


@pytest.mark.parametrize("step", [-1, 0, 1])
@pytest.mark.parametrize("n", [8 * 2304 * 128, 4353, 2])
def test_flat_gather_at_the_staged_size(dev, staged, step, n):
    """Tables at the staged limit and one word either side: the whole
    table reached, its last word too."""
    T = staged + step
    rng = np.random.default_rng(T + n)
    table = _on(dev, rng.integers(I32.min, I32.max, (T,), dtype=np.int32))
    idx = rng.integers(-T, T, (n,), dtype=np.int32)
    idx[:2] = [T - 1, T]
    idx = _on(dev, idx)
    _same("flat_gather", lambda: gp.flat_gather(table, idx),
          lambda: gp.flat_gather_plain(table, idx))


def test_gathers_on_a_second_card():
    """Tensors on a card other than the current one: the launch enters
    that card's guard and uses its stream."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    assert torch.cuda.current_device() == 0
    dev = torch.device("cuda", 1)
    rng = np.random.default_rng(11)
    x = _on(dev, rng.integers(I32.min, I32.max, (64, 4352), dtype=np.int32))
    idx = _on(dev, _indices(rng, 4352, (64, 4352)))
    got = _same("take_along", lambda: gp.take_along(x, idx, 1),
                lambda: gp.take_along_plain(x, idx, 1))
    assert got.device == dev
    table = _on(dev, rng.integers(I32.min, I32.max, (256, 128), dtype=np.int32))
    _same("flat_gather", lambda: gp.flat_gather(table, idx),
          lambda: gp.flat_gather_plain(table, idx))
    assert gp.staged_words(1) == gp.staged_words(0)
