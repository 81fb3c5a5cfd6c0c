"""gather_store_loop and col_min_sum, redesigned for the card, against their
plain versions on the card.

Every test here is marked `cuda` and skips without a CUDA card.  The CPU
tests (test_torch_kernel_orders.py, test_torch_prim_probes.py) hold the
plain versions to the tools' Pallas kernels and replay gather_store_loop's
stepped rows (inflate_prims.store_loop_steps); these hold the kernels to
their plain versions on the same card tensors, exactly, and assert each
launch:

  lanes 1, 3, 4, 5, 127, 128, 129, 8,192 and 8,193 (one block, the grid
  spread over the SMs, ragged blocks), words, j and x 0 to 3 words past a
  16-byte boundary; nw 2, 3, 4, 5, 40 and 4,353 with steps 1, 15, 16, 17
  and 33 (chunks of 16 and their tails) and j at int32's ends, at -3..-1
  and at nw - 4 .. nw + 3; rows 1, 15, 16, 17 and 4,353 with columns of
  INT32_MAX (the min, a sum that wraps) and INT32_MIN; both kernels on a
  side stream behind torch.cuda._sleep, their inputs written after the
  sleep.

On a machine with a card (and no JAX, which tests/conftest.py imports),
from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_store_min.py
"""

import numpy as np
import pytest
import torch

from tpuzlib_torch.kernels import _build, inflate_prims as ip

pytestmark = pytest.mark.cuda

I32 = np.iinfo(np.int32)
LANES = [1, 3, 4, 5, 127, 128, 129, 8192, 8193]


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
    t.copy_(torch.from_numpy(np.ascontiguousarray(a).view(np.int32)))
    return t


def _words_j(nw, lanes, seed, edges=()):
    rng = np.random.default_rng(seed)
    words = rng.integers(I32.min, I32.max, (nw, lanes), dtype=np.int32)
    j = rng.integers(-3 * nw, 3 * nw, (1, lanes), dtype=np.int32)
    edges = list(edges)[:lanes]
    j[0, : len(edges)] = edges
    return words, j


def _stored(words, j, steps):
    before = _build.LAUNCHES["gather_store_loop"]
    got = ip.gather_store_loop(words, j, steps)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gather_store_loop"] == before + 1
    assert got.shape == (steps, words.shape[1]) and got.dtype == torch.int32
    assert torch.equal(got, ip.gather_store_loop_plain(words, j, steps)), (
        tuple(words.shape), steps)


def _summed(x):
    before = _build.LAUNCHES["col_min_sum"]
    got = ip.col_min_sum(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["col_min_sum"] == before + 1
    assert got.shape == (2, x.shape[1]) and got.dtype == torch.int32
    assert torch.equal(got, ip.col_min_sum_plain(x)), tuple(x.shape)


@pytest.mark.parametrize("offset", range(4))
@pytest.mark.parametrize("lanes", LANES)
def test_gather_store_loop_lanes(dev, lanes, offset):
    words, j = _words_j(40, lanes, lanes + offset, [-1, 0, 39, 40, I32.min, I32.max])
    _stored(_on(dev, words, offset), _on(dev, j, 3 - offset), 16)


@pytest.mark.parametrize("steps", [1, 15, 16, 17, 33])
@pytest.mark.parametrize("nw", [2, 3, 4, 5, 40, 4353])
def test_gather_store_loop_rows_and_steps(dev, nw, steps):
    edges = [I32.min, I32.max, -3, -2, -1, *range(nw - 4, nw + 4)]
    words, j = _words_j(nw, 129, nw * 7 + steps, edges)
    _stored(_on(dev, words, 0), _on(dev, j, 1), steps)


@pytest.mark.parametrize("offset", range(4))
@pytest.mark.parametrize("lanes", LANES)
def test_col_min_sum_lanes(dev, lanes, offset):
    rng = np.random.default_rng(lanes * 4 + offset)
    x = rng.integers(I32.min, I32.max, (16, lanes), dtype=np.int32)
    x[:, 0] = I32.max
    if lanes > 1:
        x[:, 1] = I32.min
    _summed(_on(dev, x, offset))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("lanes", [4, 5, 128, 8192])
@pytest.mark.parametrize("rows", [1, 15, 16, 17, 4353])
def test_col_min_sum_rows(dev, rows, lanes, offset):
    rng = np.random.default_rng(rows + lanes + offset)
    x = rng.integers(I32.min, I32.max, (rows, lanes), dtype=np.int32)
    x[:, 0], x[:, 1], x[:, 2] = I32.max, I32.min, I32.max
    x[-1, 2] = 1  # INT32_MAX but in the last row: the min from the tail
    _summed(_on(dev, x, offset))


def test_both_on_a_side_stream_behind_a_sleep(dev):
    """A call under torch.cuda.stream(s), s queued behind a sleep and the
    inputs written on s after it: a launch on any other stream would run
    before them and read the zeros."""
    words_h, j_h = (torch.from_numpy(a) for a in _words_j(40, 8192, 3))
    x_h = torch.from_numpy(np.random.default_rng(4).integers(I32.min, I32.max, (16, 8192),
                                                             dtype=np.int32))
    srcs = [t.to(dev) for t in (words_h, j_h, x_h)]
    words, j, x = (torch.zeros_like(t) for t in srcs)
    torch.cuda.synchronize()
    s = torch.cuda.Stream(dev)
    with torch.cuda.stream(s):
        torch.cuda._sleep(100_000_000)  # ~50 ms
        for t, src in zip((words, j, x), srcs):
            t.copy_(src)
        stored, summed = ip.gather_store_loop(words, j, 16), ip.col_min_sum(x)
    s.synchronize()
    assert torch.equal(stored.cpu(), ip.gather_store_loop_plain(words_h, j_h, 16))
    assert torch.equal(summed.cpu(), ip.col_min_sum_plain(x_h))
