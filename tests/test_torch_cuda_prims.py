"""The gather and primitive probe kernels against their plain versions, on
the card.

Every test here is marked `cuda` and skips without a CUDA card.  The CPU
tests (test_torch_prim_probes.py) hold the plain versions to the tools'
Pallas kernels; these hold each kernel of csrc/gather_probe.cu and
csrc/inflate_prims.cu to its plain version on the same card tensors, at
ragged sizes (1, 127, 129 and 8,192 lanes; 1 and 4,353 rows), on views
that start off a 16-byte boundary, and at the edges of the index and
shift rules.  Every comparison is exact.  On a machine with a card (and
no JAX, which tests/conftest.py imports), from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_prims.py
"""

import numpy as np
import pytest
import torch

from tpuzlib_torch.codec.tables import FIXED_LITLEN_LENGTHS
from tpuzlib_torch.kernels import _build, gather_probe as gp, inflate_cuda, inflate_prims as ip

pytestmark = pytest.mark.cuda

I32 = np.iinfo(np.int32)
LANES = [1, 127, 129, 8192]


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


def _ints(rng, shape, lo=I32.min, hi=I32.max):
    return rng.integers(lo, hi, shape, dtype=np.int32)


# ---- gather_probe.cu -----------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("axis,xshape,ishape", [
    (1, (64, 4352), (64, 4352)), (1, (1, 1), (1, 1)), (1, (3, 129), (3, 127)),
    (1, (7, 5), (7, 300)), (0, (4353, 127), (4353, 127)), (0, (1, 129), (9, 129)),
    (0, (288, 8192), (1, 8192)), (0, (8 * 2304, 128), (8 * 2304, 128)),
])
def test_take_along(dev, axis, xshape, ishape, offset):
    rng = np.random.default_rng(sum(xshape) + sum(ishape) + axis)
    n = xshape[axis]
    x = _on(dev, _ints(rng, xshape), offset)
    idx = rng.integers(-n, n, ishape, dtype=np.int32)
    flat = idx.reshape(-1)
    edges = np.array([0, n - 1, -1, -n, -n - 1, n, n + 72, I32.min, I32.max], np.int32)
    flat[: min(flat.size, edges.size)] = edges[: flat.size]
    idx = _on(dev, idx, offset)
    for fill in (gp.INT32_MIN, -1):
        _same("take_along", lambda: gp.take_along(x, idx, axis, fill),
              lambda: gp.take_along_plain(x, idx, axis, fill))


@pytest.mark.parametrize("axis,shape,iters", [
    (0, (4352, 128), 64), (1, (1024, 128), 64), (0, (1, 129), 64), (1, (4353, 1), 5),
    (0, (127, 3), 0), (1, (9, 8192), 3),
])
def test_take_along_loop(dev, axis, shape, iters):
    rng = np.random.default_rng(shape[0] * 7 + shape[1] + axis)
    idx = rng.integers(-shape[axis], 2 * shape[axis], shape, dtype=np.int32)
    idx.reshape(-1)[:4] = [I32.max, I32.max - 30, I32.min, -1][: idx.size]
    x, idx = _on(dev, _ints(rng, shape)), _on(dev, idx, 1)
    _same("take_along_loop", lambda: gp.take_along_loop(x, idx, axis, iters),
          lambda: gp.take_along_loop_plain(x, idx, axis, iters))


@pytest.mark.parametrize("tshape,ishape", [((256, 128), (8 * 2304, 128)), ((1,), (1, 1)),
                                           ((8, 128), (129, 127)), ((4353,), (3, 4353))])
def test_flat_gather(dev, tshape, ishape):
    rng = np.random.default_rng(len(ishape) + ishape[0])
    T = int(np.prod(tshape))
    idx = rng.integers(-2 * T, 2 * T, ishape, dtype=np.int32)
    idx.reshape(-1)[:8] = [-1, T - 1, T, 5 * T, -T, -T - 1, I32.min, I32.max][: idx.size]
    table, idx = _on(dev, _ints(rng, tshape), 1), _on(dev, idx)
    _same("flat_gather", lambda: gp.flat_gather(table, idx),
          lambda: gp.flat_gather_plain(table, idx))


@pytest.mark.parametrize("shape,rows", [((8, 2304, 128), 2304), ((256, 128), 256),
                                        ((1, 1), 1), ((4353, 129), 7), ((3, 5, 127), 4353)])
def test_scatter_max(dev, shape, rows):
    """Seeded non-negative values, so that a wrong address shows, then the
    tool's zeros; duplicates, wrapped and dropped indices."""
    rng = np.random.default_rng(rows + len(shape))
    idx = rng.integers(-rows, rows, shape, dtype=np.int32)
    idx[..., 0] = 0  # a column of duplicates
    flat = idx.reshape(-1)
    flat[1 : 5] = [rows, -rows - 1, I32.min, I32.max][: max(0, flat.size - 1)]
    vals = rng.integers(0, I32.max, shape, dtype=np.int32)
    vals.reshape(-1)[-1:] = -5  # a negative value loses to the zeros
    idx, vals = _on(dev, idx, 1), _on(dev, vals)
    zeros = torch.zeros_like(vals)
    for v in (vals, zeros):
        got = _same("scatter_max", lambda: gp.scatter_max(idx, v, rows),
                    lambda: gp.scatter_max_plain(idx, v, rows))
    assert not got.any()


@pytest.mark.parametrize("shape,steps", [((8, 2304, 128), 16), ((2304, 128), 16), ((1, 1), 16),
                                         ((3, 1, 129), 16), ((4353, 127), 1), ((2, 7, 3), 40),
                                         ((5, 8192), 0), ((1, 300), gp.MAX_STEPS)])
def test_shift_screen(dev, shape, steps):
    """Words whose xors set bit 31, chunks shorter than the shifts."""
    rng = np.random.default_rng(sum(shape) + steps)
    x = _on(dev, _ints(rng, shape), 1)
    _same("shift_screen", lambda: gp.shift_screen(x, steps), lambda: gp.shift_screen_plain(x, steps))


# ---- inflate_prims.cu ------------------------------------------------------------

@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("case", ["tool", "no step", "the cap", "one lane", "int32 ends"])
def test_vec_cond_while(dev, lanes, case):
    rng = np.random.default_rng(lanes)
    x = {"tool": rng.integers(0, 100, (1, lanes), dtype=np.int32),
         "no step": rng.integers(100, 1000, (1, lanes), dtype=np.int32),
         "the cap": rng.integers(-500, 300, (1, lanes), dtype=np.int32),
         "one lane": np.full((1, lanes), 500, np.int32),
         "int32 ends": np.full((1, lanes), I32.max, np.int32)}[case]
    if case == "one lane":
        x[0, lanes - 1] = 60
    if case == "int32 ends":
        x[0, 0] = I32.min
    steps = min(64, max(0, 100 - int(x.min())))  # the loop's steps, all lanes together
    x = _on(dev, x, 1)
    got = _same("vec_cond_while", lambda: ip.vec_cond_while(x), lambda: ip.vec_cond_while_plain(x))
    assert int((got.long() - x.long()).max()) == steps


def _words_j(rng, nw, lanes):
    words = _ints(rng, (nw, lanes))
    j = rng.integers(-3, nw + 3, (1, lanes), dtype=np.int32)
    edges = [0, nw - 4, nw - 3, nw - 2, nw - 1, nw, -1, -2, -3, I32.min, I32.max]
    j[0, : min(lanes, len(edges))] = edges[:lanes]
    return words, j


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("nw,k", [(40, 3), (1, 3), (4353, 2), (9, 8)])
def test_fetch_rows(dev, lanes, nw, k):
    words, j = _words_j(np.random.default_rng(nw + lanes), nw, lanes)
    words, j = _on(dev, words, 1), _on(dev, j)
    _same("fetch_rows", lambda: ip.fetch_rows(words, j, k), lambda: ip.fetch_rows_plain(words, j, k))


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("nw,steps", [(40, 16), (2, 5), (4353, 16), (9, 1)])
def test_gather_store_loop(dev, lanes, nw, steps):
    words, j = _words_j(np.random.default_rng(3 * nw + lanes), nw, lanes)
    words, j = _on(dev, words), _on(dev, j, 1)
    _same("gather_store_loop", lambda: ip.gather_store_loop(words, j, steps),
          lambda: ip.gather_store_loop_plain(words, j, steps))


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("rows", [24, 1, 4353])
def test_row_store_loop(dev, lanes, rows):
    _same("row_store_loop", lambda: ip.row_store_loop(rows, lanes, dev),
          lambda: ip.row_store_loop_plain(rows, lanes, "cpu").to(dev))


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("rows", [16, 1, 4353])
def test_col_min_sum(dev, lanes, rows):
    x = _on(dev, _ints(np.random.default_rng(rows + lanes), (rows, lanes)), 1)  # sums that wrap
    _same("col_min_sum", lambda: ip.col_min_sum(x), lambda: ip.col_min_sum_plain(x))


@pytest.mark.parametrize("lanes", LANES)
def test_var_shifts(dev, lanes):
    rng = np.random.default_rng(lanes)
    r = _ints(rng, (1, lanes))
    e = rng.integers(-40, 40, (1, lanes), dtype=np.int32)
    e[0, : min(lanes, 6)] = [0, 31, 32, 40, -1, I32.min][:lanes]
    r, e = _on(dev, r, 1), _on(dev, e)
    _same("var_shifts", lambda: ip.var_shifts(r, e), lambda: ip.var_shifts_plain(r, e))


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("table", ["fixed", "one code: no match", "random tables"])
def test_tree_decode(dev, lanes, table):
    rng = np.random.default_rng(lanes + len(table))
    w = rng.integers(0, 1 << 32, (1, lanes), dtype=np.uint64).astype(np.uint32)
    if table == "random tables":
        cnt, first, off = (_ints(rng, (16, lanes)) for _ in range(3))
        first[:, ::2] = rng.integers(-4, 70000, (16, (lanes + 1) // 2))
        cnt[:, ::2] = rng.integers(-2, 40000, (16, (lanes + 1) // 2))
    else:
        lengths = FIXED_LITLEN_LENGTHS if table == "fixed" else np.array([1] + [0] * 287)
        _, *cols = inflate_cuda.canon_tables(lengths, "litlen")
        cnt, first, off = (np.tile(c[:, None], (1, lanes)) for c in cols)
    w, cnt, first, off = (_on(dev, a, o) for a, o in ((w, 1), (cnt, 0), (first, 1), (off, 0)))
    got = _same("tree_decode", lambda: ip.tree_decode(w, cnt, first, off),
                lambda: ip.tree_decode_plain(w, cnt, first, off))
    if table == "one code: no match" and lanes > 64:
        assert (got[0] == 99).any()


@pytest.mark.parametrize("lanes", LANES)
def test_table_lookup(dev, lanes):
    rng = np.random.default_rng(lanes)
    ents = inflate_cuda.canon_tables(FIXED_LITLEN_LENGTHS, "litlen")[0]
    etab = _on(dev, np.tile(ents[:, None], (1, lanes)), 1)
    rank = rng.integers(-5, 300, (1, lanes), dtype=np.int32)
    rank[0, : min(lanes, 4)] = [287, 288, I32.min, I32.max][:lanes]
    rank = _on(dev, rank)
    _same("take_along", lambda: ip.table_lookup(etab, rank), lambda: ip.table_lookup_plain(etab, rank))


@pytest.mark.parametrize("lanes", LANES)
def test_window64(dev, lanes):
    rng = np.random.default_rng(lanes + 5)
    wa, wb, wc = (_ints(rng, (1, lanes)) for _ in range(3))
    sh = rng.integers(-2, 34, (1, lanes), dtype=np.int32)
    o = rng.integers(-3, 40, (1, lanes), dtype=np.int32)
    sh[0, : min(lanes, 6)] = [0, 0, 31, 32, 40, -1][:lanes]
    o[0, : min(lanes, 6)] = [0, 31, 0, 45, 3, -7][:lanes]
    args = [_on(dev, a, i % 2) for i, a in enumerate((wa, wb, wc, sh, o))]
    _same("window64", lambda: ip.window64(*args), lambda: ip.window64_plain(*args))
