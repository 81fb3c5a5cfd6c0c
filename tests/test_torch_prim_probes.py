"""The gather and primitive probe kernels of tpuzlib_torch against the
tools' Pallas kernels.

The port's plain versions (what the wrappers run on CPU tensors) are held
to the Pallas kernels of tools/probe_gather.py, probe_primitives.py,
probe_inflate_prims.py and probe_inflate_prims2.py, run in interpret mode
on the same seeded numpy arrays, with exact equality, at the edges of
their index and shift rules too.  The tools' kernels are nested in their
main() or run at import, so their bodies are copied here with their line
ranges (probe_primitives' k_scatter with its shape taken from its input,
and with the values it loads as a second variant).  Each new probe of
tpuzlib_torch/tools runs on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpuzlib.codec.tables import FIXED_LITLEN_LENGTHS as J_FIXED
from tpuzlib.kernels.inflate_pallas import canon_tables as j_canon_tables
from tpuzlib_torch.codec.tables import FIXED_LITLEN_LENGTHS
from tpuzlib_torch.kernels import gather_probe as gp, inflate_cuda, inflate_prims as ip
from tpuzlib_torch.tools import (probe_gather, probe_inflate_prims, probe_inflate_prims2,
                                 probe_primitives)

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

I32 = np.iinfo(np.int32)


def _call(kern, out_shape, dtype, *args):
    """A Pallas body in interpret mode, as the tools' `check` ran its oracle."""
    return np.asarray(pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(out_shape, dtype),
                                     interpret=True)(*(jnp.asarray(a) for a in args)))


def _t(a):
    """A numpy array as the port takes it: int32, uint32 as its bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _equal(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want.view(np.int32) if want.dtype == np.uint32 else want)


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


# ---- tools/probe_gather.py -------------------------------------------------

# tools/probe_gather.py:54-55 (axis 1) and :75-76 (axis 0)
def _gather_kernel(axis):
    def kern(x_ref, i_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:], axis=axis)

    return kern


# tools/probe_gather.py:96-103, loop_cost's kern (x.shape[axis] as n)
def _loop_kernel(axis, n, iters):
    def kern(x_ref, i_ref, o_ref):
        def body(t, acc):
            g = jnp.take_along_axis(
                x_ref[:], (i_ref[:] + t) % n, axis=axis
            )
            return acc + g

        o_ref[:] = jax.lax.fori_loop(0, iters, body, jnp.zeros_like(x_ref))

    return kern


def _edge_indices(n):
    """Every index rule: in range, [-n, 0), below -n, n and above, int32's ends."""
    return np.array([0, n - 1, -1, -n, -n - 1, n, n + 72, I32.min, I32.max], np.int32)


@pytest.mark.parametrize("axis,shape", [(1, (8, 128)), (1, (4, 256)), (0, (8, 128)),
                                        (0, (32, 128))])
def test_take_along_matches_the_tools_gathers(axis, shape):
    rng = np.random.default_rng(sum(shape) + axis)
    n = shape[axis]
    x = rng.integers(I32.min, I32.max, shape, dtype=np.int32)
    idx = rng.integers(0, n, shape, dtype=np.int32)
    want = _call(_gather_kernel(axis), shape, jnp.int32, x, idx)
    _equal(gp.take_along(_t(x), _t(idx), axis), want)
    # the index rules, at the edges
    e = _edge_indices(n)
    if axis == 1:
        idx[0, : e.size] = e
    else:
        idx[np.arange(e.size) % shape[0], np.arange(e.size)] = e
    want = _call(_gather_kernel(axis), shape, jnp.int32, x, idx)
    assert (want == I32.min).any() and (want[idx < 0] != I32.min).any()
    _equal(gp.take_along(_t(x), _t(idx), axis), want)


def test_take_along_keeps_the_index_shape():
    """jnp's take_along_axis gives the index's shape: fewer or more rows
    (axis 0) or columns (axis 1) than x."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 20, (8, 128), dtype=np.int32)
    for axis, ishape in ((0, (3, 128)), (0, (20, 128)), (1, (8, 5)), (1, (8, 300))):
        idx = rng.integers(-x.shape[axis], x.shape[axis], ishape, dtype=np.int32)
        want = np.take_along_axis(x, np.where(idx < 0, idx + x.shape[axis], idx), axis)
        _equal(gp.take_along(_t(x), _t(idx), axis), want)


@pytest.mark.parametrize("axis,shape,iters", [(1, (16, 128), 64), (0, (16, 128), 64),
                                              (0, (40, 128), 7)])
def test_take_along_loop_matches_loop_cost(axis, shape, iters):
    rng = np.random.default_rng(7 + axis)
    x = rng.integers(I32.min, I32.max, shape, dtype=np.int32)  # sums that wrap
    idx = rng.integers(0, shape[axis], shape, dtype=np.int32)
    idx[0, :6] = [-1, -shape[axis] - 5, I32.max, I32.max - 30, I32.min, shape[axis] + 3]
    want = _call(_loop_kernel(axis, shape[axis], iters), shape, jnp.int32, x, idx)
    _equal(gp.take_along_loop(_t(x), _t(idx), axis, iters), want)


# The widest axis-1 row, or flat table, that the card's kernels stage in
# shared memory on an H100 (gather_probe.staged_words(): 232,448 bytes a
# block may opt in to, over 4); the plain versions are held at it and one
# word either side, as the card tests hold the kernels.
H100_STAGED_WORDS = 232448 // 4


@pytest.mark.parametrize("width", [1, 3, 5, 127, 129])
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_ragged_widths_match_the_tools_gathers(axis, width):
    """Index rows whose width is not a multiple of 4 (the card's kernel
    takes them an element at a time), with every index rule."""
    rng = np.random.default_rng(width * 2 + axis)
    shape = (9, width)
    n = shape[axis]
    x = rng.integers(I32.min, I32.max, shape, dtype=np.int32)
    idx = rng.integers(-n, n, shape, dtype=np.int32)
    e = _edge_indices(n)
    idx.reshape(-1)[: min(idx.size, e.size)] = e[: idx.size]
    want = _call(_gather_kernel(axis), shape, jnp.int32, x, idx)
    _equal(gp.take_along(_t(x), _t(idx), axis), want)


@pytest.mark.parametrize("step", [-1, 0, 1])
def test_take_along_at_the_staged_width_matches_the_lane_gather(step):
    """Rows of x at the H100's staged width and one word either side."""
    xc = H100_STAGED_WORDS + step
    rng = np.random.default_rng(xc)
    x = rng.integers(I32.min, I32.max, (2, xc), dtype=np.int32)
    idx = rng.integers(-xc, xc, (2, 13), dtype=np.int32)
    idx[0, :9] = _edge_indices(xc)
    idx[1, 0] = xc - 1
    want = _call(_gather_kernel(1), idx.shape, jnp.int32, x, idx)
    _equal(gp.take_along(_t(x), _t(idx), 1), want)


# ---- tools/probe_primitives.py ---------------------------------------------

# tools/probe_primitives.py:176-178
def k_flatgather(t_ref, i_ref, o_ref):
    flat = t_ref[:].reshape(-1)
    o_ref[:] = flat[i_ref[:]]


def test_flat_gather_matches_k_flatgather():
    rng = np.random.default_rng(11)
    table = rng.integers(I32.min, I32.max, (8, 128), dtype=np.int32)  # 1,024 entries
    idx = rng.integers(0, 1024, (16, 128), dtype=np.int32)
    idx[0, :10] = [-1, 1023, 1024, 5000, -1024, -1025, -5000, 0, I32.min, I32.max]
    want = _call(k_flatgather, idx.shape, jnp.int32, table, idx)
    assert list(want[0, :7]) == [table[7, 127], table[7, 127], table[7, 127], table[7, 127],
                                 table[0, 0], table[0, 0], table[0, 0]]
    _equal(gp.flat_gather(_t(table), _t(idx)), want)


@pytest.mark.parametrize("step", [-1, 0, 1])
@pytest.mark.parametrize("ishape", [(3,), (2, 1), (5, 7), (2, 3, 5)])
def test_flat_gather_at_the_staged_size_matches_k_flatgather(step, ishape):
    """Tables at the H100's staged size and one word either side, fewer
    than 4 indices, a width not a multiple of 4, 3-D indices."""
    T = H100_STAGED_WORDS + step
    rng = np.random.default_rng(T + len(ishape))
    table = rng.integers(I32.min, I32.max, (T,), dtype=np.int32)
    idx = rng.integers(-2 * T, 2 * T, ishape, dtype=np.int32)
    idx.reshape(-1)[:8] = [T - 1, T, -1, -T - 1, I32.min, I32.max, 0, -T][: idx.size]
    want = _call(k_flatgather, idx.shape, jnp.int32, table, idx)
    _equal(gp.flat_gather(_t(table), _t(idx)), want)


# tools/probe_primitives.py:196-201, the shape taken from the input and,
# where `loaded`, the loaded values scattered in place of zeros
def _scatter_kernel(loaded):
    def k_scatter(x_ref, i_ref, o_ref):
        shape = o_ref.shape
        o_ref[:] = jnp.zeros_like(o_ref)
        vals = x_ref[:]
        o_ref[:] = o_ref[:].at[i_ref[:], jnp.broadcast_to(
            jax.lax.broadcasted_iota(jnp.int32, shape, 1), shape)].max(
            vals if loaded else jnp.zeros(shape, jnp.int32))

    return k_scatter


@pytest.mark.parametrize("loaded", [False, True], ids=["the tool's zeros", "loaded values"])
@pytest.mark.parametrize("rows", [16, 256])
def test_scatter_max_matches_k_scatter(loaded, rows):
    rng = np.random.default_rng(rows)
    vals = rng.integers(0, I32.max, (rows, 128), dtype=np.int32)
    vals[1] = rng.integers(I32.min, 0, 128)  # negative values lose to the zeros
    idx = rng.integers(0, rows, (rows, 128), dtype=np.int32)
    idx[:, 5] = 3  # a column of duplicates
    idx[:4, 6:10] = [[-1, rows, -rows - 1, I32.min]] * 4  # wrapped, dropped
    want = _call(_scatter_kernel(loaded), (rows, 128), jnp.int32, vals, idx)
    z = np.zeros_like(vals)
    got = gp.scatter_max(_t(idx), _t(vals if loaded else z), rows)
    _equal(got, want)
    if loaded:
        assert want[3, 5] == vals[:, 5].max() and want[rows - 1, 6] >= vals[0, 6]


@pytest.mark.parametrize("cols", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("rows,w", [(16, 128), (37, 5), (40, 129), (256, 128)])
def test_slab_replay_matches_plain_and_k_scatter(rows, w, cols):
    """The card's smem route replayed on the host (a zeroed slab a block,
    its elements max-scattered, values of 0 or less skipped, written out)
    on 3 chunks, each held exactly to the plain version and to the tool's
    k_scatter in interpret mode, a slab's last columns fewer where cols
    does not divide w."""
    rng = np.random.default_rng(rows * 10 + w + cols)
    vals = rng.integers(0, I32.max, (3, rows, w), dtype=np.int32)
    vals[:, 1] = rng.integers(I32.min, 1, (3, w))  # values of 0 or less lose to the zeros
    idx = rng.integers(-rows, rows, (3, rows, w), dtype=np.int32)
    idx[:, :, 0] = 3 % rows  # a column of duplicates
    idx[:, :4, 1:5] = [[-1, rows, -rows - 1, I32.min][: min(4, w - 1)]] * 4  # wrapped, dropped
    got = gp.slab_scatter_plain(_t(idx), _t(vals), rows, cols)
    assert torch.equal(got, gp.scatter_max_plain(_t(idx), _t(vals), rows))
    for k in range(3):
        want = _call(_scatter_kernel(True), (rows, w), jnp.int32, vals[k], idx[k])
        _equal(got[k], want)
    two_d = gp.slab_scatter_plain(_t(idx[0]), _t(vals[0]), rows, cols)
    assert torch.equal(two_d, got[0])


def test_scatter_max_takes_chunks():
    rng = np.random.default_rng(5)
    idx = rng.integers(-3, 12, (3, 8, 16), dtype=np.int32)
    vals = rng.integers(0, 1000, (3, 8, 16), dtype=np.int32)
    got = gp.scatter_max(_t(idx), _t(vals), 10)
    assert got.shape == (3, 10, 16)
    for b in range(3):
        assert torch.equal(got[b], gp.scatter_max(_t(idx[b]), _t(vals[b]), 10))


# tools/probe_primitives.py:208-218
def k_roll(x_ref, o_ref):
    x = x_ref[:]
    acc = jnp.zeros_like(x)
    lane = jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
    cur = x
    for _ in range(16):
        a = pltpu.roll(cur, 1, axis=1)
        b = pltpu.roll(a, 1, axis=0)
        cur = jnp.where(lane == 0, b, a)
        acc = jnp.maximum(acc, cur ^ x)
    o_ref[:] = acc


@pytest.mark.parametrize("rows", [1, 8, 24])
def test_shift_screen_matches_k_roll(rows):
    rng = np.random.default_rng(rows + 100)
    x = rng.integers(I32.min, I32.max, (rows, 128), dtype=np.int32)  # xors that set bit 31
    want = _call(k_roll, x.shape, jnp.int32, x)
    _equal(gp.shift_screen(_t(x), 16), want)
    # element 0 receives the last: a global shift of the row-major array
    one = np.zeros((rows, 128), np.int32)
    one[-1, -1] = 5
    got = gp.shift_screen(_t(one), 1).numpy()
    assert got[0, 0] == 5 and got[-1, -1] == 5 and np.count_nonzero(got) == 2
    _equal(gp.shift_screen(_t(one), 16), _call(k_roll, one.shape, jnp.int32, one))


@pytest.mark.parametrize("shape", [(1, 129), (3, 43), (1, 10), (2, 5)])
def test_shift_screen_matches_k_roll_on_other_chunks(shape):
    """k_roll's global shift on chunks of 129 and 10 words, and the card's
    register route (gp.card_shift_plain) at each offset of a 16-byte
    boundary."""
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(I32.min, I32.max, shape, dtype=np.int32)
    want = _call(k_roll, x.shape, jnp.int32, x)
    _equal(gp.shift_screen(_t(x), 16), want)
    for offset in range(4):
        _equal(gp.card_shift_plain(_t(x), 16, offset), want)


def test_shift_screen_takes_chunks_and_short_arrays():
    rng = np.random.default_rng(9)
    x = rng.integers(I32.min, I32.max, (3, 2, 5), dtype=np.int32)
    got = gp.shift_screen(_t(x), 16)  # 10 words a chunk: the shifts wrap more than once
    for b in range(3):
        flat = x[b].reshape(-1)
        want = np.zeros_like(flat)
        for s in range(1, 17):
            want = np.maximum(want, np.roll(flat, s) ^ flat)
        assert np.array_equal(got[b].reshape(-1).numpy(), want)
    assert torch.equal(gp.shift_screen(_t(x), 0), torch.zeros(3, 2, 5, dtype=torch.int32))


# ---- tools/probe_inflate_prims.py --------------------------------------------

# tools/probe_inflate_prims.py:50-52
def k_a(x_ref, i_ref, o_ref):
    sb = jnp.broadcast_to(i_ref[:], (8, 128))
    o_ref[:] = jnp.take_along_axis(x_ref[:], sb, axis=0)[0:1]


def test_u32_sublane_gather_matches_k_a():
    rng = np.random.default_rng(0)
    x = _u32(rng, (8, 128))
    idx = rng.integers(0, 8, (1, 128), dtype=np.int32)
    idx[0, :8] = [-1, -8, -9, 8, 200, -200, I32.min, I32.max]
    want = _call(k_a, (1, 128), jnp.uint32, x, idx)
    assert (want[0, 2:8] == 0xFFFFFFFF).all()  # jnp's uint32 fill
    _equal(gp.take_along(_t(x), _t(idx), 0, fill=-1), want)


# tools/probe_inflate_prims.py:58-66
def k_b(o_ref):
    def cond(it):
        return it < 24

    def body(it):
        o_ref[pl.ds(it, 1), :] = jnp.full((1, 128), it, jnp.int32)
        return it + 1

    jax.lax.while_loop(cond, body, jnp.int32(0))


def test_row_store_loop_matches_k_b():
    want = _call(k_b, (24, 128), jnp.int32)
    _equal(ip.row_store_loop(24, 128, "cpu"), want)
    assert torch.equal(ip.row_store_loop(3, 1, "cpu"), torch.tensor([[0], [1], [2]],
                                                                    dtype=torch.int32))


# tools/probe_inflate_prims.py:81-93
def k_c(x_ref, o_ref):
    def cond(st):
        v, it = st
        return jnp.logical_and(jnp.any(v < 100), it < 64)

    def body(st):
        v, it = st
        return v + (v < 100), it + 1

    v, it = jax.lax.while_loop(
        cond, body, (x_ref[:], jnp.int32(0))
    )
    o_ref[:] = v + it * 0


@pytest.mark.parametrize("case", ["tool", "no step", "the cap", "one lane", "int32 ends"])
def test_vec_cond_while_matches_k_c(case):
    rng = np.random.default_rng(2)
    x = {
        "tool": rng.integers(0, 100, (1, 128), dtype=np.int32),
        "no step": rng.integers(100, 1000, (1, 128), dtype=np.int32),
        "the cap": rng.integers(-500, 300, (1, 128), dtype=np.int32),
        "one lane": np.full((1, 128), 500, np.int32),
        "int32 ends": np.full((1, 128), I32.max, np.int32),
    }[case]
    if case == "one lane":
        x[0, 77] = 60  # 40 steps for every lane, from one lane's condition
    if case == "int32 ends":
        x[0, :2] = [I32.min, 99]
    want = _call(k_c, (1, 128), jnp.int32, x)
    _equal(ip.vec_cond_while(_t(x)), want)
    steps = {"tool": None, "no step": 0, "the cap": 64, "one lane": 40, "int32 ends": 64}[case]
    if steps is not None:
        assert (want - x).max() == steps


NW = 40


# tools/probe_inflate_prims.py:105-125
def k_d(w_ref, j_ref, o_ref):
    j = j_ref[:]
    v = j >> 3
    s = j & 7
    w_a = jnp.zeros((1, 128), jnp.uint32)
    w_b = jnp.zeros((1, 128), jnp.uint32)
    w_c = jnp.zeros((1, 128), jnp.uint32)
    sb = jnp.broadcast_to(s, (8, 128))
    s1 = jnp.broadcast_to((s + 1) & 7, (8, 128))
    s2 = jnp.broadcast_to((s + 2) & 7, (8, 128))
    for t in range(NW // 8):
        tile = w_ref[t * 8 : (t + 1) * 8, :]
        g0 = jnp.take_along_axis(tile, sb, axis=0)[0:1]
        g1 = jnp.take_along_axis(tile, s1, axis=0)[0:1]
        g2 = jnp.take_along_axis(tile, s2, axis=0)[0:1]
        w_a = jnp.where(v == t, g0, w_a)
        w_b = jnp.where((v == t) & (s < 7), g1, w_b)
        w_b = jnp.where((v == t - 1) & (s >= 7), g1, w_b)
        w_c = jnp.where((v == t) & (s < 6), g2, w_c)
        w_c = jnp.where((v == t - 1) & (s >= 6), g2, w_c)
    o_ref[:] = jnp.concatenate([w_a, w_b, w_c], axis=0)


def _words_and_j(seed):
    rng = np.random.default_rng(seed)
    words = _u32(rng, (NW, 128))
    j = rng.integers(0, NW - 3, (1, 128), dtype=np.int32)
    j[0, :12] = [0, 36, 37, 38, 39, 40, -1, -2, -3, 1000, I32.min, I32.max]
    return words, j


def test_fetch_rows_matches_k_d():
    words, j = _words_and_j(4)
    want = _call(k_d, (3, 128), jnp.uint32, words, j)
    assert list(want[:, 3]) == [words[38, 3], words[39, 3], 0]  # zero past row 39
    assert list(want[:, 6]) == [0, words[0, 6], words[1, 6]]
    _equal(ip.fetch_rows(_t(words), _t(j), 3), want)


def _fetch_reference(words, j, k):
    """words[j + i, lane] for i < k, 0 where j + i is outside [0, nw): numpy, int64 rows."""
    r = j.astype(np.int64) + np.arange(k)[:, None]
    inside = (r >= 0) & (r < words.shape[0])
    out = np.zeros((k, words.shape[1]), np.int32)
    at, lane = np.nonzero(inside)
    out[at, lane] = words[r[at, lane], lane]
    return out


@pytest.mark.parametrize("nw", [0, 1, 40, 4353])
@pytest.mark.parametrize("k", [1, 2, 3, 15, 16, 17, 33])
def test_fetch_rows_plain_at_its_edges(k, nw):
    """k around the card kernel's chunk of 16, no rows to 4,353, j at
    int32's ends and where the rows start below 0 or end past nw."""
    rng = np.random.default_rng(k * 11 + nw)
    words = rng.integers(I32.min, I32.max, (nw, 128), dtype=np.int32)
    j = rng.integers(-3 * nw - 3, 3 * nw + 3, (1, 128), dtype=np.int32)
    edges = [I32.min, I32.max, *range(-k, 0), *range(nw - k, nw + 1)]
    j[0, : len(edges)] = edges
    _equal(ip.fetch_rows_plain(_t(words), _t(j), k), _fetch_reference(words, j, k))


# tools/probe_inflate_prims.py:131-148
def k_e(w_ref, j_ref, o_ref):
    def cond(st):
        it, _ = st
        return it < 16

    def body(st):
        it, j = st
        v = j >> 3
        sb = jnp.broadcast_to(j & 7, (8, 128))
        g = jnp.zeros((1, 128), jnp.uint32)
        for t in range(NW // 8):
            tile = w_ref[t * 8 : (t + 1) * 8, :]
            gt = jnp.take_along_axis(tile, sb, axis=0)[0:1]
            g = jnp.where(v == t, gt, g)
        o_ref[pl.ds(it, 1), :] = g
        return it + 1, (j + 3) % (NW - 1)

    jax.lax.while_loop(cond, body, (jnp.int32(0), j_ref[:]))


def test_gather_store_loop_matches_k_e():
    words, j = _words_and_j(5)
    want = _call(k_e, (16, 128), jnp.uint32, words, j)
    _equal(ip.gather_store_loop(_t(words), _t(j), 16), want)


# ---- tools/probe_inflate_prims2.py -------------------------------------------

# tools/probe_inflate_prims2.py:46-49
def k_f(x_ref, o_ref):
    m = jnp.min(x_ref[:], axis=0, keepdims=True)
    s = jnp.sum(x_ref[:], axis=0, keepdims=True)
    o_ref[:] = jnp.concatenate([m, s], axis=0)


@pytest.mark.parametrize("wide", [False, True], ids=["tool", "sums that wrap"])
def test_col_min_sum_matches_k_f(wide):
    rng = np.random.default_rng(1)
    x = (rng.integers(I32.min, I32.max, (16, 128), dtype=np.int32) if wide
         else rng.integers(0, 1000, (16, 128), dtype=np.int32))
    want = _call(k_f, (2, 128), jnp.int32, x)
    _equal(ip.col_min_sum(_t(x)), want)


@pytest.mark.parametrize("lanes", [3, 128])
@pytest.mark.parametrize("rows", [1, 15, 16, 17, 33])
def test_col_min_sum_matches_k_f_at_chunk_edges(rows, lanes):
    """Rows around the card kernel's chunk of 16, with a column of
    INT32_MAX (its min and a sum that wraps) and one of INT32_MIN."""
    rng = np.random.default_rng(rows * 7 + lanes)
    x = rng.integers(I32.min, I32.max, (rows, lanes), dtype=np.int32)
    x[:, 0], x[:, 1] = I32.max, I32.min
    want = _call(k_f, (2, lanes), jnp.int32, x)
    _equal(ip.col_min_sum(_t(x)), want)


# tools/probe_inflate_prims2.py:58-64
def k_g(r_ref, e_ref, o_ref):
    Lrow = jax.lax.broadcasted_iota(jnp.int32, (16, 128), 0)
    code = jnp.broadcast_to(r_ref[:], (16, 128)) >> (16 - Lrow)
    ebv = e_ref[:].astype(jnp.uint32)
    mask = ((jnp.uint32(1) << ebv) - 1).astype(jnp.int32)
    o_ref[:] = jnp.concatenate([code, jnp.broadcast_to(mask, (1, 128))],
                               axis=0)


def test_var_shifts_matches_k_g():
    rng = np.random.default_rng(6)
    rv = rng.integers(0, 1 << 16, (1, 128), dtype=np.int32)
    eb = rng.integers(0, 14, (1, 128), dtype=np.int32)
    rv[0, :3] = [-1, I32.min, I32.max]  # arithmetic shifts of negative words
    eb[0, :6] = [0, 31, 32, 40, -1, I32.min]  # shifts of 32 and more give 0
    want = _call(k_g, (17, 128), jnp.int32, rv, eb)
    assert list(want[16, :6]) == [0, I32.max, -1, -1, -1, -1]
    _equal(ip.var_shifts(_t(rv), _t(eb)), want)


# tools/probe_inflate_prims2.py:82-103
def k_h(w_ref, c_ref, f_ref, o_ref, out_ref):
    def rev16(wv):
        r = wv & jnp.uint32(0xFFFF)
        r = ((r & jnp.uint32(0x5555)) << 1) | ((r >> 1) & jnp.uint32(0x5555))
        r = ((r & jnp.uint32(0x3333)) << 2) | ((r >> 2) & jnp.uint32(0x3333))
        r = ((r & jnp.uint32(0x0F0F)) << 4) | ((r >> 4) & jnp.uint32(0x0F0F))
        r = ((r & jnp.uint32(0x00FF)) << 8) | ((r >> 8) & jnp.uint32(0x00FF))
        return r

    Lrow = jax.lax.broadcasted_iota(jnp.int32, (16, 128), 0)
    rv = rev16(w_ref[:]).astype(jnp.int32)
    code = jnp.broadcast_to(rv, (16, 128)) >> (16 - Lrow)
    cnt = c_ref[:]
    first = f_ref[:]
    off = o_ref[:]
    match = (code >= first) & (code - first < cnt) & (Lrow >= 1)
    Lsel = jnp.min(jnp.where(match, Lrow, 99), axis=0, keepdims=True)
    Lc = jnp.clip(Lsel, 0, 15)
    pick = Lrow == Lc
    rank = jnp.sum(jnp.where(pick, off + code - first, 0),
                   axis=0, keepdims=True)
    out_ref[:] = jnp.concatenate([Lsel, rank], axis=0)


def _tiles(*cols):
    return [np.ascontiguousarray(np.tile(c[:, None], (1, 128))) for c in cols]


def test_canon_tables_match_tpuzlib():
    for lengths, kind in ((FIXED_LITLEN_LENGTHS, "litlen"), (np.array([1] + [0] * 287), "litlen"),
                          (np.array([2, 1, 3, 3] + [0] * 28), "dist")):
        got = inflate_cuda.canon_tables(lengths, kind)
        want = j_canon_tables(np.asarray(J_FIXED if lengths is FIXED_LITLEN_LENGTHS else lengths),
                              kind)
        assert all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want))


TREE_TABLES = ["fixed", "one code: no match", "random tables"]


def _tree_inputs(table):
    """w (1, 128) and the tables cnt, first, off (16, 128) of a TREE_TABLES kind."""
    rng = np.random.default_rng(8)
    w = _u32(rng, (1, 128))
    if table == "random tables":  # differences that wrap, every comparison's sign
        cnt, first, off = (rng.integers(I32.min, I32.max, (16, 128), dtype=np.int32)
                           for _ in range(3))
        first[:, :64] = rng.integers(-4, 70000, (16, 64))
        cnt[:, :64] = rng.integers(-2, 40000, (16, 64))
    else:
        lengths = FIXED_LITLEN_LENGTHS if table == "fixed" else np.array([1] + [0] * 287)
        _, cnt16, first16, off16 = inflate_cuda.canon_tables(lengths, "litlen")
        cnt, first, off = _tiles(cnt16, first16, off16)
    return w, cnt, first, off


@pytest.mark.parametrize("table", TREE_TABLES)
def test_tree_decode_matches_k_h(table):
    w, cnt, first, off = _tree_inputs(table)
    want = _call(k_h, (2, 128), jnp.int32, w, cnt, first, off)
    if table == "one code: no match":
        assert (want[0] == 99).any() and (want[0] == 1).any()
    _equal(ip.tree_decode(*map(_t, (w, cnt, first, off))), want)


@pytest.mark.parametrize("table", TREE_TABLES)
def test_tree_decode_ignores_row_0(table):
    """Row 0 of cnt, first and off, random int32 with int32's ends, changes
    neither k_h nor the plain version: the card kernel never loads it."""
    w, *tabs = _tree_inputs(table)
    want = _call(k_h, (2, 128), jnp.int32, w, *tabs)
    rng = np.random.default_rng(19)
    poisoned = [t.copy() for t in tabs]
    for n, t in enumerate(poisoned):
        t[0] = rng.integers(I32.min, I32.max, 128, dtype=np.int32)
        t[0, n : n + 2] = I32.min, I32.max
    assert not any(np.array_equal(p[0], t[0]) for p, t in zip(poisoned, tabs))
    assert np.array_equal(_call(k_h, (2, 128), jnp.int32, w, *poisoned), want)
    _equal(ip.tree_decode_plain(*map(_t, (w, *poisoned))), want)
    _equal(ip.tree_decode_plain(*map(_t, (w, *tabs))), want)


LE = 288


# tools/probe_inflate_prims2.py:115-124
def k_i(e_ref, r_ref, out_ref):
    r = jnp.clip(r_ref[:], 0, LE - 1)
    v = r >> 3
    sb = jnp.broadcast_to(r & 7, (8, 128))
    out = jnp.zeros((1, 128), jnp.uint32)
    for t in range(LE // 8):
        tile = e_ref[t * 8 : (t + 1) * 8, :]
        g = jnp.take_along_axis(tile, sb, axis=0)[0:1]
        out = jnp.where(v == t, g, out)
    out_ref[:] = out


def test_table_lookup_matches_k_i():
    rng = np.random.default_rng(10)
    ents = inflate_cuda.canon_tables(FIXED_LITLEN_LENGTHS, "litlen")[0]
    etab = _tiles(ents)[0]
    rank = rng.integers(0, 286, (1, 128), dtype=np.int32)
    rank[0, :6] = [-1, 0, 287, 288, I32.min, I32.max]
    want = _call(k_i, (1, 128), jnp.uint32, etab, rank)
    _equal(ip.table_lookup(_t(etab), _t(rank)), want)


# tools/probe_inflate_prims2.py:139-150
def k_j(a_ref, b_ref, c_ref, s_ref, o2_ref, out_ref):
    w_a, w_b, w_c = a_ref[:], b_ref[:], c_ref[:]
    shv = s_ref[:].astype(jnp.uint32)
    nsh = (jnp.uint32(32) - shv) & jnp.uint32(31)
    hi_b = jnp.where(shv == 0, jnp.uint32(0), w_b << nsh)
    hi_c = jnp.where(shv == 0, jnp.uint32(0), w_c << nsh)
    w64_lo = (w_a >> shv) | hi_b
    w64_hi = (w_b >> shv) | hi_c
    ov = jnp.clip(o2_ref[:], 0, 31).astype(jnp.uint32)
    no = (jnp.uint32(32) - ov) & jnp.uint32(31)
    w2 = jnp.where(ov == 0, w64_lo, (w64_lo >> ov) | (w64_hi << no))
    out_ref[:] = jnp.concatenate([w64_lo, w64_hi, w2], axis=0)


def test_window64_matches_k_j():
    rng = np.random.default_rng(12)
    wa, wb, wc = (_u32(rng, (1, 128)) for _ in range(3))
    sh = rng.integers(0, 32, (1, 128), dtype=np.int32)
    o = rng.integers(0, 21, (1, 128), dtype=np.int32)
    sh[0, :8] = [0, 0, 31, 1, 32, 40, -1, 0]  # 32 and more: the words shift out
    o[0, :8] = [0, 31, 0, 45, 3, 0, 5, -7]
    want = _call(k_j, (3, 128), jnp.uint32, wa, wb, wc, sh, o)
    assert want[0, 0] == wa[0, 0] and want[1, 0] == wb[0, 0] and want[2, 0] == wa[0, 0]
    _equal(ip.window64(*map(_t, (wa, wb, wc, sh, o))), want)


# ---- wrappers and probes ------------------------------------------------------

def test_prim_wrappers_check_their_inputs():
    x = torch.zeros(4, 8, dtype=torch.int32)
    row = torch.zeros(1, 8, dtype=torch.int32)
    for call, exc in (
        (lambda: gp.take_along(x, x.long(), 0), TypeError),
        (lambda: gp.take_along(x, x[:, :3].contiguous(), 0), ValueError),
        (lambda: gp.take_along(x, x, 2), ValueError),
        (lambda: gp.take_along(x[:, :0], x[:, :0], 1), ValueError),
        (lambda: gp.take_along(x, x[:, ::2], 1), ValueError),
        (lambda: gp.take_along_loop(x, x[:2].contiguous(), 0, 4), ValueError),
        (lambda: gp.take_along_loop(x, x, 0, -1), ValueError),
        (lambda: gp.flat_gather(x[:0], x), ValueError),
        (lambda: gp.scatter_max(x, x[:2].contiguous(), 4), ValueError),
        (lambda: gp.scatter_max(x, x, 0), ValueError),
        (lambda: gp.shift_screen(x, gp.MAX_STEPS + 1), ValueError),
        (lambda: gp.shift_screen(x.reshape(-1), 4), ValueError),
        (lambda: ip.vec_cond_while(x), ValueError),
        (lambda: ip.fetch_rows(x, row[:, :4].contiguous()), ValueError),
        (lambda: ip.fetch_rows(x, row, 0), ValueError),
        (lambda: ip.gather_store_loop(x[:1].contiguous(), row, 4), ValueError),
        (lambda: ip.row_store_loop(0, 8, "cpu"), ValueError),
        (lambda: ip.col_min_sum(x[:0]), ValueError),
        (lambda: ip.var_shifts(row, row[:, :4].contiguous()), ValueError),
        (lambda: ip.tree_decode(row, x, x, x), ValueError),
        (lambda: ip.window64(row, row, row, row, row.float()), TypeError),
    ):
        with pytest.raises(exc):
            call()


def _probe_lines(probe, capsys):
    probe.main(["--device", "cpu", "--reps", "1"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"nvidia_smi": None, "device": "cpu", "clock": "host"}
    return lines[1:]


def test_probe_gather_runs_on_the_cpu(capsys):
    lines = _probe_lines(probe_gather, capsys)
    names = ["lane-gather W=%d" % w for w in probe_gather.WIDTHS]
    names += ["sublane-gather R=%d" % r for r in probe_gather.ROWS]
    names += [n for n, *_ in probe_gather.LOOPS]
    names += ["XLA lut-gather while_loop", "XLA lut-gather + big-tape scatter while_loop"]
    assert [d["name"] for d in lines] == names
    assert all(d["verdict"] == "OK" for d in lines[:-2]) and "us_per_iter" in lines[-1]


def test_probe_primitives_runs_on_the_cpu(capsys):
    lines = _probe_lines(probe_primitives, capsys)
    verdicts = [d["verdict"] for d in lines if "verdict" in d]
    assert verdicts == ["COMPILES"] * 5
    assert len(lines) == 3 + 7 + 5 + 2 and lines[0]["name"] == "lax.sort 2-op stable 288K"
    assert lines[-1]["name"] == "pallas take_along_axis lanes"


@pytest.mark.parametrize("probe,names", [
    (probe_inflate_prims, ["a u32 sublane gather", "b dyn-row store while", "c vec-cond while",
                           "d fetch3 straddle", "e while+gather+store"]),
    (probe_inflate_prims2, ["f sublane min/sum", "g variable shifts", "h tree_decode fixed-lit",
                            "i lookup 288", "j window assembly"]),
], ids=["probe_inflate_prims", "probe_inflate_prims2"])
def test_probe_inflate_prims_runs_on_the_cpu(probe, names, capsys):
    lines = _probe_lines(probe, capsys)
    assert [d["name"] for d in lines] == names
    assert all(d["verdict"] == "MATCH" and set(d["ms"]) == {"128", "8192"} for d in lines)


def test_inflate_prims_inputs_are_the_tools():
    """The probes' 128-lane arrays are the tools' own draws."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 32, (8, 128), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, 8, (1, 128), dtype=np.int32)
    a = probe_inflate_prims.arrays(np.random.default_rng(0), 128)
    assert np.array_equal(a["x"].view(np.uint32), x) and np.array_equal(a["idx"], idx)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1000, (16, 128), dtype=np.int32)
    assert np.array_equal(probe_inflate_prims2.arrays(np.random.default_rng(1), 128)["x"], x)


def test_a_probe_divergence_raises(monkeypatch, capsys):
    """A kernel that differs from its plain version prints DIVERGE with the
    first positions, and the probe raises."""
    monkeypatch.setattr(ip, "col_min_sum", lambda x: ip.col_min_sum_plain(x) + 1)
    with pytest.raises(RuntimeError, match="DIVERGE"):
        probe_inflate_prims2.main(["--device", "cpu", "--reps", "1"])
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["verdict"] == "DIVERGE" and last["name"] == "f sublane min/sum"
    assert last["first"][0]["got"] == last["first"][0]["want"] + 1
