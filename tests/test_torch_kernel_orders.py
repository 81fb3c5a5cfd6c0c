"""The orders in which the card's crc_forms_mm, take_along_loop and
crc_unpack kernels work, replayed on the host against the plain versions
and the tools' Pallas kernels.

crc_forms_mm's kernel multiplies with K permuted (crc32_probe.card_order)
and, in int8, with M's rows scaled and the parity taken from bit 7
(card_matrix_rows); its M operand is an image in wgmma's swizzled layout
(card_image).  take_along_loop's kernels step their index by one from a
single floor mod (gather_probe.loop_steps).  Each replay is held, with
exact equality, to the plain version and to the tool's kernel in
interpret mode on the same seeded numpy input.  crc_unpack's kernel
builds its bit planes as the forms kernel does and sums them a plane at a
time (__dp4a in i32, bf16x2 FMAs flushed every 32 words in bf16): its
accumulators are replayed on words of random and all-0xFF bytes.
shift_screen's register route screens a chunk's body in warp tiles, its
lanes' predecessors from the lanes before them, and the words around it
one at a time (gather_probe.card_shift_plain): the replay is held to the
plain version.  gf2_bits_mm's checks are held to what its card call
refuses.  gather_store_loop's kernel computes each lane's rows from one
floor mod and offsets summed once (inflate_prims.store_loop_steps): the
replay, gathered, is held to the plain version and to the tool's k_e in
interpret mode at the index rule's edges.  The route helpers
(forms_route, bits_mm_route, loop_design, shift_route, vec_cond_while's
while_route) are held at their boundaries.  No card is needed.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpuzlib_torch.kernels import crc32_probe as cp, gather_probe as gp, inflate_prims as ip

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
I32 = np.iinfo(np.int32)
# the widest line the H100's kernels stage (232,448 bytes a block may opt in to, over 4)
H100_STAGED_WORDS = 232448 // 4


@functools.lru_cache()
def _tool(name):
    spec = importlib.util.spec_from_file_location("tool_" + name,
                                                  os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bytes(nb, block, seed, fill=None):
    if fill is not None:
        return np.full((nb, block), fill, np.uint8)
    return np.random.default_rng(seed).integers(0, 256, (nb, block), dtype=np.uint8)


# ---- crc_forms_mm -------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(cp.DTYPES))
@pytest.mark.parametrize("block", cp.FORM_BLOCKS)
def test_card_order_permutes_k(block, dtype):
    """Every (plane, byte) once; each slice of 32 bytes keeps its bytes."""
    plane, byte = cp.card_order(block, dtype)
    assert plane.shape == byte.shape == (8 * block,)
    assert np.array_equal(np.sort(plane * block + byte), np.arange(8 * block))
    slices = np.arange(8 * block) // 256
    assert np.array_equal(byte // cp.SLICE, slices)


@pytest.mark.parametrize("dtype", sorted(cp.DTYPES))
@pytest.mark.parametrize("block", cp.FORM_BLOCKS)
def test_card_matrix_rows_are_m_in_card_order(block, dtype):
    plane, byte = cp.card_order(block, dtype)
    rows = cp.card_matrix_rows(block, dtype)
    m = cp.plane_matrix_bits(block)[plane * block + byte].astype(np.int64)
    if dtype == "bf16":
        assert np.array_equal(rows, m)
    else:  # 2^(7 - i) for a set bit, 128 wrapped to -128: 128 x M mod 256 per product
        assert rows.min() >= -128 and rows.max() <= 64
        assert np.array_equal(rows % 256, (m << (7 - plane[:, None])) % 256)


@pytest.mark.parametrize("dtype", sorted(cp.DTYPES))
@pytest.mark.parametrize("block", cp.FORM_BLOCKS)
def test_card_image_holds_the_rows_in_wgmma_layout(block, dtype):
    """Element (K row k, column n) of a slice sits in box k * size // 128 at
    row n, 16-byte chunk (k * size % 128 // 16) ^ (n % 8)."""
    rows = cp.card_matrix_rows(block, dtype)
    size = 2 if dtype == "bf16" else 1
    img = cp.card_image(block, dtype)
    assert img.dtype == np.uint8 and img.size == rows.size * size
    slab = img.reshape(block // cp.SLICE, -1, 32, 128)  # slice, box, row n, 128 bytes
    for k in (0, 1, 15, 16, 63, 64, 127, 255, 8 * block - 1):
        s, at = divmod(k * size, 256 * size)
        box, col = divmod(at, 128)
        for n in (0, 5, 8, 31):
            pos = ((col >> 4) ^ (n & 7)) << 4 | (col & 15)
            raw = slab[s, box, n, pos:pos + size]
            if dtype == "bf16":
                want = 0x3F80 if rows[k, n] else 0
                assert int(raw.view(np.uint16)[0]) == want, (k, n)
            else:
                assert int(raw.view(np.int8)[0]) == rows[k, n], (k, n)


@pytest.mark.parametrize("fill", [None, 0, 255])
@pytest.mark.parametrize("dtype", sorted(cp.DTYPES))
@pytest.mark.parametrize("block", cp.FORM_BLOCKS)
def test_card_forms_replay_matches_plain_and_make_forms_kernel(block, dtype, fill):
    """The card's permuted bits times its permuted (and scaled) M give the
    plain columns and the tool's make_forms_kernel output."""
    nb = 16 if block == 1024 else 8
    x = _bytes(nb, block, 7 * block + len(dtype), fill)
    mode = "plane_" + dtype
    want = np.asarray(_tool("probe_crc").make_forms_kernel(block, 8, mode)(jnp.asarray(x)))
    t = torch.from_numpy(x)
    got = cp.card_forms_plain(t, dtype)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, cp.crc_forms_mm_plain(t, dtype))


def _view_at(nb, block, offset, stride=None):
    """A (nb, block) uint8 view `offset` bytes into a 16-byte aligned buffer,
    rows `stride` bytes apart."""
    stride = block if stride is None else stride
    buf = torch.zeros(nb * stride + offset + 64, dtype=torch.uint8)
    shift = (-buf.data_ptr()) % 16
    return buf[shift + offset:].as_strided((nb, block), (stride, 1))


@pytest.mark.parametrize("offset", list(range(17)))
def test_forms_route_from_alignment(offset):
    x = _view_at(3, 1024, offset)
    assert x.data_ptr() % 16 == offset % 16
    assert cp.forms_route(x) == ("tma" if offset % 16 == 0 else "ldg")


@pytest.mark.parametrize("stride", [1024, 1032, 1040, 4096, 4100])
def test_forms_route_ignores_row_stride(stride):
    # one row is contiguous whatever its stride: its pointer alone decides
    row = _view_at(1, 1024, 0, stride)
    assert row.is_contiguous() and cp.forms_route(row) == "tma"
    assert torch.equal(cp.crc_forms_mm(row), cp.crc_forms_mm(row.clone()))
    # rows apart from each other are refused before any route is taken
    rows = _view_at(2, 1024, 0, stride)
    if stride == 1024:
        assert rows.is_contiguous()
    else:
        with pytest.raises(ValueError):
            cp.crc_forms_mm(rows)


# ---- take_along_loop ------------------------------------------------------------

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


@pytest.mark.parametrize("axis,shape,iters", [(0, (16, 128), 64), (1, (8, 128), 64),
                                              (0, (5, 3), 64), (1, (3, 7), 40),
                                              (0, (9, 128), 1), (1, (4, 128), 0)])
def test_loop_steps_replay_matches_plain_and_loop_cost(axis, shape, iters):
    """Indices at int32's ends (the wrap step: 2^31 - idx < iters) and
    around them, negative and past n."""
    rng = np.random.default_rng(shape[0] * 31 + shape[1] + axis + iters)
    n = shape[axis]
    x = rng.integers(I32.min, I32.max, shape, dtype=np.int32)
    idx = rng.integers(-3 * n, 3 * n, shape, dtype=np.int32)
    edges = [I32.max, I32.max - 30, I32.max - 63, I32.max - 64, I32.min, I32.min + 1, -1,
             n, -n - 5]
    idx.reshape(-1)[: len(edges)] = edges[: idx.size]
    want = np.asarray(pl.pallas_call(_loop_kernel(axis, n, iters),
                                     out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
                                     interpret=True)(jnp.asarray(x), jnp.asarray(idx)))
    tx, ti = torch.from_numpy(x), torch.from_numpy(idx)
    got = gp.take_along_loop_stepped(tx, ti, axis, iters)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, gp.take_along_loop_plain(tx, ti, axis, iters))


@pytest.mark.parametrize("i0,n", [(I32.max, 7), (I32.max - 2, 4352), (I32.min, 5),
                                  (I32.max - 63, 128), (-1, 3), (0, 1)])
def test_loop_steps_take_the_wrap_step_afresh(i0, n):
    """Step t is the floor mod of idx + t wrapped to int32, the one wrap
    included."""
    steps = gp.loop_steps(torch.tensor([i0], dtype=torch.int32), n, 64)[0].tolist()
    wrapped = [i0 + t - (1 << 32) if i0 + t > I32.max else i0 + t for t in range(64)]
    assert steps == [v % n for v in wrapped]


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("extent,design", [(1, "staged"), (H100_STAGED_WORDS, "staged"),
                                           (H100_STAGED_WORDS + 1, "ldg")])
def test_loop_design_at_the_staged_limit(axis, extent, design):
    shape = (extent, 2) if axis == 0 else (2, extent)
    x = torch.empty(shape, dtype=torch.int32, device="meta")
    assert gp.loop_design(x, axis, H100_STAGED_WORDS) == design
    # the other extent does not matter
    y = torch.empty(shape[::-1], dtype=torch.int32, device="meta")
    assert gp.loop_design(y, axis, H100_STAGED_WORDS) == "staged"


def _words(fill: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if fill == "0xFF":
        return np.full(n, 0xFFFFFFFF, np.int64)
    return rng.integers(0, 1 << 32, n, dtype=np.int64)


def _popcounts(words: np.ndarray) -> np.ndarray:
    """The bits set in each byte position (0-3) of the words, summed."""
    b = words.astype("<u4").view(np.uint8).reshape(-1, 4)
    return np.unpackbits(b[:, :, None], axis=2).sum((0, 2))


def _bf16_halves(u32: np.ndarray) -> torch.Tensor:
    """A uint32 (as int64) as its two 16-bit halves, low first, in bf16."""
    halves = np.stack([u32 & 0xFFFF, u32 >> 16], -1).astype(np.uint16)
    return torch.from_numpy(halves.view(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("fill", ["random", "0xFF"])
def test_unpack_bf16_accumulator_replay(fill):
    """RowAcc<kBf16>: the spread byte pair shifted up by 7, masked to plane
    i, is 2^(2^i - 127) as bf16 where the bit is set; times 2^(127 - 2^i)
    it is 1.0, so one bf16 FMA adds the bit (the product is exact, so the
    FMA rounds as the add alone).  32 words' planes give each byte
    position's bit count exactly, 256 at most; one word more of 0xFF bytes
    would not be exact, so the kernel flushes every 32 words."""
    words = _words(fill, 32)
    acc = torch.zeros(4, dtype=torch.bfloat16)  # halves a.lo, a.hi, b.lo, b.hi
    for w in words:
        lo = ((w & 0xFF) | ((w >> 8) & 0xFF) << 16) << 7  # __byte_perm(w, 0, 0x4140) << 7
        hi = (((w >> 16) & 0xFF) | ((w >> 24) & 0xFF) << 16) << 7  # 0x4342
        for i in range(8):
            planes = _bf16_halves(np.array([s & (0x00800080 << i) for s in (lo, hi)]))
            scale = _bf16_halves(np.array([((254 - (1 << i)) << 7) * 0x10001] * 2))
            product = planes.float().reshape(-1) * scale.float().reshape(-1)
            assert set(product.tolist()) <= {0.0, 1.0}
            acc = (acc.float() + product).to(torch.bfloat16)
    assert acc.float().tolist() == _popcounts(words).tolist()
    if fill == "0xFF":
        assert acc.float().tolist() == [256.0] * 4
        assert float(acc[0] + torch.ones(1, dtype=torch.bfloat16)) == 256.0  # 257 rounds away


@pytest.mark.parametrize("fill", ["random", "0xFF"])
def test_unpack_i32_accumulator_replay(fill):
    """RowAcc<kI32>: plane i of four bytes, w & 0x01010101 << i, summed by
    __dp4a against 0x01010101 into one sum a plane (each bit at weight
    2^i), shifted back at the end: the words' bit count."""
    words = _words(fill, 1000)
    p = [0] * 8
    for w in words:
        for i in range(8):
            plane = int(w) & (0x01010101 << i)
            p[i] += sum((plane >> 8 * k) & 0xFF for k in range(4))  # __dp4a(plane, 0x01010101, p[i])
    assert all(v % (1 << i) == 0 for i, v in enumerate(p))
    assert sum(v >> i for i, v in enumerate(p)) == int(_popcounts(words).sum())


@pytest.mark.parametrize("lanes,route", [(1, "regs"), (ip.REG_LANES, "regs"),
                                         (ip.REG_LANES + 1, "smem"),
                                         (H100_STAGED_WORDS, "smem"),
                                         (H100_STAGED_WORDS + 1, "global")])
def test_while_route_at_its_limits(lanes, route):
    assert ip.REG_LANES == 8 * 1024
    assert ip.while_route(lanes, H100_STAGED_WORDS) == route
    assert route in ip.WHILE_ROUTES


# ---- gf2_bits_mm ----------------------------------------------------------------

@pytest.mark.parametrize("offset", list(range(9)))
def test_bits_mm_route_from_alignment(offset):
    """bf16 bits on a 16-byte boundary (every 8 elements) go by TMA."""
    buf = torch.zeros(4 * 128 + 16, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    bits = buf[offset : offset + 4 * 128].view(4, 128)
    assert cp.bits_mm_route(bits) == ("tma" if offset % 8 == 0 else "ldg")


@pytest.mark.parametrize("row", [0, 1, 2, 5])
@pytest.mark.parametrize("K", [128, 384, 1024])
def test_bits_mm_route_keeps_tma_for_later_rows(K, row):
    """A row's pitch, 2K bytes, is a multiple of 256: bits from any row of
    bits on a 16-byte boundary start on one too, and go by TMA."""
    bits = torch.zeros(8, K, dtype=torch.bfloat16)
    assert bits.data_ptr() % 16 == 0
    assert cp.bits_mm_route(bits[row:]) == "tma"


_BITS = torch.zeros(4, 256, dtype=torch.bfloat16)
_M = torch.zeros(256, 32, dtype=torch.bfloat16)


@pytest.mark.parametrize("bits,m,exc", [
    (_BITS, _M.float(), TypeError),
    (_BITS.reshape(-1), _M, ValueError),
    (_BITS[:, ::2], _M[:128], ValueError),
    (_BITS[:, :0], _M[:0], ValueError),
    (_BITS[:, :64].contiguous(), _M[:64], ValueError),
    (_BITS[:, :128].contiguous(), _M, ValueError),
    (_BITS, torch.zeros(256, 33, dtype=torch.bfloat16), ValueError),
    (_BITS, _M.to("meta"), ValueError),
], ids=["m_f32", "bits_1d", "bits_strided", "k0", "k64", "m_rows", "m_33_cols", "two_devices"])
def test_gf2_bits_mm_refuses_what_its_kernel_does(bits, m, exc):
    """The checks a card call makes before its launch (_check_bits), run on
    the CPU by the plain version; test_torch_crc_probes.py holds the
    others."""
    with pytest.raises(exc):
        cp.gf2_bits_mm(bits, m)


def test_gf2_bits_mm_of_no_rows():
    """No rows give an empty (0, 32) parity, as the card call does without
    a launch."""
    got = cp.gf2_bits_mm(_BITS[:0], _M)
    assert got.shape == (0, 32) and got.dtype == torch.int32


# ---- shift_screen ---------------------------------------------------------------

@pytest.mark.parametrize("steps,route", [(0, "regs"), (1, "regs"), (gp.SHIFT_WINDOW, "regs"),
                                         (gp.SHIFT_WINDOW + 1, "staged"), (40, "staged"),
                                         (gp.MAX_STEPS, "staged")])
def test_shift_route_at_its_window(steps, route):
    x = torch.zeros(2, 3, 129, dtype=torch.int32)
    assert gp.shift_route(x, steps) == route


def test_shift_route_refuses_what_shift_screen_does():
    x = torch.zeros(3, 129, dtype=torch.int32)
    for bad, steps in ((x, gp.MAX_STEPS + 1), (x, -1), (x.reshape(-1), 16),
                       (torch.zeros(65536, 1, 1, dtype=torch.int32), 16)):
        with pytest.raises(ValueError):
            gp.shift_route(bad, steps)


@pytest.mark.parametrize("offset", range(4))
@pytest.mark.parametrize("n", [1, 3, 10, 16, 19, 20, 23, 129, 1000])
def test_shift_split_bounds_the_body(n, offset):
    """The body starts on a 16-byte boundary at or past word SHIFT_WINDOW
    (no word of it wraps) and ends at the chunk's last whole int4."""
    v0, n4 = gp.shift_split(n, offset)
    assert (offset + v0) % 4 == 0 and gp.SHIFT_WINDOW <= v0 < gp.SHIFT_WINDOW + 4
    v1 = v0 + 4 * n4
    if n >= v0:
        assert v1 <= n < v1 + 4
    else:
        assert n4 == 0


@pytest.mark.parametrize("steps", [0, 1, 15, 16])
@pytest.mark.parametrize("offset", range(4))
@pytest.mark.parametrize("n", [1, 3, 10, 19, 20, 23, 129, 1000, 4353])
def test_card_shift_replay_matches_plain(n, offset, steps):
    """The register route's split (head and tail words alone, the body in
    warp tiles whose lanes 28-31 send the words before the tile) gives
    the plain screen on 3 chunks of n words, each chunk's first word at its
    own offset of a 16-byte boundary."""
    rng = np.random.default_rng(n + 7 * offset + steps)
    x = torch.from_numpy(rng.integers(I32.min, I32.max, (3, 1, n), dtype=np.int32))
    assert torch.equal(gp.card_shift_plain(x, steps, offset), gp.shift_screen_plain(x, steps))


# ---- gather_store_loop and col_min_sum ----------------------------------------

# tools/probe_inflate_prims.py:131-148, k_e with NW = nw (its 8-row tiles
# over words padded with zero rows to a multiple of 8: a row in the pad
# reads 0, as a row outside [0, nw) does) and `steps` steps
def _store_loop_kernel(nw, steps):
    tiles = -(-nw // 8)

    def k_e(w_ref, j_ref, o_ref):
        def cond(st):
            it, _ = st
            return it < steps

        def body(st):
            it, j = st
            v = j >> 3
            sb = jnp.broadcast_to(j & 7, (8, j.shape[1]))
            g = jnp.zeros((1, j.shape[1]), jnp.uint32)
            for t in range(tiles):
                tile = w_ref[t * 8 : (t + 1) * 8, :]
                gt = jnp.take_along_axis(tile, sb, axis=0)[0:1]
                g = jnp.where(v == t, gt, g)
            o_ref[pl.ds(it, 1), :] = g
            return it + 1, (j + 3) % (nw - 1)

        jax.lax.while_loop(cond, body, (jnp.int32(0), j_ref[:]))

    return k_e


@pytest.mark.parametrize("steps", [1, 15, 16, 17, 33])
@pytest.mark.parametrize("nw", [2, 3, 4, 5, 40, 4353])
def test_store_loop_steps_replay_matches_plain_and_k_e(nw, steps):
    """gather_store_loop's rows as its card kernel computes them (one floor
    mod, then a chunk's first row plus an offset a step), gathered, against the plain
    version and k_e in interpret mode; j at int32's ends, at -3..-1 and at
    nw - 4 .. nw + 3 (rows below 0 and past the words read 0 at step 0)."""
    rng = np.random.default_rng(nw * 41 + steps)
    lanes = 128
    words = rng.integers(0, 1 << 32, (nw, lanes), dtype=np.uint64).astype(np.uint32)
    j = rng.integers(-3 * nw, 3 * nw, (1, lanes), dtype=np.int32)
    edges = [I32.min, I32.max, -3, -2, -1, *range(nw - 4, nw + 4)]
    j[0, : len(edges)] = edges
    padded = np.zeros((-(-nw // 8) * 8, lanes), np.uint32)
    padded[:nw] = words
    want = np.asarray(pl.pallas_call(_store_loop_kernel(nw, steps),
                                     out_shape=jax.ShapeDtypeStruct((steps, lanes), jnp.uint32),
                                     interpret=True)(jnp.asarray(padded), jnp.asarray(j)))
    tw, tj = torch.from_numpy(words.view(np.int32)), torch.from_numpy(j)
    rows = ip.store_loop_steps(tj, nw, steps)
    assert rows.shape == (steps, lanes) and rows.dtype == torch.int64
    assert bool(((rows[1:] >= 0) & (rows[1:] < nw - 1)).all())  # no range check after step 0
    inside = (rows >= 0) & (rows < nw)
    got = torch.where(inside, torch.gather(tw, 0, rows.clamp(0, nw - 1)), 0)
    assert np.array_equal(got.numpy(), want.view(np.int32))
    assert torch.equal(got, ip.gather_store_loop_plain(tw, tj, steps))


@pytest.mark.parametrize("nw", [2, 3, 40])
def test_store_loop_steps_of_no_steps(nw):
    j = torch.tensor([[I32.min, -1, 0, nw]], dtype=torch.int32)
    rows = ip.store_loop_steps(j, nw, 0)
    assert rows.shape == (0, 4) and rows.dtype == torch.int64


@pytest.mark.parametrize("nw,steps", [(1, 4), (0, 1), (40, -1)])
def test_store_loop_steps_refuses(nw, steps):
    with pytest.raises(ValueError):
        ip.store_loop_steps(torch.zeros(1, 3, dtype=torch.int32), nw, steps)


def test_col_min_sum_refuses_what_its_kernel_does():
    for x, exc in ((torch.zeros(0, 4, dtype=torch.int32), ValueError),
                   (torch.zeros(2, 4, dtype=torch.int64), TypeError),
                   (torch.zeros(4, 2, dtype=torch.int32).t(), ValueError),
                   (torch.zeros(2, 3, 4, dtype=torch.int32), ValueError)):
        with pytest.raises(exc):
            ip.col_min_sum(x)


# ---- scatter_max ----------------------------------------------------------------

@pytest.mark.parametrize("rows,route", [(1, "smem"), (2304, "smem"), (H100_STAGED_WORDS, "smem"),
                                        (H100_STAGED_WORDS + 1, "global"), ((1 << 31) - 1, "global")])
def test_scatter_route_at_the_staged_limit(rows, route):
    idx = torch.zeros(2, 3, 5, dtype=torch.int32)
    assert gp.scatter_route(idx, rows, H100_STAGED_WORDS) == route
    assert gp.scatter_route(idx[0], rows, rows) == "smem"
    if rows > 1:
        assert gp.scatter_route(idx, rows, rows - 1) == "global"


def test_scatter_route_refuses_what_scatter_max_does():
    idx = torch.zeros(3, 4, dtype=torch.int32)
    for bad, rows in ((idx, 0), (idx, 1 << 31), (idx[:0], 4), (idx.reshape(-1), 4),
                      (idx.long(), 4)):
        with pytest.raises((ValueError, TypeError)):
            gp.scatter_route(bad, rows, H100_STAGED_WORDS)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("b,r,w,rows", [(8, 2304, 128, 2304), (1, 256, 128, 256), (1, 1, 1, 1),
                                        (3, 5, 127, 4353), (2, 600, 12, H100_STAGED_WORDS),
                                        (1, 9, 129, 7), (70000, 2, 4, 3), (2, 40, 132, 3632),
                                        (9, 3, 64, 14528)])
def test_scatter_slabs_cover_each_column_once_and_fit(b, r, w, rows, sms):
    """The smem route's plan: slabs of 8 columns (a 32-byte sector of a
    row), 4 where 8 would leave more than half the SMs without a block,
    fewer where the slab would not fit the staged words; a block a
    multiple of 32 no narrower than its slab; its blocks cover every
    (chunk, column) exactly once."""
    cols, threads = gp.scatter_slabs(b, r, w, rows, sms, H100_STAGED_WORDS)
    want = 8 if 2 * b * -(-w // 8) >= sms else 4
    while rows * want > H100_STAGED_WORDS:
        want //= 2
    assert cols == want and rows * cols <= H100_STAGED_WORDS
    assert threads % 32 == 0 and max(32, cols) <= threads <= gp.SCATTER_THREADS
    assert threads == gp.scatter_threads(r, w, rows, cols)
    blocks = gp.scatter_blocks(b, w, cols)
    assert len(blocks) == b * -(-w // cols)
    seen = np.zeros((b, w), np.int64)
    for k, c0, nc in blocks:
        assert 1 <= nc <= cols and c0 % cols == 0
        seen[k, c0:c0 + nc] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("b,r,w,rows,cols", [(8, 2304, 128, 2304, 8), (1, 256, 128, 256, 4),
                                             (1, 2304, 128, 2304, 4), (3, 5, 127, 4353, 4),
                                             (2, 600, 12, H100_STAGED_WORDS, 1),
                                             (9, 3, 64, 14528, 4), (9, 3, 64, 14529, 2)])
def test_scatter_slabs_on_an_h100(b, r, w, rows, cols):
    """On 132 SMs: the encoder batch's (8, 2304, 128) in slabs of 8
    columns (128 blocks of 512 threads, 72 KiB each), one chunk and the
    tool's (256, 128) in slabs of 4; the staged words cap the width."""
    assert gp.scatter_slabs(b, r, w, rows, 132, H100_STAGED_WORDS)[0] == cols
    if (b, w) == (8, 128):
        assert gp.scatter_slabs(b, r, w, rows, 132, H100_STAGED_WORDS)[1] == 512
        assert len(gp.scatter_blocks(b, w, cols)) == 128


@pytest.mark.parametrize("r,w,rows,cols,threads", [(2304, 128, 2304, 8, 512), (256, 128, 256, 4, 256),
                                                   (1, 1, 1, 1, 32), (5, 127, 4353, 4, 512),
                                                   (40, 5, 40, 4, 160), (3, 8, 3, 8, 32)])
def test_scatter_threads(r, w, rows, cols, threads):
    """A thread a unit of each of max(r, rows) rows (4 columns where w and
    cols are multiples of 4, else 1), in warps, up to 512."""
    assert gp.scatter_threads(r, w, rows, cols) == threads


@pytest.mark.parametrize("rows", [0, H100_STAGED_WORDS + 1])
def test_scatter_slabs_refuse_rows_past_the_staged_words(rows):
    with pytest.raises(ValueError):
        gp.scatter_slabs(1, 4, 4, rows, 132, H100_STAGED_WORDS)
