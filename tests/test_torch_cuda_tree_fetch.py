"""tree_decode and fetch_rows, redesigned for the card, against their plain
versions on the card.

Every test here is marked `cuda` and skips without a CUDA card.  The CPU
tests (test_torch_prim_probes.py) hold the plain versions to the tools'
Pallas kernels, show that row 0 of tree_decode's tables changes neither
k_h nor the plain version, and hold fetch_rows_plain to a numpy reference
at its edges; these hold the kernels to their plain versions on the same
card tensors, exactly, and assert each launch:

  lanes 1, 3, 63, 64, 65, 127, 128, 129, 8,192 and 8,193 (one block, the
  grid spread over the SMs, ragged blocks), every input 0 to 3 words past
  a 16-byte boundary; fetch_rows at k 1, 2, 3, 4, 5, 15, 16, 17 and 33
  (chunks of 4 and their tails) and nw 0, 1, 40 and 4,353, with j at int32's
  ends, at -k..-1 and at nw - k .. nw; tree_decode on the fixed lit/len
  tables, a one-code table (lanes that match nothing) and random tables,
  each also with row 0 poisoned; both kernels on a side stream behind
  torch.cuda._sleep, their inputs written after the sleep.

On a machine with a card (and no JAX, which tests/conftest.py imports),
from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_tree_fetch.py
"""

import numpy as np
import pytest
import torch

from tpuzlib_torch.codec.tables import FIXED_LITLEN_LENGTHS
from tpuzlib_torch.kernels import _build, inflate_cuda, inflate_prims as ip

pytestmark = pytest.mark.cuda

I32 = np.iinfo(np.int32)
LANES = [1, 3, 63, 64, 65, 127, 128, 129, 8192, 8193]
TABLES = ["fixed", "one code", "random"]


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
    j = rng.integers(-3 * nw - 3, 3 * nw + 3, (1, lanes), dtype=np.int32)
    edges = list(edges)[:lanes]
    j[0, : len(edges)] = edges
    return words, j


def _tree_inputs(table, lanes, seed, poison=False):
    """w (1, lanes) and cnt, first, off (16, lanes): the fixed lit/len
    tables, a one-code table, or random ones (differences that wrap, every
    comparison's sign); with `poison`, row 0 of each random int32 with
    int32's ends (lanes >= 4)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(I32.min, I32.max, (1, lanes), dtype=np.int32)
    if table == "random":
        tabs = [rng.integers(I32.min, I32.max, (16, lanes), dtype=np.int32) for _ in range(3)]
        half = (lanes + 1) // 2
        tabs[1][:, :half] = rng.integers(-4, 70000, (16, half))
        tabs[0][:, :half] = rng.integers(-2, 40000, (16, half))
    else:
        lengths = FIXED_LITLEN_LENGTHS if table == "fixed" else np.array([1] + [0] * 287)
        _, *cols = inflate_cuda.canon_tables(lengths, "litlen")
        tabs = [np.ascontiguousarray(np.tile(c[:, None], (1, lanes))) for c in cols]
    if poison:
        for n, t in enumerate(tabs):
            t[0] = rng.integers(I32.min, I32.max, lanes, dtype=np.int32)
            t[0, n : n + 2] = I32.min, I32.max
    return w, *tabs


def _fetched(words, j, k):
    before = _build.LAUNCHES["fetch_rows"]
    got = ip.fetch_rows(words, j, k)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fetch_rows"] == before + 1
    assert got.shape == (k, words.shape[1]) and got.dtype == torch.int32
    assert torch.equal(got, ip.fetch_rows_plain(words, j, k)), (tuple(words.shape), k)


def _decoded(w, cnt, first, off):
    before = _build.LAUNCHES["tree_decode"]
    got = ip.tree_decode(w, cnt, first, off)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["tree_decode"] == before + 1
    assert got.shape == (2, w.shape[1]) and got.dtype == torch.int32
    assert torch.equal(got, ip.tree_decode_plain(w, cnt, first, off)), tuple(w.shape)
    return got


@pytest.mark.parametrize("offset", range(4))
@pytest.mark.parametrize("lanes", LANES)
def test_fetch_rows_lanes(dev, lanes, offset):
    words, j = _words_j(40, lanes, lanes + offset, [-1, 0, 37, 38, 39, 40, I32.min, I32.max])
    _fetched(_on(dev, words, offset), _on(dev, j, 3 - offset), 3)


@pytest.mark.parametrize("nw", [0, 1, 40, 4353])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 15, 16, 17, 33])
def test_fetch_rows_rows_and_k(dev, k, nw):
    edges = [I32.min, I32.max, *range(-k, 0), *range(nw - k, nw + 1)]
    words, j = _words_j(nw, 129, k * 11 + nw, edges)
    _fetched(_on(dev, words, 0), _on(dev, j, 1), k)


@pytest.mark.parametrize("offset", range(4))
@pytest.mark.parametrize("lanes", LANES)
def test_tree_decode_lanes(dev, lanes, offset):
    w, *tabs = _tree_inputs("random" if lanes % 2 else "fixed", lanes, lanes * 4 + offset)
    # each input at its own offset: w at `offset`, the tables after it
    _decoded(*(_on(dev, a, (offset + n) % 4) for n, a in enumerate((w, *tabs))))


@pytest.mark.parametrize("poison", [False, True], ids=["row 0 as built", "row 0 poisoned"])
@pytest.mark.parametrize("lanes", [129, 8193])
@pytest.mark.parametrize("table", TABLES)
def test_tree_decode_tables(dev, table, lanes, poison):
    inputs = _tree_inputs(table, lanes, lanes, poison)
    got = _decoded(*(_on(dev, a, 0) for a in inputs))
    if table == "one code":  # lanes that match nothing (99) and lanes that match at 1
        assert (got[0] == 99).any() and (got[0] == 1).any()
    if poison:  # row 0 changes nothing
        clean = _tree_inputs(table, lanes, lanes)
        assert torch.equal(got, ip.tree_decode_plain(*(_on(dev, a, 0) for a in clean)))


def test_both_on_a_side_stream_behind_a_sleep(dev):
    """A call under torch.cuda.stream(s), s queued behind a sleep and the
    inputs written on s after it: a launch on any other stream would run
    before them and read the zeros."""
    host = [torch.from_numpy(a) for a in (*_words_j(40, 8192, 5, [-1, 39, I32.min]),
                                          *_tree_inputs("fixed", 8192, 6))]
    srcs = [t.to(dev) for t in host]
    ins = [torch.zeros_like(t) for t in srcs]
    torch.cuda.synchronize()
    s = torch.cuda.Stream(dev)
    with torch.cuda.stream(s):
        torch.cuda._sleep(100_000_000)  # ~50 ms
        for t, src in zip(ins, srcs):
            t.copy_(src)
        fetched, decoded = ip.fetch_rows(ins[0], ins[1], 3), ip.tree_decode(*ins[2:])
    s.synchronize()
    assert torch.equal(fetched.cpu(), ip.fetch_rows_plain(host[0], host[1], 3))
    assert torch.equal(decoded.cpu(), ip.tree_decode_plain(*host[2:]))
