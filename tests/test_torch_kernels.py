"""tpuzlib_torch's kernel modules against tpuzlib, on the CPU.

Each kernel's plain torch version (what its wrapper runs on a CPU tensor)
is held against the tpuzlib function it replaces, on the same numpy
input made from a seed: the Pallas kernels run in interpret mode, as the
JAX package's own tests run them.  Every comparison is exact integer
equality: no output of the codec is a float.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuzlib.kernels import deflate_device as jdd
from tpuzlib.kernels import deflate_device3 as jd3
from tpuzlib.kernels import huffman_device as jhuff
from tpuzlib.kernels import parse_pallas as jparse
from tpuzlib.kernels import screen_pallas as jscreen
from tpuzlib_torch import testing
from tpuzlib_torch.codec.bitsink import BitSink
from tpuzlib_torch.kernels import deflate_device as tdd
from tpuzlib_torch.kernels import deflate_device3 as td3
from tpuzlib_torch.kernels import huffman_device as thuff
from tpuzlib_torch.kernels import parse as tparse
from tpuzlib_torch.kernels import screen as tscreen

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

SPAN = jscreen.TR * 128  # positions per Pallas screen tile


def _eq(jax_out, torch_out):
    a = np.asarray(jax_out).astype(np.int64)
    b = np.asarray(torch_out).astype(np.int64)
    assert a.shape == b.shape
    bad = np.flatnonzero(a.reshape(-1) != b.reshape(-1))
    assert bad.size == 0, (bad[:5], a.reshape(-1)[bad[:5]], b.reshape(-1)[bad[:5]])


def _windows(data):
    """Both packages' (w0..w3) windows of `data`, checked equal."""
    w0 = jdd._build_w32(jnp, jnp.asarray(data))
    jws = [w0] + [jnp.concatenate([w0[o:], jnp.zeros(o, jnp.uint32)]) for o in (4, 8, 12)]
    tws = td3.window_words(torch.from_numpy(data))
    for a, b in zip(jws, tws):
        _eq(np.asarray(a).view(np.int32), b)
    return jws, tws


def _screen_input(total, seed):
    """Low-entropy data across a screen-tile boundary, with a candidate
    floor that moves, as the encoder's per-chunk context does."""
    rng = np.random.default_rng(seed)
    data = testing.mixed(total, seed)
    data[: total // 3] = rng.integers(0, 4, total // 3)  # dense near matches
    mincand = np.repeat(rng.integers(0, 2000, 4), -(-total // 4))[:total].astype(np.int32)
    mincand = np.minimum(mincand, np.arange(total, dtype=np.int32))
    lim16 = np.clip(total - np.arange(total), 0, 16).astype(np.int32)
    return data, mincand, lim16


def _near_both(data, mincand, lim16, nd):
    """tpuzlib's near screen on windows of `data`, and the port's on its
    bytes."""
    jws, _ = _windows(data)
    want = jscreen.near_screen(jax, jnp, *jws, jnp.asarray(mincand), jnp.asarray(lim16), nd)
    got = tscreen.near_screen(*(torch.from_numpy(a) for a in (data, mincand, lim16)), nd)
    return want, got


@pytest.mark.parametrize("level", [1, 6, 9])
def test_near_screen_plain_matches_pallas(level):
    nd = jd3.LEVELS_V3[level]["nd"]
    want, got = _near_both(*_screen_input(SPAN + 4 * 128, level), nd)
    _eq(want, got)
    assert (got.numpy() > 0).mean() > 0.02


def test_near_screen_tile_boundary():
    """Matches whose candidates lie just before a TPU tile boundary."""
    total = SPAN + 4 * 128
    data = np.zeros(total, np.uint8)
    data[SPAN - 30 : SPAN + 30] = np.tile(np.asarray([7, 11, 13], np.uint8), 20)
    mincand = np.zeros(total, np.int32)
    lim16 = np.clip(total - np.arange(total), 0, 16).astype(np.int32)
    want, got = _near_both(data, mincand, lim16, 8)
    _eq(want, got)
    key = got.numpy()[SPAN - 2 : SPAN + 20]
    assert ((key >> 16) >= 3).all() and (0xFFFF - (key & 0xFFFF) == 3).all()


def _screen16(pad, p, q):
    """Common prefix (0..16) of the windows at p and q of zero-padded bytes."""
    ne = np.flatnonzero(pad[p : p + 16] != pad[q : q + 16])
    return int(ne[0]) if ne.size else 16


@pytest.mark.parametrize("nd", [8, 24])
def test_near_walk_with_exits_matches_pallas(nd):
    """The near kernel's walk, nearest candidate first, stopping past
    mincand and at the first screen that reaches lim16, finds tpuzlib's
    keys; near_trips counts its compares."""
    total = 3000
    data, mincand, lim16 = _screen_input(total, nd)
    data[2000:2100] = 9  # a run: every screen reaches its cap at d = 1
    lim16[1000:1100] = np.arange(100) % 4  # caps below and at MIN_MATCH
    pad = np.concatenate([data, np.zeros(16, np.uint8)])
    keys, trips = np.zeros(total, np.int64), np.zeros(total, np.int64)
    for p in range(total):
        for d in range(1, nd + 1):
            if lim16[p] < 3 or d > p - mincand[p]:
                break
            trips[p] += 1
            sc = min(_screen16(pad, p, p - d), lim16[p])
            if sc >= 3:
                keys[p] = max(keys[p], sc << 16 | (0xFFFF - d))
            if sc == lim16[p]:
                break
    want, got = _near_both(data, mincand, lim16, nd)
    _eq(want, got)
    _eq(keys, got)
    args = (torch.from_numpy(a) for a in (data, mincand, lim16))
    _eq(trips, tscreen.near_trips(*args, nd))
    assert 0 < trips.mean() < nd


def _far_both(data, best, rows, k):
    """tpuzlib's far screen over the port's sorted rows, its keys
    scattered into a copy of `best` with a max in numpy, and the port's,
    updated in place; probe after probe."""
    jws, _ = _windows(data)
    want, got = best.copy(), torch.from_numpy(best.copy())
    for sh, perm in rows:
        sp = perm.numpy()
        keys = jscreen.far_screen(jax, jnp, jnp.asarray(sh.numpy()),
                                  jnp.asarray(sp.astype(np.int32)), *(w[sp] for w in jws), k)
        want[sp] = np.maximum(want[sp], np.asarray(keys))
        assert tscreen.far_screen(sh, perm, torch.from_numpy(data), got, k) is got
    return want, got


@pytest.mark.parametrize("level", [1, 6, 9])
def test_far_screen_plain_matches_pallas(level):
    """Both hash probes of a level, from the near screen's keys: the port
    sorts, both packages screen the same sorted rows."""
    data, mincand, lim16 = _screen_input(SPAN + 3 * 128, 10 + level)
    tdata, tmin = torch.from_numpy(data), torch.from_numpy(mincand)
    chid = torch.from_numpy((np.arange(len(data)) >= len(data) // 2).astype(np.int32))
    ws = td3.window_words(tdata)
    rows = [td3.probe_rows(ws, tmin, chid, nbytes, bits) for nbytes, bits in td3.PROBES
            if jd3.LEVELS_V3[level]["k%d" % nbytes]]
    best = tscreen.near_screen(tdata, tmin, torch.from_numpy(lim16), jd3.LEVELS_V3[level]["nd"])
    for (sh, perm), nbytes in zip(rows, (4, 6)):
        want, got = _far_both(data, best.numpy(), [(sh, perm)], jd3.LEVELS_V3[level]["k%d" % nbytes])
        _eq(want, got)
        assert (got > best).any()  # the probe found keys the near band did not


def _far_case(case, total=70001, seed=0):
    """Bytes and one hash bucket (the positions that share a hash; every
    other position has a sentinel hash of its own, as probe_rows gives
    invalid positions) that drive the far walk's exits."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, total, dtype=np.uint8)
    if case == "long bucket":
        pos = np.sort(rng.choice(total - 32, 200, replace=False))
        for i, p in enumerate(pos):
            data[p : p + 3] = 77
            data[p + 3 : p + 3 + i % 14] = 78
    elif case == "gaps of 32768":
        pos = np.asarray([10, 20, 20 + 32768, 20 + 32768 + 32769, 20 + 2 * 32768 + 5])
        for p in pos:
            data[p : p + 20] = 33
    elif case == "16 at j = 1":
        pos = 100 * np.arange(1, 300)
        for i, p in enumerate(pos):
            data[p : p + 16] = 44
            data[p + 16] = i % 3
    else:  # the last 15 positions and those before them
        data[-40:] = 5
        pos = np.arange(total - 40, total)
    hc = (1 << 28) + np.arange(total, dtype=np.int32)
    hc[pos] = 5
    return data, torch.sort(torch.from_numpy(hc), stable=True)


@pytest.mark.parametrize("case", ["long bucket", "gaps of 32768", "16 at j = 1", "tail"])
def test_far_screen_edges_match_pallas(case):
    """A bucket longer than k, gaps of 32768 and 32769, screens of 16 at
    j = 1 and windows that run past the end: the port's plain version and
    the far kernel's walk with its three exits (another hash, a gap over
    32768, a 16-byte screen) give tpuzlib's keys; far_trips counts the
    walk's compares."""
    k = 24
    data, (sh, perm) = _far_case(case)
    best = np.zeros(len(data), np.int32)
    want, got = _far_both(data, best, [(sh, perm)], k)
    _eq(want, got)
    pad = np.concatenate([data, np.zeros(16, np.uint8)])
    h, sp = sh.numpy(), perm.numpy()
    walk, trips = np.zeros(len(data), np.int64), np.zeros(len(data), np.int64)
    for i in np.flatnonzero(h == 5):
        for j in range(1, k + 1):
            d = sp[i] - sp[i - j]
            if i < j or h[i - j] != h[i] or d > 32768:
                break
            trips[i] += 1
            sc = _screen16(pad, sp[i], sp[i - j])
            if sc >= 3:
                walk[sp[i]] = max(walk[sp[i]], sc << 16 | (0xFFFF - d))
            if sc == 16:
                break
    _eq(want, walk)
    _eq(trips, tscreen.far_trips(sh, perm, torch.from_numpy(data), k))
    assert want.any()
    if case == "gaps of 32768":
        assert list(trips[h == 5]) == [0, 1, 1, 0, 1]
    if case == "long bucket":
        assert trips.max() == k


@pytest.mark.parametrize("B", [1, 3])
def test_screen_inputs_are_what_the_kernels_take(B):
    """On the card the screen wrappers take only contiguous int32 arrays of
    the flat batch's length (and its bytes); a batch of one chunk is the
    case where a view would not be."""
    N = 1024
    data = torch.from_numpy(testing.corpus("text", B * (tdd.CTX + N), B))
    cv = torch.full((B,), 100, dtype=torch.int32)
    for t in (*td3.window_words(data), *td3.batch_layout(B, tdd.CTX, N, cv, cv)):
        assert t.dtype == torch.int32 and t.is_contiguous() and t.shape == data.shape


def test_probe_hash_matches_jax():
    data = testing.corpus("text", 5000, 3)
    jws, tws = _windows(data)
    for nbytes, bits in td3.PROBES:
        _eq(jd3._hash_k(jnp, jws[0], jws[1], nbytes, bits), td3._hash_k(tws[0], tws[1], nbytes, bits))


@pytest.mark.parametrize("n", [1024, 5000, 66000])
def test_segment_parse_plain_matches_pallas_and_xla(n):
    rng = np.random.default_rng(n)
    room = 1024 - np.arange(n) % 1024
    step = np.minimum(np.where(rng.random(n) < 0.6, 1, rng.integers(3, 259, n)), room)
    step = step.astype(np.int32)
    want_p = jparse.segment_parse_pallas(jax, jnp, jnp.asarray(step), n)
    want_x = jdd.segment_parse_xla(jax, jnp, jnp.asarray(step), n)
    got = tparse.segment_parse(torch.from_numpy(step), n)
    assert got.dtype == torch.bool
    _eq(want_p, got)
    _eq(want_x, tdd.segment_parse_xla(torch.from_numpy(step), n))


def test_segment_parse_n_valid():
    n, n_valid = 5000, 3333
    step = np.random.default_rng(5).integers(1, 9, n).astype(np.int32)
    step = np.minimum(step, 1024 - np.arange(n) % 1024).astype(np.int32)
    want = jdd.segment_parse_xla(jax, jnp, jnp.asarray(step), n_valid)
    _eq(want, tparse.segment_parse(torch.from_numpy(step), n_valid))


def _random_tables(rng, B):
    """Per-chunk code tables with lengths 0..15 and codes below 2^length."""
    lbits = rng.integers(0, 16, (B, 286)).astype(np.int32)
    dbits = rng.integers(0, 16, (B, 30)).astype(np.int32)
    lcodes = (rng.integers(0, 1 << 15, (B, 286)) & ((1 << lbits) - 1)).astype(np.int32)
    dcodes = (rng.integers(0, 1 << 15, (B, 30)) & ((1 << dbits) - 1)).astype(np.int32)
    return lcodes, lbits, dcodes, dbits


def test_pack_fields_plain_matches_pallas():
    rng = np.random.default_rng(11)
    B, T = 2, 4096
    litlen = rng.integers(0, 512, (B, T))
    is_match = rng.random((B, T)) < 0.5
    tok = litlen | (is_match << 9) | (rng.integers(0, 1 << 15, (B, T)) << 10)
    tok[:, ::7] = 256
    tok[:, 1::5] = 511
    tok[:, 2::9] = rng.integers(0, 256, tok[:, 2::9].shape)  # plain literals
    tok = tok.astype(np.int32)
    lcodes, lbits, dcodes, dbits = _random_tables(rng, B)

    nrows = B * T // jd3.PACK_TILE
    planes_l = jd3._byte_planes(jnp, jnp.asarray(lcodes.astype(np.uint32)), jnp.asarray(lbits), 384)
    planes_d = jd3._byte_planes(jnp, jnp.asarray(dcodes.astype(np.uint32)), jnp.asarray(dbits), 32)
    lo, hi, nb = jd3._pack_fields_kernel(nrows, T // jd3.PACK_TILE // 8, True)(
        jnp.asarray(tok.astype(np.uint32).reshape(nrows, jd3.PACK_TILE)), planes_l, planes_d
    )
    got = td3.pack_fields_plain(*(torch.from_numpy(a) for a in (tok, lcodes, lbits, dcodes, dbits)))
    for want, g in zip((lo, hi, nb), got):
        assert g.dtype == torch.int32
        _eq(np.asarray(want).view(np.int32).reshape(B, T), g)


def _torch_tail(lo_t, hi_t, nb_t, hdr_vals, hdr_bits, lasts, out_words):
    """The encoder's bit pack as it ran before pack_words took it in: the
    torch ops after the field kernel, on its (lo, hi, nb)."""
    B = lo_t.shape[0]
    m32 = 0xFFFFFFFF
    lo_t, hi_t = lo_t.to(torch.int64) & m32, hi_t.to(torch.int64) & m32
    all_lo = torch.cat([(4 | lasts.to(torch.int64))[:, None], hdr_vals, lo_t], 1)
    all_hi = torch.cat([torch.zeros(B, 1 + td3.HDRF, dtype=torch.int64), hi_t], 1)
    all_nb = torch.cat([torch.full((B, 1), 3, dtype=torch.int64), hdr_bits, nb_t.to(torch.int64)], 1)
    offsets = torch.cumsum(all_nb, 1) - all_nb
    total_bits = offsets[:, -1] + all_nb[:, -1]
    idx = offsets >> 5
    sh = offsets & 31
    p0 = (all_lo << sh) & m32
    p1 = (torch.where(sh > 0, all_lo >> (32 - sh), 0) | (all_hi << sh)) & m32
    p2 = torch.where(sh > 0, all_hi >> (32 - sh), 0)
    wb = torch.arange(B, dtype=torch.int64)[:, None] * out_words
    widx = torch.cat([wb + torch.clamp(idx + s, max=out_words - 1) for s in range(3)], 1)
    words = torch.zeros(B * out_words, dtype=torch.int64)
    words.index_add_(0, widx.reshape(-1), torch.cat([p0, p1, p2], 1).reshape(-1))
    return (words & m32).reshape(B, out_words), total_bits


@pytest.mark.parametrize("case", sorted(testing.PACK_CASES))
def test_pack_words_plain_matches_torch_tail(case):
    """pack_words' plain version against the torch ops it replaced, on the
    fields of the tokens up to each row's EOB, and against a host bit
    writer where a row's bits fit its words."""
    arrays, out_words = testing.pack_words_inputs(case)
    tok, lcodes, lbits, dcodes, dbits, eob_at, hdr_vals, hdr_bits, lasts = map(torch.from_numpy, arrays)
    words, total_bits = td3.pack_words(*map(torch.from_numpy, arrays), out_words)
    assert words.dtype == total_bits.dtype == torch.int64
    B, T = tok.shape
    upto_eob = torch.where(torch.arange(T)[None, :] > eob_at[:, None], 511, tok)
    lo, hi, nb = td3.pack_fields_plain(upto_eob, lcodes, lbits, dcodes, dbits)
    want_words, want_total = _torch_tail(lo, hi, nb, hdr_vals, hdr_bits, lasts, out_words)
    assert torch.equal(words, want_words) and torch.equal(total_bits, want_total)
    fits = 0
    for b in range(B):
        total = int(total_bits[b])
        if total > 32 * out_words:
            continue
        fits += 1
        field = (lo[b].numpy().astype(np.uint32).astype(np.uint64)
                 | hi[b].numpy().astype(np.uint32).astype(np.uint64) << np.uint64(32))
        sink = BitSink()
        sink.push_scalar(4 | int(lasts[b]), 3)
        sink.push(hdr_vals[b].numpy(), hdr_bits[b].numpy())
        sink.push(field, nb[b].numpy())
        want = sink.flush(final=True)[0]
        got = words[b].numpy().astype("<u4").view(np.uint8)[: (total + 7) // 8]
        assert got.tobytes() == want.tobytes()
    assert fits >= 1


def test_sym_fields_matches_jax():
    rng = np.random.default_rng(2)
    litlen = rng.integers(0, 512, 20000).astype(np.int32)
    dist = rng.integers(0, 32769, 20000).astype(np.int32)
    m = rng.random(20000) < 0.5
    want = jdd.sym_fields_v2(jax, jnp, jnp.asarray(litlen), jnp.asarray(dist), jnp.asarray(m))
    got = tdd.sym_fields_v2(*(torch.from_numpy(a) for a in (litlen, dist, m)))
    for a, b in zip(want, got):
        _eq(a, b)


def _freq_rows(nsym, seed):
    """Tie-heavy, one-symbol, two-symbol, all-zero and skewed rows."""
    rng = np.random.default_rng(seed)
    rows = [
        rng.integers(0, 4, nsym),  # many ties
        np.zeros(nsym, np.int64),
        np.eye(1, nsym, nsym - 1, dtype=np.int64)[0] * 9,  # one symbol, not the first two
        np.eye(1, nsym, 0, dtype=np.int64)[0] * 5,  # one symbol among the forced two
        np.where(np.arange(nsym) % 3 == 0, 7, 0),
        (rng.zipf(1.3, nsym) % 100000).astype(np.int64),
        rng.integers(0, 1 << 20, nsym),
        np.where(rng.random(nsym) < 0.1, rng.integers(1, 3, nsym), 0),
    ]
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("nsym,max_len", [(286, 15), (19, 7)])
def test_package_merge_and_codes_match_vmap(nsym, max_len):
    freqs = _freq_rows(nsym, nsym)
    want_len = jax.vmap(lambda f: jhuff.package_merge_device(jax, jnp, f, max_len))(jnp.asarray(freqs))
    got_len = thuff.package_merge_device(torch.from_numpy(freqs), max_len)
    _eq(want_len, got_len)
    want_codes = jax.vmap(lambda l: jhuff.canonical_codes_device(jax, jnp, l))(want_len)
    _eq(want_codes, thuff.canonical_codes_device(got_len))
    # every row with a symbol in use is a complete code (Kraft sum 1)
    lens = got_len.numpy().astype(np.int64)
    for row in lens[(lens > 0).any(1)]:
        assert sum(2.0 ** -int(x) for x in row if x) == 1.0
