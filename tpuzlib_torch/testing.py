"""Seeded test data and state hand-over helpers.

`corpus(kind, n, seed)` makes n bytes of one kind of data from a numpy
seed; `mixed(n, seed)` concatenates pieces of every kind.  The kinds
cover what the encoder must handle:

  text      English-like words drawn from a Zipf law (long matches, lazy rule)
  vertices  float32 vertex records of a smooth mesh (binary, short matches)
  runs      byte runs and periodic patterns (the d-chain and long matches)
  random    uniform random bytes (the stored-block fallback)

`zlib_stream` compresses with python zlib (levels, strategies, sync
flushes) and `inflate_streams` makes one raw stream of every block kind
for the decoder's tests; `fibonacci_bytes` gives zlib's Huffman codes
their longest lengths, and `dynamic_block` writes a block by hand with
any code lengths, also ones zlib never writes.  `pack_words_inputs` makes
the bit pack's inputs for the cases of PACK_CASES.
`device_deflater_from_numpy` builds a DeviceDeflater from streaming state
held in numpy, so a stream begun elsewhere can be finished by the port.
`counters_since` gives the event counters a call moved.
`device_route` and `inflate_device_route` call deflate()'s and
inflate()'s device routes at any size; `no_native` switches the native
library off for a block.
"""

from __future__ import annotations

import contextlib
import zlib

import numpy as np
import torch

from .codec import huffman
from .codec.bitsink import BitSink
from .codec.tables import CLC_ORDER, DIST_EXTRA, LENGTH_EXTRA
from .kernels.deflate_device3 import DeviceDeflater
from .utils import trace

_LETTERS = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
_LETTER_P = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8,
                      2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.15, 0.15, 0.1, 0.07])
_BLOCK = 1 << 20


def _text(n: int, rng: np.random.Generator) -> np.ndarray:
    nvocab = 5000
    wlen = np.clip(rng.geometric(0.22, nvocab), 1, 14)
    chars = rng.choice(_LETTERS, int(wlen.sum()), p=_LETTER_P / _LETTER_P.sum())
    wstart = np.cumsum(wlen) - wlen
    # every word carries one trailing separator: mostly a space, sometimes
    # punctuation or a line break
    seps = np.frombuffer(b" ,.\n", np.uint8)
    zipf = 1.0 / (np.arange(nvocab) + 2.7) ** 1.07
    zipf /= zipf.sum()
    out = []
    have = 0
    while have < n:
        m = _BLOCK // 5
        idx = rng.choice(nvocab, m, p=zipf)
        sep = rng.choice(seps, m, p=[0.88, 0.06, 0.04, 0.02])
        L = wlen[idx] + 1
        off = np.cumsum(L) - L
        word = np.repeat(np.arange(m), L)
        k = np.arange(int(L.sum())) - off[word]
        is_sep = k == wlen[idx][word]
        src = np.minimum(wstart[idx][word] + k, len(chars) - 1)
        piece = np.where(is_sep, sep[word], chars[src]).astype(np.uint8)
        out.append(piece)
        have += len(piece)
    return np.concatenate(out)[:n]


def _vertices(n: int, rng: np.random.Generator) -> np.ndarray:
    # records of (x, y, z, nx, ny, nz, u, v) float32 on a sphere grid
    m = n // 32 + 1
    w = int(rng.integers(64, 512))
    i = np.arange(m)
    u = (i % w) / w
    v = (i // w) / max(1, m // w)
    th = 2 * np.pi * u
    ph = np.pi * np.clip(v, 0, 1)
    r = 1.0 + 0.01 * np.round(rng.standard_normal(m) * 16) / 16
    nx, ny, nz = np.cos(th) * np.sin(ph), np.sin(th) * np.sin(ph), np.cos(ph)
    rec = np.stack([r * nx, r * ny, r * nz, nx, ny, nz, u, v], 1).astype(np.float32)
    return rec.view(np.uint8).reshape(-1)[:n].copy()


def _runs(n: int, rng: np.random.Generator) -> np.ndarray:
    out = []
    have = 0
    while have < n:
        kind = rng.integers(3)
        if kind == 0:  # a run of one byte
            piece = np.full(int(rng.geometric(1 / 200)), rng.integers(256), np.uint8)
        elif kind == 1:  # a periodic pattern
            period = rng.integers(256, size=int(rng.integers(1, 97)), dtype=np.uint8)
            piece = np.resize(period, int(rng.integers(200, 6000)))
        else:  # a short stretch of noise
            piece = rng.integers(256, size=int(rng.integers(1, 40)), dtype=np.uint8)
        out.append(piece)
        have += len(piece)
    return np.concatenate(out)[:n]


def _random(n: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, 256, n, dtype=np.uint8)


KINDS = {"text": _text, "vertices": _vertices, "runs": _runs, "random": _random}


def corpus(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """n bytes (uint8) of one kind of data, made from `seed`."""
    return KINDS[kind](n, np.random.default_rng(seed))


def mixed(n: int, seed: int = 0) -> np.ndarray:
    """n bytes of pieces (64 KiB to 1 MiB) of every kind, made from `seed`."""
    rng = np.random.default_rng(seed)
    kinds = list(KINDS)
    out = []
    have = 0
    while have < n:
        kind = kinds[rng.choice(len(kinds), p=[0.45, 0.25, 0.2, 0.1])]
        size = int(rng.integers(1 << 16, 1 << 20))
        out.append(corpus(kind, size, int(rng.integers(1 << 31))))
        have += size
    return np.concatenate(out)[:n]


def zlib_stream(data: np.ndarray, level: int = 6, wbits: int = 15,
                strategy: int = zlib.Z_DEFAULT_STRATEGY, flush_every: int = 0,
                mem_level: int = 8) -> bytes:
    """python zlib's compression of `data` (wbits < 0: a raw stream); with
    flush_every, a Z_SYNC_FLUSH after every so many bytes (empty stored
    markers, and the small blocks zlib writes before them).  A block holds
    at most 2^(mem_level + 6) symbols."""
    c = zlib.compressobj(level, zlib.DEFLATED, wbits, mem_level, strategy)
    step = flush_every or max(1, len(data))
    parts = []
    for off in range(0, len(data), step):
        parts.append(c.compress(data[off : off + step].tobytes()))
        if flush_every:
            parts.append(c.flush(zlib.Z_SYNC_FLUSH))
    return b"".join(parts) + c.flush()


def device_route(data, device="cpu", **options) -> np.ndarray:
    """deflate()'s device route (api/deflate_api._deflate_device) on `data`
    at any size, with deflate()'s options: the bytes deflate() gives on a
    card from DEVICE_MIN_BYTES."""
    from .api.deflate_api import Deflater, _deflate_device
    from .common import u8_view

    return _deflate_device(u8_view(data), Deflater(**options), device)


def inflate_device_route(data, device="cpu"):
    """inflate()'s device route (api/inflate_api._inflate_device) on `data`
    at any size, raw streams too (not a zlib stream with FDICT, which the
    route rule never sends there): the bytes inflate() gives on a card for
    a stream its route rule sends there, or None where that route leaves
    the stream to the host route (counted as inflate() counts it)."""
    from .api.inflate_api import _inflate_device
    from .common import u8_view

    return _inflate_device(u8_view(data), device)


def members_device_route(data, index=None, device="cpu"):
    """inflate_members()'s device route on `data` at any size (the batched
    decode on `device`, its plain versions on the CPU, then the host
    engine for each member it does not prove): the bytes inflate_members()
    gives on a card, with its verdicts; where the members' sizes are
    unknown, the host route."""
    from .api.inflate_api import _inflate_members, member_index
    from .common import u8_view

    view = u8_view(data)
    members = member_index(view, index)
    return _inflate_members(view, members, device, members is not None)


@contextlib.contextmanager
def no_native():
    """The native library switched off inside the block (every call site
    takes tpuzlib's numpy branch; native/bindings.set_native), and back
    to its state before on the way out."""
    from .native import bindings

    before = bindings.set_native(False)
    try:
        yield
    finally:
        bindings.set_native(before)


def inflate_streams(n: int = 1 << 16, seed: int = 0) -> dict:
    """name -> (raw DEFLATE stream uint8, its bytes uint8) for every kind
    of block the device inflate meets, about n bytes of input each:
    python zlib levels 1 / 6 / 9 (dynamic blocks), Z_FIXED (fixed
    blocks), random bytes (stored blocks), sync flushes, stored runs
    hidden between Huffman blocks, and the port's own encoder."""
    from .api.deflate_api import deflate

    rng = np.random.default_rng(seed)
    sub = lambda: int(rng.integers(1 << 31))  # noqa: E731
    text = corpus("text", n, sub())
    blend = np.concatenate([text[: n // 2], corpus("vertices", n // 4, sub()),
                            corpus("runs", n - n // 2 - n // 4, sub())])
    hidden = np.concatenate([text[: 3 * n // 8], corpus("random", n // 4, sub()),
                             np.zeros(n // 8, np.uint8), text[n // 2 : n // 2 + n // 4]])
    raw = lambda data, level=6, **kw: np.frombuffer(  # noqa: E731
        zlib_stream(data, level, -15, **kw), np.uint8)
    return {
        "L1": (raw(blend, 1, mem_level=5), blend),
        "L6": (raw(blend, 6), blend),
        "L9": (raw(blend, 9), blend),
        "fixed": (raw(blend, strategy=zlib.Z_FIXED), blend),
        "stored": (raw(hidden[3 * n // 8 : 5 * n // 8]), hidden[3 * n // 8 : 5 * n // 8]),
        "sync flush": (raw(blend, flush_every=n // 8), blend),
        "hidden stored": (raw(hidden, mem_level=6), hidden),
        "port encoder": (device_route(blend, format="raw"), blend),
    }


def fibonacci_bytes(k: int = 24, seed: int = 0) -> np.ndarray:
    """k distinct byte values, the i-th most frequent F(k - i) times
    (Fibonacci numbers), shuffled: compressed with zlib.Z_HUFFMAN_ONLY,
    every block's literal code reaches zlib's longest length, 15 bits."""
    fib = [1, 1]
    while len(fib) < k:
        fib.append(fib[-1] + fib[-2])
    rng = np.random.default_rng(seed)
    data = np.repeat(rng.permutation(256)[:k].astype(np.uint8), fib[::-1])
    rng.shuffle(data)
    return data


def dynamic_block(litlens, distlens, tokens) -> np.ndarray:
    """A raw DEFLATE stream of one final dynamic block with code lengths
    `litlens` (257 to 286 of them) and `distlens` (1 to 30), whose header
    writes every length with a 4-bit code, and then `tokens`: (lit/len
    symbol, distance symbol) pairs, the distance read only after a length
    symbol, every extra bit 0; the end of block follows."""
    litlens, distlens = np.asarray(litlens, np.int64), np.asarray(distlens, np.int64)
    sink = BitSink()
    for value, nbits in ((1, 1), (2, 2), (len(litlens) - 257, 5), (len(distlens) - 1, 5),
                         (15, 4)):  # BFINAL, dynamic, HLIT, HDIST, HCLEN = 19
        sink.push_scalar(value, nbits)
    # code-length symbols 0..15 each take 4 bits: symbol L's code is L
    for sym in CLC_ORDER:
        sink.push_scalar(4 if sym < 16 else 0, 3)
    lens = np.concatenate([litlens, distlens])
    sink.push(huffman._bit_reverse(lens, np.full(len(lens), 4)), np.full(len(lens), 4))

    # the codes as the stream holds them, first bit lowest
    lrev, drev = (huffman._bit_reverse(huffman.canonical_codes(n), n) for n in (litlens, distlens))
    for lsym, dsym in [*tokens, (256, 0)]:
        sink.push_scalar(int(lrev[lsym]), int(litlens[lsym]))
        if lsym > 256:
            sink.push_scalar(0, int(LENGTH_EXTRA[lsym - 257]))
            sink.push_scalar(int(drev[dsym]), int(distlens[dsym]))
            sink.push_scalar(0, int(DIST_EXTRA[dsym]))
    return sink.flush(final=True)[0]


def hand_made_blocks(seed: int = 0) -> dict:
    """name -> a raw stream of one dynamic block that zlib would not write,
    each a valid stream:

      one-bit distance code  a single distance code of one bit (an
                             incomplete code, which RFC 1951 allows), the
                             literals at 8 and 9 bits, matches of 3 at
                             distance 1;
      15-bit codes           lit/len and distance codes of every length
                             from 1 to 15 bits, each drawn as often as any
                             other (more than the tape's six bits a
                             symbol)."""
    rng = np.random.default_rng(seed)
    # 254 literals of 8 bits; literals 254, 255, the EOB and length 3 of 9
    lit = np.zeros(258, np.int64)
    lit[:254], lit[254:] = 8, 9
    toks = [(int(s), 0) for s in rng.integers(0, 256, 400)]
    for i in rng.choice(np.arange(1, 400), 60, replace=False):
        toks[i] = (257, 0)
    one_bit = dynamic_block(lit, [1], toks)
    # one code of each length 1..14 and two of 15, in each tree: a complete
    # code; the literal 'a', then lengths and literals alternate
    lsyms = [97, 257, 98, 258, 99, 259, 100, 260, 101, 261, 102, 262, 103, 256, 0, 285]
    lit = np.zeros(286, np.int64)
    lit[lsyms] = list(range(1, 15)) + [15, 15]
    dist = np.r_[np.arange(1, 15), 15, 15]
    toks = [(97, 0)] * 260  # history for the longest distance, 257
    toks += [(lsyms[i], int(d)) for i, d in zip(rng.integers(0, 16, 2000),
                                               rng.integers(0, 16, 2000)) if lsyms[i] != 256]
    return {"one-bit distance code": one_bit, "15-bit codes": dynamic_block(lit, dist, toks)}


# name -> (slots a row, out_words, each row's EOB slot, each row's last
# flag, every field 48 bits wide)
PACK_CASES = {
    "EOB at the cap": (4096, 8192, [4095, 4095], [0, 1], False),
    "empty row": (4096, 8192, [0, 2000, 4095], [1, 0, 1], False),
    "past the output cap": (3000, 300, [2999, 100], [1, 0], False),
    "48-bit fields": (3000, 5000, [2999, 10], [0, 1], True),
    "one row, two tiles": (2048, 4096, [2047], [1], False),
}


def pack_words_inputs(name: str, seed: int = 0):
    """The inputs of deflate_device3.pack_words for PACK_CASES[name], as
    numpy arrays (tok, lcodes, lbits, dcodes, dbits, eob_at, hdr_vals,
    hdr_bits, lasts), and out_words.  Tokens are literals, and matches of
    every length and distance; the slots after the EOB hold noise, which
    pack_words takes as pads.  With 48-bit fields every token is a match
    of length 250 at distance 20001 and every code is 15 bits long."""
    T, out_words, eob_at, lasts, wide = PACK_CASES[name]
    B = len(eob_at)
    rng = np.random.default_rng(seed)
    match = rng.integers(3, 259, (B, T)) | 1 << 9 | rng.integers(0, 1 << 15, (B, T)) << 10
    tok = np.where(rng.random((B, T)) < 0.5, match, rng.integers(0, 256, (B, T)))
    lbits, dbits = rng.integers(0, 16, (B, 286)), rng.integers(0, 16, (B, 30))
    if wide:
        tok[:] = 250 | 1 << 9 | 20000 << 10
        lbits[:], dbits[:] = 15, 15
    lcodes = rng.integers(0, 1 << 15, (B, 286)) & ((1 << lbits) - 1)
    dcodes = rng.integers(0, 1 << 15, (B, 30)) & ((1 << dbits) - 1)
    for b, e in enumerate(eob_at):
        tok[b, e] = 256
        tok[b, e + 1 :] = rng.integers(0, 1 << 24, T - e - 1)
    hdr_bits = rng.integers(0, 15, (B, 338))
    hdr_vals = rng.integers(0, 1 << 14, (B, 338)) & ((1 << hdr_bits) - 1)
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    return ((i32(tok), i32(lcodes), i32(lbits), i32(dcodes), i32(dbits), np.asarray(eob_at, np.int64),
             hdr_vals.astype(np.int64), hdr_bits.astype(np.int64), i32(lasts)), out_words)


def device_deflater_from_numpy(level, chunk, batch, ctx, ctx_valid, pending,
                               carry_val, carry_bits, device="cuda") -> DeviceDeflater:
    """A DeviceDeflater resuming a stream: window `ctx` (CTX bytes, the last
    `ctx_valid` of them real), `pending` input not yet encoded, and the
    stream's sub-byte remainder (carry_val, carry_bits)."""
    d = DeviceDeflater(level=level, chunk=chunk, batch=batch, device=device)
    d._ctx = torch.from_numpy(np.array(ctx, dtype=np.uint8)).to(d.device)
    d._ctx_valid = int(ctx_valid)
    d._pending = np.array(pending, dtype=np.uint8)
    d._sink = BitSink(int(carry_val), int(carry_bits))
    return d


def counters_since(before: dict) -> dict:
    """The event counters (utils/trace.get_counters()) that moved since the
    snapshot `before`, each by how much."""
    now = trace.get_counters()
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}
