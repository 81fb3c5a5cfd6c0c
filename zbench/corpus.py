"""Seeded byte corpora for the benchmark's traffic.

A frozen copy of tpuzlib_torch/testing.py's `corpus` at commit 8f9712c
(the port's test data), kept here so that the port's tests may change
their data without moving the benchmark's inputs.  The benchmark never
imports tpuzlib_torch.testing.  (testing.mixed draws each piece's kind
from the seed, so two seeds compress differently: entries.blend takes
its place.)

  text      English-like words drawn from a Zipf law (long matches, lazy rule)
  vertices  float32 vertex records of a smooth mesh (binary, short matches)
  runs      byte runs and periodic patterns (the d-chain and long matches)
  random    uniform random bytes (the stored-block fallback)

`seed` is anything numpy.random.default_rng takes.
"""

from __future__ import annotations

import numpy as np

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

