"""Entry drivers, each a module named by a traffic file's "entry".  Each
gives:

  program(api, config, device)  the timed call, from the port's module `api`
  Driver(config, traffic, seed, device)
                                the client's inputs, made in set-up; its
                                warm(fn) calls fn on them once, and its
                                call(fn) runs one timed call and returns
                                (bytes in, bytes out), keeping what the
                                check reads
  check(config, traffic, driver)
                                after the window: ({number: (value, limit)},
                                {quantity: value}) from the plain reference

and may give:

  TIMES                         the entry point its calls time, one of
                                readers.ENTRIES, which the metric files
                                key on; by default the module's own name
  control(api, config, device)  its plain reference with one guarantee
                                broken, in place of reference/control.py's
                                control of the entry point it times

A cell whose streams or answers need a driver of their own (another
framing, a decode over many members) adds one under a new name that
TIMES an existing entry point, and reports that entry point's metrics.
"""

from __future__ import annotations

import numpy as np

from .. import corpus


def blend(data: dict, n: int, seed) -> list:
    """n bytes of a configuration's data as pieces: data["blend"] gives each
    kind of corpus.KINDS its share, data["piece_bytes"] the size of a
    piece.  Every seed gets the same pieces: the same count of each kind
    (largest remainders), the same sizes and the same bytes (the j-th
    piece of a kind is made from its kind and j); the seed draws their
    order, so the work does not change from seed to seed."""
    m = max(1, n // data["piece_bytes"])
    want = {k: share * m for k, share in data["blend"].items()}
    counts = {k: int(x) for k, x in want.items()}
    for k in sorted(want, key=lambda k: counts[k] - want[k])[: m - sum(counts.values())]:
        counts[k] += 1
    kinds = list(corpus.KINDS)
    named = [(k, j) for k in data["blend"] for j in range(counts[k])]
    sizes = [n // m] * (m - 1) + [n - (n // m) * (m - 1)]
    pieces = [corpus.corpus(k, size, [kinds.index(k), j]) for (k, j), size in zip(named, sizes)]
    return [pieces[i] for i in np.random.default_rng(seed).permutation(m)]
