"""The port's forward step, as tpuzlib's __graft_entry__.entry() gives it.

entry(device) returns (fn, example_args): fn is the batched
dynamic-Huffman encoder at level 6, two 64 KiB chunks a batch, and the
args are one batch of seeded English-like text on `device`, laid out as
tpuzlib's entry() lays out its text (the first chunk without history,
the second with the first's last 32 KiB as its window, and last).
"""

from __future__ import annotations

import torch

from . import testing
from .kernels.deflate_device3 import batch_arrays, make_encode_batch_v3, out_words_for

CHUNK, BATCH, LEVEL = 1 << 16, 2, 6


def entry(device="cuda"):
    """Returns (fn, example_args); fn(*example_args) gives (words,
    total_bits, ok) for the batch."""
    fn = make_encode_batch_v3(LEVEL, CHUNK, BATCH, out_words_for(CHUNK))
    text = testing.corpus("text", BATCH * CHUNK, seed=0)
    arrays = batch_arrays(text, range(BATCH), CHUNK, BATCH)
    return fn, tuple(torch.from_numpy(a).to(device) for a in arrays)
