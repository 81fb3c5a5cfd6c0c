"""tpuzlib_torch.entry's forward step against tpuzlib's encoder, on the CPU.

tpuzlib's own entry() reads a corpus file this tree does not hold, so
the test builds tpuzlib's program as that entry() does
(make_encode_batch_v3(6, 65536, 2, out_words)) and gives both programs
the port's example batch.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tpuzlib.kernels import deflate_device3 as jd3
from tpuzlib_torch import entry as tentry

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)


def test_entry_matches_tpuzlib():
    fn, args = tentry.entry(device="cpu")
    bufs, cv, nv, lv = (a.numpy() for a in args)
    assert bufs.shape == (2, (1 << 15) + (1 << 16)) and bufs.dtype == np.uint8
    assert cv.tolist() == [0, 1 << 15] and nv.tolist() == [1 << 16] * 2 and lv.tolist() == [0, 1]
    # tpuzlib's entry(): the second chunk's window is the first's tail
    assert np.array_equal(bufs[1, : 1 << 15], bufs[0, -(1 << 15):])
    out_words = min((1 << 16) + 4, ((1 << 16) * 10) // 32 + 64)
    jfn = jd3.make_encode_batch_v3(6, 1 << 16, 2, out_words)
    words, bits, ok = (np.asarray(x).astype(np.int64) for x in jfn(*map(jnp.asarray, (bufs, cv, nv, lv))))
    gw, gb, gok = (x.numpy().astype(np.int64) for x in fn(*args))
    assert np.array_equal(gb, bits) and np.array_equal(gok, ok) and ok.all()
    assert np.array_equal(gw, words)
