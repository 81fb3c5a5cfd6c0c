"""Where the speculative host inflate's time goes, beside the sequential
Inflater, on the host of one CUDA card.

    python3 probes/speculative_breakdown.py [--reps 3]

On chip_smoke's J1 stream (python zlib's level-1 stream of the seeded
32 MiB mixed corpus seven times: 224 MiB out, 89 MB in), host seconds of
each piece of inflate_parallel_container (median of --reps calls after a
warm-up), in the order it runs them:

  discover    the find_block_start calls (the native candidate filter,
              then the python probe and confirm on its candidates);
  tokenize    the segments on the process pool (get_executor()), each
              tape's output length counted there;
  expand      the segment-parallel expansion (expand_segments);
  adler       the trailer's Adler-32 on the card (upload and one
              adler32_scalar launch);
  whole       inflate_parallel_container(device="cuda") end to end;
  inflater    the sequential Inflater on the same stream;
  serial      the segments tokenized one after another (what the pool
              saves);
  expand_host the one serial expansion of the joined tapes (tpuzlib's
              step 4, what expand_segments replaces).

Then the dispatch's size threshold: for level-1 streams of the corpus
cut to --sizes MiB of output, the seconds of inflate_parallel_container
(device="cuda") and of the Inflater (median of --reps after a warm-up).

Prints the card's name and power limit, the host's usable cores, then one
JSON object for the pieces and one for the sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def median_s(fn, reps: int):
    """fn()'s result and the median host seconds of `reps` calls after one
    warm-up (each call ends in a synchronize)."""
    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sizes", type=int, nargs="*", default=[8, 16, 32, 40, 64])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("speculative_breakdown: no CUDA device", file=sys.stderr)
        return 1
    import tpuzlib_torch
    from tpuzlib_torch import testing
    from tpuzlib_torch.api.checksums import adler32
    from tpuzlib_torch.codec.deflate_engine import _ncores, get_executor
    from tpuzlib_torch.codec.expand import expand_host, expand_segments, tape_out_len
    from tpuzlib_torch.parallel import speculative as sp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    corpus = testing.mixed(32 << 20, seed=1)
    big = np.tile(corpus, 7)
    wire = zlib.compress(big.tobytes(), 1)
    buf = np.frombuffer(wire, np.uint8)[2:-4]
    segments = max(1, min(_ncores(), len(buf) // (1 << 16)))
    r = args.reps
    s = {}

    def discover():
        bounds = [0]
        for k in range(1, segments):
            found = sp.find_block_start(buf, len(buf) * k // segments)
            if found is not None and found > bounds[-1]:
                bounds.append(found)
        return bounds

    def work(a):
        litlen, dist, end, _ = sp._tokenize_range(buf, *a)
        return litlen, dist, tape_out_len(litlen, dist), end

    bounds, s["discover"] = median_s(discover, r)
    ranges = list(zip(bounds, bounds[1:] + [len(buf) * 8]))
    tapes, s["tokenize"] = median_s(lambda: list(get_executor().map(work, ranges)), r)
    _, s["serial"] = median_s(lambda: [work(a) for a in ranges], r)
    chained = all(tapes[i][3] == bounds[i + 1] for i in range(len(bounds) - 1))
    empty = np.empty(0, np.uint8)
    out, s["expand"] = median_s(lambda: expand_segments([t[:3] for t in tapes], empty,
                                                        _ncores()), r)
    adl, s["adler"] = median_s(lambda: adler32(out, device="cuda"), r)
    whole, s["whole"] = median_s(lambda: sp.inflate_parallel_container(wire, device="cuda"), r)

    def inflater(w):
        inf = tpuzlib_torch.Inflater()
        parts = inf.append(w)
        return np.concatenate(parts) if inf.finish().success else None

    seq, s["inflater"] = median_s(lambda: inflater(wire), r)
    litlen = np.concatenate([t[0] for t in tapes])
    dist = np.concatenate([t[1] for t in tapes])
    joined, s["expand_host"] = median_s(lambda: expand_host(litlen, dist, empty), r)
    ok = (out.tobytes() == whole.tobytes() == seq.tobytes() == joined.tobytes() == big.tobytes()
          and adl == zlib.adler32(big.tobytes()))
    print(json.dumps({"card": smi, "cores": _ncores(), "segments": segments,
                      "boundaries_found": len(bounds) - 1, "chained": chained,
                      "tokens": int(len(litlen)), "bytes_in": len(wire), "bytes_out": len(big),
                      "equal": ok, "reps": r, "s": s,
                      "whole_MBps": len(big) / s["whole"] / 1e6,
                      "inflater_MBps": len(big) / s["inflater"] / 1e6}), flush=True)
    del out, whole, seq, joined, litlen, dist, tapes

    sizes = []
    for mib in args.sizes:
        data = big[: mib << 20].tobytes()
        w = zlib.compress(data, 1)
        got, spec_s = median_s(lambda: sp.inflate_parallel_container(w, device="cuda"), r)
        seq, seq_s = median_s(lambda: inflater(w), r)
        same = got.tobytes() == seq.tobytes() == data
        ok = ok and same
        sizes.append({"MiB_out": mib, "bytes_in": len(w), "equal": same,
                      "speculative_s": spec_s, "inflater_s": seq_s, "speedup": seq_s / spec_s})
    print(json.dumps({"card": smi, "cores": _ncores(), "reps": r, "sizes": sizes}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
