"""The segment parse and the bit pack before and after their redesign, on
one CUDA card.

    python3 probes/encode_tail_breakdown.py OLD_ROOT

OLD_ROOT is a checkout whose parse walks each segment on one thread and
whose pack kernel writes (lo, hi, nb) for torch ops to pack (the commit
before the redesign, unpacked with `git archive`).  Builds its
tpuzlib_torch/kernels/csrc/parse.cu and pack_fields.cu (one nvcc each,
at once, into probes/_build/) and this checkout's kernels, then times, on
the first batch of the 32 MiB mixed corpus at level 6 (256 KiB chunks,
batch 8, as chip_smoke.py's phase A), in turns (old, new, new, old):

  parse        both parse kernels as bare launches on the batch's own step
               tape (parse_tape), and on the synthetic tape that
               chip_smoke.py timed before (70% steps of 1, the rest
               uniform in 3..258);
  pack         the pack stage: the earlier field kernel and the torch ops
               that packed its fields into words, against pack_words;
  pack parts   the earlier field kernel alone, and its torch ops alone.

Then it times patched copies of the current kernels (where the time
goes): the parse returning at once (launch and blocks only), staging and
the mask alone, with the span exits, with the exits and entries; the
pack's tile-sum kernel alone, and its word kernel alone (on the sums of a
whole call).  The patched copies are for timing only.

It requires equal outputs and prints the card's name and power limit,
then one JSON object a line.  Each time is the mean of 10 calls after 3
warm-ups: device ms from CUDA events with every call queued behind a
sleep kernel (launch overhead hidden), host ms of each call with the card
idle.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from screen_breakdown import OUT, call, cuda_ms, entry, nvcc, patched, turns  # noqa: E402

from tpuzlib_torch import testing  # noqa: E402
from tpuzlib_torch.kernels import _build, parse  # noqa: E402
from tpuzlib_torch.kernels import deflate_device3 as d3  # noqa: E402
from tpuzlib_torch.kernels.deflate_device import CTX, SEG, segment_parse_xla  # noqa: E402

LEVEL, CHUNK, BATCH = 6, 1 << 18, 8
_P, _I = ctypes.c_void_p, ctypes.c_int
M32 = 0xFFFFFFFF
CSRC = os.path.join(os.path.dirname(HERE), "tpuzlib_torch", "kernels", "csrc")

RETURN = "  if (base >= n) return;"
EXITS = "  for (int k = m - 1; k >= 0; --k) {"
ENTRIES = "  for (int e = 0; e < len; e = static_cast<int>(at(e) >> 16)) {"
MARKS = "  for (int k = entry - lo; entry >= 0 && k < m;) {"
SUMS = "  pack_sums_kernel<<<grid, kThreads, 0, st>>>(a);"
WORDS = "  pack_words_kernel<<<grid, kThreads, 0, st>>>(a);"
NO_EXITS = (EXITS, "  for (int k = -1; k >= 0; --k) {")
NO_ENTRIES = (ENTRIES, ENTRIES.replace("e = 0;", "e = len;"))
NO_MARKS = (MARKS, MARKS.replace("entry >= 0 &&", "entry < -1 &&"))
# variant -> (source, [(text in it, its replacement)])
PATCHES = {
    "parse: returns at once": ("parse", [(RETURN, "  if (base >= 0) return;")]),
    "parse: staging and mask": ("parse", [NO_EXITS, NO_ENTRIES, NO_MARKS]),
    "parse: + exits": ("parse", [NO_ENTRIES, NO_MARKS]),
    "parse: + exits + entries": ("parse", [NO_MARKS]),
    "pack: tile sums alone": ("pack_fields", [(WORDS, "")]),
    "pack: words kernel alone": ("pack_fields", [(SUMS, "")]),
}


def torch_tail(lo_t, hi_t, nb_t, hdr_vals, hdr_bits, lasts, out_words):
    """The earlier encoder's bit pack: the torch ops after its field
    kernel, on the kernel's (lo, hi, nb)."""
    B = lo_t.shape[0]
    i64 = dict(dtype=torch.int64, device=lo_t.device)
    lo_t, hi_t = lo_t.to(torch.int64) & M32, hi_t.to(torch.int64) & M32
    all_lo = torch.cat([(4 | lasts.to(torch.int64))[:, None], hdr_vals, lo_t], 1)
    all_hi = torch.cat([torch.zeros(B, 1 + d3.HDRF, **i64), hi_t], 1)
    all_nb = torch.cat([torch.full((B, 1), 3, **i64), hdr_bits, nb_t.to(torch.int64)], 1)
    offsets = torch.cumsum(all_nb, 1) - all_nb
    total_bits = offsets[:, -1] + all_nb[:, -1]
    idx = offsets >> 5
    sh = offsets & 31
    p0 = (all_lo << sh) & M32
    p1 = (torch.where(sh > 0, all_lo >> (32 - sh), 0) | (all_hi << sh)) & M32
    p2 = torch.where(sh > 0, all_hi >> (32 - sh), 0)
    wb = torch.arange(B, **i64)[:, None] * out_words
    widx = torch.cat([wb + torch.clamp(idx + s, max=out_words - 1) for s in range(3)], 1)
    words = torch.zeros(B * out_words, **i64)
    words.index_add_(0, widx.reshape(-1), torch.cat([p0, p1, p2], 1).reshape(-1))
    return (words & M32).reshape(B, out_words), total_bits


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("encode_tail_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    old_csrc = os.path.join(sys.argv[1], "tpuzlib_torch", "kernels", "csrc")
    procs = [nvcc(os.path.join(old_csrc, name + ".cu"), os.path.join(OUT, "lib%s_old.so" % name))
             for name in ("parse", "pack_fields")]
    procs += [patched(open(os.path.join(CSRC, src + ".cu")).read(), edits, "tail_variant%d" % i,
                      src + ".cu")
              for i, (src, edits) in enumerate(PATCHES.values())]
    _build.lib()
    if any(p.wait() for p in procs):
        raise SystemExit("encode_tail_breakdown: a build failed")
    old_parse = entry("libparse_old.so", "tz_segment_parse", _build._ARGTYPES["tz_segment_parse"])
    old_pack = entry("libpack_fields_old.so", "tz_pack_fields", [_P] * 8 + [_I, _I, _P])

    corpus = testing.mixed(32 << 20, seed=1)
    args = tuple(torch.from_numpy(a).cuda()
                 for a in d3.batch_arrays(corpus, range(BATCH), CHUNK, BATCH))
    bufs, cv, nv, lasts = args
    unequal = []

    # parse: the path's own tape, and the synthetic one
    _, step, _ = d3.parse_tape(BATCH, CTX, CHUNK, bufs, cv, nv, LEVEL)
    n = step.numel()
    rng = np.random.default_rng(3)
    room = SEG - np.arange(n) % SEG
    synth = np.where(rng.random(n) < 0.7, 1, rng.integers(3, 259, n))
    tapes = {"path": step.reshape(-1).contiguous(),
             "synthetic": torch.from_numpy(np.minimum(synth, room).astype(np.int32)).cuda()}
    for name, tape in tapes.items():
        mask_old = torch.empty(n, dtype=torch.bool, device=tape.device)
        run_old = lambda: call(old_parse, tape, mask_old, n, n, SEG)  # noqa: E731
        run_new = lambda: parse.segment_parse(tape, n)  # noqa: E731
        run_old()
        want = segment_parse_xla(tape, n)
        equal = torch.equal(mask_old, want) and torch.equal(run_new(), want)
        unequal += [] if equal else ["parse on the %s tape" % name]
        walks = want.reshape(-1, SEG).sum(1)
        print(json.dumps({"stage": "parse", "tape": name, "equal": equal,
                          "mean_walk": float(walks.float().mean()), "longest_walk": int(walks.max()),
                          **turns(run_old, run_new)}), flush=True)

    # pack: the field kernel and its torch ops, against pack_words
    ow = d3.out_words_for(CHUNK)
    enc = lambda stage: d3.make_encode_batch_v3(LEVEL, CHUNK, BATCH, ow, stage=stage)  # noqa: E731
    tok, M, _ = enc("compact")(*args)
    ll, dl, lcodes, dcodes = enc("trees")(*args)
    hdr_vals, hdr_bits, _ = enc("header")(*args)
    eob_at = torch.clamp(M.long(), max=tok.shape[1] - 1)
    tables = (tok, lcodes.int(), ll, dcodes.int().contiguous(), dl.contiguous())
    B, T = tok.shape
    fields = [torch.empty_like(tok) for _ in range(3)]

    def old_fields():
        call(old_pack, *tables, *fields, T, B)
        return fields

    def pack_old():
        return torch_tail(*old_fields(), hdr_vals, hdr_bits, lasts, ow)

    def pack_new():
        return d3.pack_words(*tables, eob_at, hdr_vals, hdr_bits, lasts, ow)

    equal = all(torch.equal(a, b) for a, b in zip(pack_old(), pack_new()))
    unequal += [] if equal else ["pack"]
    print(json.dumps({"stage": "pack", "equal": equal, "tokens": int((eob_at + 1).sum()),
                      "slots": tok.numel(), **turns(pack_old, pack_new)}), flush=True)
    lo, hi, nb = (f.clone() for f in old_fields())
    parts = {"old field kernel": cuda_ms(old_fields),
             "old torch ops": cuda_ms(lambda: torch_tail(lo, hi, nb, hdr_vals, hdr_bits, lasts, ow))}
    print(json.dumps({"stage": "pack parts",
                      **{k: {"ms": v[0], "host_ms": v[1]} for k, v in parts.items()}}), flush=True)

    # where the time goes: patched copies, on persistent buffers
    words = torch.empty(B, ow, dtype=torch.int64, device=tok.device)
    total = torch.empty(B, dtype=torch.int64, device=tok.device)
    sums = torch.empty(B * (T // d3.PACK_TILE + 2), dtype=torch.int32, device=tok.device)
    pack_args = (*tables, eob_at, hdr_vals, hdr_bits, lasts, words, total, sums, T, B, ow)
    call(_build.lib().tz_pack_words, *pack_args)  # the sums of a whole call
    tape, mask = tapes["path"], torch.empty(n, dtype=torch.bool, device=tok.device)
    for i, (name, (src, _)) in enumerate(PATCHES.items()):
        lib = "libtail_variant%d.so" % i
        if src == "parse":
            fn = entry(lib, "tz_segment_parse", _build._ARGTYPES["tz_segment_parse"])
            run = lambda fn=fn: call(fn, tape, mask, n, n, SEG)  # noqa: E731
        else:
            fn = entry(lib, "tz_pack_words", _build._ARGTYPES["tz_pack_words"])
            run = lambda fn=fn: call(fn, *pack_args)  # noqa: E731
        print(json.dumps({"variant": name, "ms": [cuda_ms(run)[0] for _ in range(2)]}), flush=True)
    if unequal:
        raise SystemExit("encode_tail_breakdown: outputs differ: %s" % ", ".join(unequal))
    return 0


if __name__ == "__main__":
    sys.exit(main())
