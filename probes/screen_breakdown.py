"""The match screens before and after their redesign, on one CUDA card.

    python3 probes/screen_breakdown.py OLD_ROOT

OLD_ROOT is a checkout whose screens take window words and leave the far
screen's keys in the sorted domain (the commit before the redesign,
unpacked with `git archive`).  Builds its
tpuzlib_torch/kernels/csrc/screen.cu and this checkout's at R = 2, 4 and
8 positions a near-screen thread (one nvcc each, all at once, into
probes/_build/), then times, on the first batch of the 32 MiB mixed
corpus at level 6 (256 KiB chunks, batch 8, as chip_smoke.py's phase A),
in turns (old, new, new, old):

  near   the near-screen kernels alone, as bare launches;
  far    the far stage: the earlier one (window gathers, the
         permutation's cast, two launches, two scatters back to position
         order and two maxima) against two in-place launches, and then
         the earlier two launches alone on windows gathered beforehand;
  match  match_lengths_v3 as a whole: the earlier screening, then the
         same d-chain and extension, against the port's.

Every call of the in-place far screen starts from the near keys, as in
match_lengths_v3: a copy restores them first, and that copy, timed alone
(`copy_ms`), is taken off the far screen's times.

Then it times patched copies of the current kernels (where the time
goes): the near screen walking on three bytes without screening any
candidate, and without its walk; the far screen without its walk,
without its window gathers, without either, and writing its keys back
by a load and a store instead of atomicMax.  One more copy counts
the groups of four candidates in which the near screen's walk screens.

It requires equal outputs, prints the share of near candidates whose
first three bytes match, the far walk's mean trips a row per probe
(far_trips) and the near kernel's time at each R, then one JSON object
a line.  The patched copies are for timing only.  Each time is the mean
of 10 calls after 3 warm-ups: device ms from CUDA events with every call
queued behind a sleep kernel (launch overhead hidden), host ms of each
call with the card idle.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from tpuzlib_torch import testing  # noqa: E402
from tpuzlib_torch.kernels import _build, screen  # noqa: E402
from tpuzlib_torch.kernels import deflate_device3 as d3  # noqa: E402
from tpuzlib_torch.kernels.deflate_device import CTX  # noqa: E402

CSRC = os.path.join(ROOT, "tpuzlib_torch", "kernels", "csrc")
OUT = os.path.join(HERE, "_build")
LEVEL, CHUNK, BATCH = 6, 1 << 18, 8
SWEEP = (2, 4, 8)
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P]  # both earlier entry points
CLOCK_HZ = 1.98e9  # the H100's boost clock: sleep cycles a second


NEAR_R = "constexpr int kNearR = 4;"
NEAR_LOOP = "  for (int g = (i0 - 1) >> 2; g >= (lo - base) >> 2; --g) {"
SCREENS = "    if (!any) continue;\n"
FAR_WALK = "  for (int j = 1; j <= k; j += 2) {"
GATHER = "load_window(data, q, total)"
WRITE_BACK = "static_cast<unsigned>(total)) {\n    atomicMax(best + me.y, key);\n"
# variant -> [(text in screen.cu, its replacement)]
PATCHES = {
    "near: three-byte walk, no screens": [(SCREENS, "    best[0] += any;\n    continue;\n")],
    "near: no walk": [(NEAR_LOOP, "  for (int g = (i0 - 1) >> 2; g < 0; --g) {")],
    "near: count screened groups": [(SCREENS, SCREENS + "    atomicAdd(key + total, 1);\n")],
    "far: no walk": [(FAR_WALK, "  for (int j = 1; j < 0; j += 2) {")],
    "far: no gathers": [(GATHER, "make_uint4(q, 0, 0, 0)")],
    "far: neither": [(FAR_WALK, "  for (int j = 1; j < 0; j += 2) {"),
                     (GATHER, "make_uint4(q, 0, 0, 0)")],
    "far: write-back by load and store": [(WRITE_BACK, "static_cast<unsigned>(total) && "
                                                       "key > best[me.y]) {\n"
                                                       "    best[me.y] = key;\n")],
}


def nvcc(src: str, out: str, *flags: str) -> subprocess.Popen:
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", out, src])


def entry(lib: str, name: str, argtypes):
    fn = getattr(ctypes.CDLL(os.path.join(OUT, lib)), name)
    fn.restype, fn.argtypes = ctypes.c_int, argtypes
    return fn


def call(fn, *args) -> None:
    ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    err = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit("screen_breakdown: launch failed (%d)" % err)


def cuda_ms(fn, reps: int = 10) -> tuple[float, float]:
    """(device ms, host ms) of one fn() call, means over `reps` after 3
    warm-ups.  The device time is taken with the card held in a sleep
    kernel while the host queues all `reps` calls, so launch overhead
    does not stretch it; the host time is each call's own, card idle."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * reps * host_s + 1e-3) * CLOCK_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_s * 1e3


def turns(old, new, new_less=(0.0, 0.0)) -> dict:
    """Device and host times of old and new in the order old, new, new,
    old; `new_less` (device ms, host ms) is taken off new's."""
    t = [cuda_ms(f) for f in (old, new, new, old)]
    dev, host = [x[0] for x in t], [x[1] for x in t]
    new_dev = [dev[1] - new_less[0], dev[2] - new_less[0]]
    return {"old_ms": [dev[0], dev[3]], "new_ms": new_dev,
            "speedup": (dev[0] + dev[3]) / sum(new_dev),
            "old_host_ms": [host[0], host[3]],
            "new_host_ms": [host[1] - new_less[1], host[2] - new_less[1]]}


def patched(text: str, patches, name: str, source: str = "screen.cu") -> subprocess.Popen:
    """Compile `text`, this checkout's `source` (in its csrc/), with
    `patches` applied, as probes/_build/lib<name>.so."""
    for old, new in patches:
        if old not in text:
            raise SystemExit("%r no longer in %s" % (old, source))
        text = text.replace(old, new)
    path = os.path.join(OUT, name + ".cu")
    with open(path, "w") as f:
        f.write(text)
    return nvcc(path, os.path.join(OUT, "lib%s.so" % name), "-I", CSRC)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("screen_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    old_src = os.path.join(sys.argv[1], "tpuzlib_torch", "kernels", "csrc", "screen.cu")
    procs = [nvcc(old_src, os.path.join(OUT, "libscreen_old.so"))]
    text = open(os.path.join(CSRC, "screen.cu")).read()
    procs += [patched(text, [(NEAR_R, "constexpr int kNearR = %d;" % r)], "screen_r%d" % r)
              for r in SWEEP]
    procs += [patched(text, patches, "variant%d" % i) for i, patches in enumerate(PATCHES.values())]
    _build.lib()  # the port's own library, for match_lengths_v3
    if any(p.wait() for p in procs):
        raise SystemExit("screen_breakdown: a build failed")
    old_near = entry("libscreen_old.so", "tz_near_screen", OLD_ARGS)
    old_far = entry("libscreen_old.so", "tz_far_screen", OLD_ARGS)
    new_near = {r: entry("libscreen_r%d.so" % r, "tz_near_screen", _build._ARGTYPES["tz_near_screen"])
                for r in SWEEP}

    corpus = testing.mixed(32 << 20, seed=1)
    bufs, cv, nv, _ = (torch.from_numpy(a).cuda()
                       for a in d3.batch_arrays(corpus, range(BATCH), CHUNK, BATCH))
    data = bufs.reshape(-1)
    lim16, limit, mincand, chid = d3.batch_layout(BATCH, CTX, CHUNK, cv, nv)
    total = data.numel()
    p = d3.LEVELS_V3[LEVEL]
    nd = p["nd"]
    ws = d3.window_words(data)

    # near: bare launches
    key_old, key_new = torch.empty_like(mincand), torch.empty_like(mincand)
    run_old = lambda: call(old_near, *ws, mincand, lim16, key_old, total, nd)  # noqa: E731
    run_new = {r: (lambda r=r: call(new_near[r], data, mincand, lim16, key_new, total, nd))
               for r in SWEEP}
    run_old()
    unequal = []
    for r in SWEEP:
        key_new.fill_(-1)
        run_new[r]()
        if not torch.equal(key_old, key_new):
            unequal.append("near at R = %d" % r)
    # candidates (p, p - d), d = 1..nd, that a position may take, and the
    # share of them whose first three bytes match
    pos = torch.arange(total, device=data.device)
    b3 = torch.cat([data.long(), data.new_zeros(2).long()])
    first3 = b3[:total] | b3[1 : total + 1] << 8 | b3[2:] << 16
    taken = matched = 0
    for d in range(1, nd + 1):
        ok = (pos - d >= mincand) & (lim16 >= 3)
        taken += int(ok.sum())
        matched += int((ok[d:] & (first3[d:] == first3[:-d])).sum())
    print(json.dumps({"stage": "near", "nd": nd, "R": 4, "equal": not unequal,
                      "candidates": taken, "three_byte_share": matched / taken,
                      **turns(run_old, run_new[4])}), flush=True)
    sweep = {r: [cuda_ms(run_new[r])[0] for _ in range(2)] for r in SWEEP}
    print(json.dumps({"stage": "near R sweep", "ms": {str(r): t for r, t in sweep.items()}}),
          flush=True)

    # far: the stage after the near screen, from the same keys
    probes = [(*d3.probe_rows(ws, mincand, chid, nb, bits), p["k%d" % nb]) for nb, bits in d3.PROBES]
    trips = {"k%d" % k: float(screen.far_trips(sh, sp, data, k).float().mean())
             for sh, sp, k in probes}

    def far_old():
        best = key_old
        for sh, perm, k in probes:
            sws = [w[perm] for w in ws]
            fkeys = torch.empty_like(sh)
            call(old_far, sh, perm.to(torch.int32), *sws, fkeys, total, k)
            fpos = torch.empty_like(fkeys)
            fpos[perm] = fkeys
            best = torch.maximum(best, fpos)
        return best

    # the in-place far screen from the near keys on every call, less the
    # copy that restores them
    best_new = torch.empty_like(key_old)
    fresh = lambda: best_new.copy_(key_old)  # noqa: E731
    copy = cuda_ms(fresh)

    def far_new():
        fresh()
        for sh, perm, k in probes:
            screen.far_screen(sh, perm, data, best_new, k)
        return best_new

    equal = torch.equal(far_old(), far_new())
    unequal += [] if equal else ["far"]
    print(json.dumps({"stage": "far", "k": [k for *_, k in probes], "equal": equal,
                      "mean_trips": trips, "copy_ms": copy[0], "copy_host_ms": copy[1],
                      **turns(far_old, far_new, copy)}), flush=True)
    # the two far kernels alone: the earlier ones on windows gathered beforehand
    gathered = [(sh, perm.to(torch.int32), [w[perm] for w in ws], torch.empty_like(sh), k)
                for sh, perm, k in probes]

    def far_kernels_old():
        for sh, sp32, sws, fkeys, k in gathered:
            call(old_far, sh, sp32, *sws, fkeys, total, k)

    print(json.dumps({"stage": "far kernels alone", **turns(far_kernels_old, far_new, copy)}),
          flush=True)

    # match_lengths_v3 as a whole
    def match_old():
        ws = d3.window_words(data)
        best = torch.empty_like(mincand)
        call(old_near, *ws, mincand, lim16, best, total, nd)
        for nbytes, bits in d3.PROBES:
            sh, perm = d3.probe_rows(ws, mincand, chid, nbytes, bits)
            sws = [w[perm] for w in ws]
            fkeys = torch.empty_like(sh)
            call(old_far, sh, perm.to(torch.int32), *sws, fkeys, total, p["k%d" % nbytes])
            fpos = torch.empty_like(fkeys)
            fpos[perm] = fkeys
            best = torch.maximum(best, fpos)
        return d3.lengths_from_keys(best, ws, lim16, limit, chid)

    def match_new():
        return d3.match_lengths_v3(data, lim16, limit, mincand, chid, LEVEL)

    equal = all(torch.equal(a, b) for a, b in zip(match_old(), match_new()))
    unequal += [] if equal else ["match_lengths_v3"]
    print(json.dumps({"stage": "match_lengths_v3", "equal": equal,
                      **turns(match_old, match_new)}), flush=True)

    # where the time goes: patched copies of the current kernels
    counted = torch.zeros(total + 1, dtype=torch.int32, device=data.device)
    for i, name in enumerate(PATCHES):
        lib = ctypes.CDLL(os.path.join(OUT, "libvariant%d.so" % i))
        if name.startswith("near"):
            fn = lib.tz_near_screen
            fn.restype, fn.argtypes = ctypes.c_int, _build._ARGTYPES["tz_near_screen"]
            run = lambda fn=fn: call(fn, data, mincand, lim16, counted, total, nd)  # noqa: E731
        else:
            fn = lib.tz_far_screen
            fn.restype, fn.argtypes = ctypes.c_int, _build._ARGTYPES["tz_far_screen"]

            def run(fn=fn):
                fresh()
                for sh, perm, k in probes:
                    call(fn, sh, perm, data, best_new, total, k)
        less = 0.0 if name.startswith("near") else copy[0]
        row = {"variant": name, "ms": [cuda_ms(run)[0] - less for _ in range(2)]}
        if name == "near: count screened groups":
            counted.zero_()
            run()
            torch.cuda.synchronize()
            row["screened_groups_a_thread"] = int(counted[total]) / -(-total // 4)
        print(json.dumps(row), flush=True)
    if unequal:
        raise SystemExit("screen_breakdown: outputs differ: %s" % ", ".join(unequal))
    return 0


if __name__ == "__main__":
    sys.exit(main())
