"""crc_unpack and vec_cond_while before and after their redesign, on one
CUDA card.

    python3 probes/unpack_breakdown.py OLD_ROOT

OLD_ROOT is a checkout whose crc32_probe.cu converts each bit with
__uint2bfloat16_rn (bf16) or sums a byte at a time (i32), and whose
inflate_prims.cu runs vec_cond_while through device memory every step
(the commit before the redesign, unpacked with `git archive`).  Builds
OLD_ROOT's two sources alone, and copies of this checkout's
inflate_prims.cu and crc32_probe.cu changed by the text patches of
PATCHES and ROW_PATCHES, into probes/_build/ (one nvcc each, all at
once), then prints, after the card's name and power limit, one JSON
object a line:

  rows   the row kernel in each mode (crc_rowsum's sum, crc_unpack's u8,
         i32 and bf16) on 256 MiB of seeded bytes in rows of 1,024:
         device ms of OLD_ROOT's kernel and this checkout's in turns old,
         new, new, old (bare launches queued behind a sleep kernel), each
         output held to the other, and in bf16 beside a patched copy of
         crc32_probe.cu (ROW_PATCHES), its output held to new's:
           hadd2   the forms' planes, bf16 1.0 where the bit is set (a
                   mask and a multiply), added by __hadd2, where the
                   kernel adds its power-of-two planes by one FMA;
         then the wrapper's ms (crc_unpack, or for OLD_ROOT the same
         output allocation and ctypes call; CUDA events over 10 calls
         after 3) in turns;
  while  vec_cond_while at 128 and 8,192 lanes (the tools' and the TPU
         decode's cursors; route "regs"), at the shared-memory limit
         ("smem") and at 100,000 lanes ("global"), on the tools' input
         (lanes from 0 to 99: 64 steps, the cap): device ms in turns old,
         new, new, old, outputs held to each other, beside patched
         copies of the register route, outputs held to new's but votes':
           votes   the same loop with the adds taken out: 64 votes and
                   nothing else, the steps' floor;
           select  the first design, `v += v < kLimit` and a compare and
                   an or a lane for the vote;
           if      the add in C++ (`if (v < 100) ++v`), not in PTX;
           vote_before
                   the vote from the lanes before the add;
           r16, r32
                   16 or 32 lanes a thread (8,192 lanes in 512 or 256
                   threads: fewer warps at each vote);
         then the wrapper's ms over 200 calls after 20, in turns.
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
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from tpuzlib_torch.kernels import _build, crc32_probe as cp, gather_probe as gp  # noqa: E402
from tpuzlib_torch.kernels import inflate_prims as ip  # noqa: E402

CSRC = os.path.join(ROOT, "tpuzlib_torch", "kernels", "csrc")
OUT = os.path.join(HERE, "_build")
CLOCK_HZ = 1.98e9  # the H100's boost clock: sleep cycles a second

# the variants of inflate_prims.cu: [(text in the file, its replacement)]
_ADD_ASM = ("      asm(\"{\\n\\t.reg .pred p;\\n\\tsetp.lt.s32 p, %0, %1;\\n\\t@p add.s32 %0, %0, 1;\\n\\t}\"\n"
            "          : \"+r\"(v[r])\n          : \"n\"(kLimit));\n")
_LOOP = ("    int32_t m = kLimit;\n#pragma unroll\n    for (int r = 0; r < R; ++r) {\n" + _ADD_ASM +
         "      m = min(m, v[r]);\n    }\n    below = m < kLimit;\n")


def _regs(r: int) -> list:
    """Every register-route launch with r lanes a thread (8,192 lanes in
    8192 / r threads)."""
    return [("    const int r = per <= 1 ? 1 : per <= 2 ? 2 : per <= 4 ? 4 : 8;\n",
             "    const int r = %d;\n" % r),
            ("      default: vec_cond_while_regs_kernel<8><<<1, threads, 0, s>>>(xs, lanes, o); break;\n",
             "      default: vec_cond_while_regs_kernel<%d><<<1, threads, 0, s>>>(xs, lanes, o); break;\n"
             % r)]


PATCHES = {
    # the vote alone: no lane moves, so a lane below the limit keeps every
    # step's vote true until the cap
    "votes": [(_ADD_ASM, "")],
    # the first design: `v += v < kLimit` and a compare and an or a lane
    # for the vote (ptxas: a compare, an add, a select and a copy a lane)
    "select": [(_LOOP, "    below = 0;\n#pragma unroll\n    for (int r = 0; r < R; ++r) {\n"
                       "      v[r] += v[r] < kLimit;\n      below |= v[r] < kLimit;\n    }\n")],
    # the add in C++, which ptxas makes an add, a select and a copy
    "if": [(_ADD_ASM, "      if (v[r] < kLimit) ++v[r];\n")],
    # the vote from the lanes before the add (a lane below 99 is below 100
    # after it), so the two are independent
    "vote_before": [(_LOOP, "    int32_t m = kLimit;\n#pragma unroll\n    for (int r = 0; r < R; ++r) {\n"
                            "      m = min(m, v[r]);\n" + _ADD_ASM +
                     "    }\n    below = m < kLimit - 1;\n")],
    # fewer warps at the vote: 16 or 32 lanes a thread
    "r16": _regs(16),
    "r32": _regs(32),
}
# the variants of crc32_probe.cu's bf16 accumulator
ROW_PATCHES = {
    # the forms' planes, bf16 1.0 where the bit is set (a mask and a
    # multiply), added by __hadd2
    "hadd2": [("    const uint32_t lo = spread_lo(w) << 7, hi = spread_hi(w) << 7;\n"
               "#pragma unroll\n"
               "    for (int i = 0; i < 8; ++i) {\n"
               "      const __nv_bfloat162 scale = as_bf162(bf16_pow2_scale(i));\n"
               "      a = __hfma2(as_bf162(bf16_pow2_plane(lo, i)), scale, a);\n"
               "      b = __hfma2(as_bf162(bf16_pow2_plane(hi, i)), scale, b);\n"
               "    }\n",
               "    const uint32_t lo = spread_lo(w), hi = spread_hi(w);\n"
               "#pragma unroll\n"
               "    for (int i = 0; i < 8; ++i) {\n"
               "      a = __hadd2(a, as_bf162(bf16_plane(lo, i)));\n"
               "      b = __hadd2(b, as_bf162(bf16_plane(hi, i)));\n"
               "    }\n")],
}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_ARGS = {"tz_crc_rowsum": [_P, _L, _I, _I, _P, _P], "tz_vec_cond_while": [_P, _I, _P, _P]}
ROW_MODES = {"sum": 0, **cp.MODES}


def nvcc(src: str, name: str) -> subprocess.Popen:
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o",
                             os.path.join(OUT, "lib%s.so" % name), src])


def entry(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    f = getattr(ctypes.CDLL(os.path.join(OUT, "lib%s.so" % name)), fn)
    f.restype, f.argtypes = _I, argtypes
    return f


def device_ms(fn, reps: int = 10) -> float:
    """Device ms of one fn() call: the mean of `reps` bare calls after 3,
    queued behind a sleep kernel so that their host time does not
    stretch them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((reps * 100e-6 + 1e-3) * CLOCK_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, reps: int, warmup: int) -> float:
    """ms of one fn() call from CUDA events around `reps` calls after
    `warmup`, host time included (the wrapper's time)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def caller(fn, *args):
    ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    stream = _build._raw_stream(torch.cuda.current_device())

    def go():
        err = fn(*ptrs, stream)
        if err:
            raise SystemExit("unpack_breakdown: a launch was refused (%d)" % err)
    return go


def turns(go: dict, label: dict, timer=device_ms, key="") -> dict:
    """old and new in turns old, new, new, old, their speedup the ratio of
    old's two times to new's; then each other entry of `go` once."""
    t = [timer(go[k]) for k in ("old", "new", "new", "old")]
    row = {key + "old_ms": [t[0], t[3]], key + "new_ms": [t[1], t[2]],
           key + "speedup": (t[0] + t[3]) / (t[1] + t[2])}
    for k in go:
        if k not in ("old", "new"):
            row[key + k + "_ms"] = timer(go[k])
    label.update(row)
    return label


def held(outs: dict, what) -> None:
    torch.cuda.synchronize()
    for k, o in outs.items():
        if not torch.equal(o, outs["new"]):
            raise SystemExit("unpack_breakdown: %s differs from new at %s" % (k, what))


def rows(old, variants, dev) -> None:
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    big = torch.randint(0, 256, (256 << 20,), dtype=torch.uint8, device=dev, generator=g)
    x = big.view(-1, 1024)
    nb = x.shape[0]
    new = _build.lib.fns["tz_crc_rowsum"]
    for mode, code in ROW_MODES.items():
        libs = {"old": old, "new": new, **(variants if mode == "bf16" else {})}
        outs = {k: torch.empty(nb, dtype=torch.int32, device=dev) for k in libs}
        go = {k: caller(f, x, nb, 1024, code, outs[k]) for k, f in libs.items()}
        for f in go.values():
            f()
        held(outs, mode)
        row = turns(go, {"probe": "rows", "mode": mode, "MiB": 256, "row": 1024})

        def old_wrapper(code=code):
            out = torch.empty(nb, dtype=torch.int32, device=dev)
            caller(old, x, nb, 1024, code, out)()
            return out

        new_wrapper = ((lambda: cp.crc_rowsum(x)) if mode == "sum"
                       else (lambda mode=mode: cp.crc_unpack(x, mode)))
        turns({"old": old_wrapper, "new": new_wrapper}, row,
              lambda f: call_ms(f, 10, 3), "wrapper_")
        print(json.dumps(row), flush=True)


def loops(old, variants, dev) -> None:
    rng = np.random.default_rng(18)
    staged = gp.staged_words(dev)
    for lanes in (128, ip.REG_LANES, staged, 100_000):
        route = ip.while_route(lanes, staged)
        code = ip.WHILE_ROUTES.index(route)
        x = torch.from_numpy(rng.integers(0, 100, (1, lanes), dtype=np.int32)).to(dev)
        steps = min(64, 100 - int(x.min()))
        outs = {k: torch.empty_like(x) for k in ("old", "new")}
        new = _build.lib.fns["tz_vec_cond_while"]
        go = {"old": caller(old, x, lanes, outs["old"]),
              "new": caller(new, x, lanes, code, outs["new"])}
        for f in go.values():
            f()
        held(outs, lanes)
        if route == "regs":
            for k, f in variants.items():
                outs[k] = torch.empty_like(x)
                go[k] = caller(f, x, lanes, code, outs[k])
            for f in go.values():
                f()
            held({k: o for k, o in outs.items() if k != "votes"}, lanes)
        row = turns(go, {"probe": "while", "lanes": lanes, "route": route, "steps": steps})
        row.update({k.replace("_ms", "_ns_a_step"): [1e6 * t / max(steps, 1) for t in v]
                    if isinstance(v, list) else 1e6 * v / max(steps, 1)
                    for k, v in row.items() if k.endswith("_ms")})

        def old_wrapper():
            out = torch.empty_like(x)
            caller(old, x, lanes, out)()
            return out

        turns({"old": old_wrapper, "new": lambda: ip.vec_cond_while(x)}, row,
              lambda f: call_ms(f, 200, 20), "wrapper_")
        print(json.dumps(row), flush=True)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("unpack_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    old_csrc = os.path.join(sys.argv[1], "tpuzlib_torch", "kernels", "csrc")
    procs = [nvcc(os.path.join(old_csrc, "crc32_probe.cu"), "rows_old"),
             nvcc(os.path.join(old_csrc, "inflate_prims.cu"), "while_old")]
    for source, prefix, patch_sets in (("inflate_prims.cu", "while_", PATCHES),
                                       ("crc32_probe.cu", "rows_", ROW_PATCHES)):
        with open(os.path.join(CSRC, source)) as f:
            text = f.read()
        for name, patches in patch_sets.items():
            src = text
            for old, new in patches:
                if src.count(old) != 1:
                    raise SystemExit("%r is not once in %s" % (old, source))
                src = src.replace(old, new)
            path = os.path.join(OUT, prefix + name + ".cu")
            with open(path, "w") as f:
                f.write(src)
            procs.append(nvcc(path, prefix + name))
    _build.lib()
    if any(p.wait() for p in procs):
        raise SystemExit("unpack_breakdown: nvcc failed")
    dev = torch.device("cuda", torch.cuda.current_device())
    rows(entry("rows_old", "tz_crc_rowsum", OLD_ARGS["tz_crc_rowsum"]),
         {k: entry("rows_" + k, "tz_crc_rowsum", _build._ARGTYPES["tz_crc_rowsum"])
          for k in ROW_PATCHES}, dev)
    loops(entry("while_old", "tz_vec_cond_while", OLD_ARGS["tz_vec_cond_while"]),
          {k: entry("while_" + k, "tz_vec_cond_while", _build._ARGTYPES["tz_vec_cond_while"])
           for k in PATCHES}, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
