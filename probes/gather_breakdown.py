"""take_along and flat_gather before and after their redesign, on one CUDA
card.

    python3 probes/gather_breakdown.py OLD_ROOT

OLD_ROOT is a checkout whose gather_probe.cu has one thread an output
element (the commit before the redesign, unpacked with `git archive`).
Builds its tpuzlib_torch/kernels/csrc/gather_probe.cu alone, and patched
copies of this checkout's, into probes/_build/ (one nvcc each, all at
once), then at chip_smoke.py's phase-I shapes (the tools' and the encoder
batch's; the rows past the staged limit too):

  device  device ms of OLD_ROOT's kernel and this checkout's, as bare
          launches queued behind a sleep kernel, in turns old, new, new,
          old, each output held to the other;
  steady  µs a call of the wrappers in steady state, host and card
          together (the mean of 200 calls after 20, in turns: this
          checkout's take_along / flat_gather, the PyTorch call computing
          the same function, again, again), and the device ms of each
          patched copy beside this checkout's kernel:
            nc_no_allocate  the gathers through the read-only cache
                            with ld.global.nc.L1::no_allocate;
            blocks_128      the read-only-cache take_along in blocks of
                            128 threads (twice the blocks) instead of 256;
            ldg_scalar      the read-only-cache designs an element a
                            thread (no 16-byte streams; the staged ones
                            keep theirs);
            ldg_grid_x2     the read-only-cache designs with twice the
                            blocks (16 of 256 threads an SM).

Prints the card's name and power limit, then one JSON object a line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from tpuzlib_torch.kernels import _build, gather_probe as gp  # noqa: E402

CSRC = os.path.join(ROOT, "tpuzlib_torch", "kernels", "csrc")
OUT = os.path.join(HERE, "_build")
CLOCK_HZ = 1.98e9  # the H100's boost clock: sleep cycles a second
LDG = "  const int32_t v = __ldg(Axis == 0 ? x + static_cast<Off>(k) * xc + c : xrow + k);\n"
LDG_NA = ("  const int32_t* p = Axis == 0 ? x + static_cast<Off>(k) * xc + c : xrow + k;\n"
          "  int32_t v;\n"
          "  asm volatile(\"ld.global.nc.L1::no_allocate.b32 %0, [%1];\" : \"=r\"(v) : \"l\"(p));\n")
FLAT_LDG = "    return __ldg(table + flat_index(i, T));\n"
FLAT_LDG_NA = ("    int32_t v;\n"
               "    asm volatile(\"ld.global.nc.L1::no_allocate.b32 %0, [%1];\" : \"=r\"(v)"
               " : \"l\"(table + flat_index(i, T)));\n"
               "    return v;\n")
BLOCK = "    const int tx = pow2_at_least(units, 1, kThreads), ty = kThreads / tx;\n"
TAKE_VEC = "  const bool vec = ic % 4 == 0 && aligned16(idx) && aligned16(out);\n"
FLAT_VEC = "  const bool vec = aligned16(idx) && aligned16(out);\n"
TAKE_GRID = "(kSmThreads / kThreads);\n    long long gx"
FLAT_GRID = "(staged ? blocks_an_sm(*c, threads, bytes, 2) : kSmThreads / threads);"
# variant -> [(text in gather_probe.cu, its replacement)]
PATCHES = {
    "nc_no_allocate": [(LDG, LDG_NA), (FLAT_LDG, FLAT_LDG_NA)],
    "blocks_128": [(BLOCK, "    const int tx = pow2_at_least(units, 1, 128), ty = 128 / tx;\n"),
                   (TAKE_GRID, "(kSmThreads / 128);\n    long long gx")],
    "ldg_scalar": [(TAKE_VEC, "  const bool vec = axis == 1 && staged_fits(*c, xc) && ic % 4 == 0 &&\n"
                              "                   aligned16(idx) && aligned16(out);\n"),
                   (FLAT_VEC, "  const bool vec = staged_fits(*c, T) && aligned16(idx) && "
                              "aligned16(out);\n")],
    "ldg_grid_x2": [(TAKE_GRID, "(2 * kSmThreads / kThreads);\n    long long gx"),
                    (FLAT_GRID, "(staged ? blocks_an_sm(*c, threads, bytes, 2) : "
                                "2 * kSmThreads / threads);")],
}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def nvcc(src: str, name: str) -> subprocess.Popen:
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o",
                             os.path.join(OUT, "lib%s.so" % name), src])


def entries(name: str) -> dict:
    lib = ctypes.CDLL(os.path.join(OUT, "lib%s.so" % name))
    fns = {}
    for entry in ("tz_take_along", "tz_flat_gather"):
        fn = fns[entry] = getattr(lib, entry)
        fn.restype, fn.argtypes = _I, _build._ARGTYPES[entry]
    return fns


def device_ms(fn, reps: int = 20) -> float:
    """Device ms of one fn() call: the mean of `reps` bare calls after 3,
    queued behind a sleep kernel so that their host time does not
    stretch them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((reps * 60e-6 + 1e-3) * CLOCK_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def steady_us(fn, calls: int = 200, warmup: int = 20) -> float:
    """µs a call of `calls` calls in a row, host and card together."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def cases(dev) -> dict:
    """Phase I's gather rows: name -> (entry, args before the output,
    idx, wrapper call, library call)."""
    rng = np.random.default_rng(9)

    def ints(shape, lo=-(1 << 31), hi=(1 << 31) - 1):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int32)).to(dev)

    out = {}
    for name, xshape, ishape, axis in (
        ("take_along_axis1", (64, 4352), (64, 4352), 1),
        ("take_along_axis1_wide", (64, 65536), (64, 65536), 1),
        ("take_along_axis0", (4352, 128), (4352, 128), 0),
        ("take_along_axis0_batch8", (8 * 2304, 128), (8 * 2304, 128), 0),
    ):
        x, idx = ints(xshape), ints(ishape, 0, xshape[axis])
        idx64 = idx.long()
        out[name] = ("tz_take_along", (x, *xshape, idx, *ishape, axis, gp.INT32_MIN), idx,
                     lambda x=x, idx=idx, axis=axis: gp.take_along(x, idx, axis),
                     lambda x=x, idx64=idx64, axis=axis: torch.gather(x, axis, idx64))
    for name, tshape in (("flat_gather", (256, 128)), ("flat_gather_large", (512, 128))):
        table = ints(tshape)
        idx = ints((8, 2304, 128), 0, table.numel())
        idx64 = idx.long()
        out[name] = ("tz_flat_gather", (table, table.numel(), idx, idx.numel()), idx,
                     lambda table=table, idx=idx: gp.flat_gather(table, idx),
                     lambda table=table, idx64=idx64: torch.take(table, idx64))
    return out


def launcher(fns: dict, entry: str, args: tuple, out: torch.Tensor):
    ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args] + [out.data_ptr()]
    fn = fns[entry]

    def go():
        err = fn(*ptrs, _build._raw_stream(out.get_device()))
        if err:
            raise SystemExit("gather_breakdown: %s refused (%d)" % (entry, err))
    return go


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("gather_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    procs = [nvcc(os.path.join(sys.argv[1], "tpuzlib_torch", "kernels", "csrc",
                               "gather_probe.cu"), "gather_old")]
    with open(os.path.join(CSRC, "gather_probe.cu")) as f:
        text = f.read()
    for name, patches in PATCHES.items():
        src = text
        for old, new in patches:
            if old not in src:
                raise SystemExit("%r no longer in gather_probe.cu" % old)
            src = src.replace(old, new)
        path = os.path.join(OUT, "gather_%s.cu" % name)
        with open(path, "w") as f:
            f.write(src)
        procs.append(nvcc(path, "gather_" + name))
    _build.lib()
    if any(p.wait() for p in procs):
        raise SystemExit("gather_breakdown: nvcc failed")
    new = _build.lib.fns
    old = entries("gather_old")
    variants = {name: entries("gather_" + name) for name in PATCHES}
    dev = torch.device("cuda", torch.cuda.current_device())
    for name, (entry, args, idx, wrapper, library) in cases(dev).items():
        outs = {k: torch.empty_like(idx) for k in ("old", "new", *variants)}
        go = {"old": launcher(old, entry, args, outs["old"]),
              "new": launcher(new, entry, args, outs["new"]),
              **{k: launcher(v, entry, args, outs[k]) for k, v in variants.items()}}
        for f in go.values():
            f()
        torch.cuda.synchronize()
        for k in outs:
            if not torch.equal(outs[k], outs["new"]):
                raise SystemExit("gather_breakdown: %s differs from the new %s" % (k, name))
        t = [device_ms(go[k]) for k in ("old", "new", "new", "old")]
        emit = {"probe": "gather", "part": "device", "row": name, "old_ms": [t[0], t[3]],
                "new_ms": [t[1], t[2]], "speedup": (t[0] + t[3]) / (t[1] + t[2])}
        for k in variants:
            emit[k + "_ms"] = device_ms(go[k])
        emit["new_again_ms"] = device_ms(go["new"])
        print(json.dumps(emit), flush=True)
        s = [steady_us(f) for f in (wrapper, library, wrapper, library)]
        print(json.dumps({"probe": "gather", "part": "steady", "row": name,
                          "wrapper_us": [s[0], s[2]], "library_us": [s[1], s[3]],
                          "over_library": (s[0] + s[2]) / (s[1] + s[3])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
