"""gather_store_loop and col_min_sum before and after their redesign, on one
CUDA card.

    python3 probes/store_min_breakdown.py OLD_ROOT

OLD_ROOT is a checkout whose inflate_prims.cu runs both kernels a thread a
lane on 32 blocks of 256 threads at 8,192 lanes, gather_store_loop's next
row a runtime `%` a step (the commit before the redesign, unpacked with
`git archive`).  Builds OLD_ROOT's inflate_prims.cu alone, and copies of
this checkout's changed by the text patches of PATCHES, into
probes/_build/ (one nvcc each, all at once; a variant that does not build
is reported and left out), then prints, after the card's name and power
limit, one JSON object a line:

  sass   for each of the two kernels, old and new, from `cuobjdump -sass`
         of its library: its LDG and STG, the integer divisions' steps
         (I2F.RP, MUFU.RCP: one each a runtime `%`), and `ldg_run`, the
         most loads issued one after another before a store or a min uses
         one (the loads a thread has in flight at once);
  floor  the bare-launch floor in this process: take_along on (1, 1), as
         chip_smoke's "I launch floor" line, device ms;
  gather gather_store_loop on words (40, lanes), j (1, lanes) in [0, 37),
         16 steps, and col col_min_sum on x (16, lanes) in [0, 1,000), x on
         a 16-byte boundary (offset 0) and one word past one (offset 1),
         each at 128 and 8,192 lanes: device ms of OLD_ROOT's kernel and
         this checkout's in turns old, new, new, old (bare launches queued
         behind a sleep kernel, 50 a timing), each output held to the plain
         version's, with each time's excess over the floor (`over_floor_`),
         beside the patched copies (at offset 0), outputs held likewise:
           chain   gather_store_loop's rows by a chain of adds, each step's
                   row the last one's plus s, where the kernel adds offsets
                   summed beforehand to its chunk's first row;
           staged  gather_store_loop with a block's rows loaded once,
                   coalesced, into shared memory ([row][lane]: bank lane
                   mod 32), then gathered from there, where the kernel
                   gathers from the L2 through the read-only path;
           vec4    col_min_sum with 4 lanes a thread by 16-byte loads where
                   lanes % 4 == 0 and x and out lie on 16-byte boundaries
                   (blocks of 16 threads at 8,192 lanes, one of 32 at 128),
                   where the kernel takes a lane a thread;
           grid256 both kernels on the parent's grid (blocks of 256
                   threads) with the new loads;
           spread128
                   up to 128 lanes spread over blocks of 32 threads where
                   the kernel runs them as one block (at 128 lanes);
           chunk8  8 steps or rows a chunk where the kernels take 16;
           narrow  gather_store_loop's row offsets in 32 bits where the
                   kernel takes 64;
         and, not the kernel's function (their outputs not held), the
         parts of gather_store_loop's time: no_rows (every step's row a
         constant, so no load waits on j's), j_rows (rows that wait on j's
         load, without the floor mod and the offsets) and one_store (a
         chunk's 16 loads stored as one xor).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from tpuzlib_torch.kernels import _build, inflate_prims as ip  # noqa: E402

CSRC = os.path.join(ROOT, "tpuzlib_torch", "kernels", "csrc")
OUT = os.path.join(HERE, "_build")
CLOCK_HZ = 1.98e9  # the H100's boost clock: sleep cycles a second
REPS = 50
LANES = (128, 8192)

_GATHER_LAUNCH = ("  const int threads = spread_threads(lanes, sms);\n"
                  "  gather_store_loop_kernel<<<(lanes + threads - 1) / threads, threads, 0,\n")
_COL_LAUNCH = ("  const int threads = spread_threads(lanes, sms);\n"
               "  col_min_sum_kernel<<<(lanes + threads - 1) / threads, threads, 0,\n")
_ROW = "      at[k] = add_mod(base, d[First ? k - 1 : k], m);\n"
_STORES = ("#pragma unroll\n  for (int k = 0; k < kChunk; ++k)\n"
           "    if (!Tail || t0 + k < steps) oc[static_cast<long long>(t0 + k) * lanes] = v[k];\n")
# col_min_sum with 4 lanes a thread by 16-byte loads, where lanes % 4 == 0
# and x and out lie on 16-byte boundaries (a "vec4" route; blocks of 16
# threads at 8,192 lanes, one block up to 128 lanes)
_VEC4_KERNEL = r"""__global__ void __launch_bounds__(kThreads)
col_min_sum_vec4_kernel(const int32_t* __restrict__ x, int rows, int lanes,
                        int32_t* __restrict__ out) {
  const int units = lanes / 4;
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= units) return;
  const int4* col = reinterpret_cast<const int4*>(x) + u;
  int32_t mn[4] = {INT32_MAX, INT32_MAX, INT32_MAX, INT32_MAX};
  uint32_t sum[4] = {0u, 0u, 0u, 0u};
  for (int r0 = 0; r0 < rows; r0 += kChunk) {
    int4 v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (r0 + k < rows) v[k] = __ldg(col + static_cast<long long>(r0 + k) * units);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (r0 + k >= rows) break;
      const int32_t e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mn[i] = min(mn[i], e[i]);
        sum[i] += static_cast<uint32_t>(e[i]);
      }
    }
  }
  int4* o = reinterpret_cast<int4*>(out) + u;
  o[0] = make_int4(mn[0], mn[1], mn[2], mn[3]);
  o[units] = make_int4(static_cast<int32_t>(sum[0]), static_cast<int32_t>(sum[1]),
                       static_cast<int32_t>(sum[2]), static_cast<int32_t>(sum[3]));
}

"""
_VEC4_LAUNCH = r"""  if (lanes % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int units = lanes / 4;
    int threads = lanes <= kOneBlock ? (units + 31) / 32 * 32 : 16;
    while (lanes > kOneBlock && threads < (units + sms - 1) / sms && threads < kThreads)
      threads *= 2;
    col_min_sum_vec4_kernel<<<(units + threads - 1) / threads, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), rows, lanes, static_cast<int32_t*>(out));
    return done();
  }
"""
_COL_ENTRY = "// x (rows, lanes) with rows >= 1, out (2, lanes)\n"
# the variants of inflate_prims.cu: [(text in the file, its replacement)]
PATCHES = {
    # the rows by a chain of adds, each step's row the last one's plus s,
    # where the kernel adds offsets summed beforehand to a chunk's first row
    "chain": [(_ROW, "      at[k] = base;\n      base = add_mod(base, d[1], m);\n")],
    "staged": [
        ("  const int l = blockIdx.x * blockDim.x + threadIdx.x;\n"
         "  if (l >= lanes) return;\n"
         "  const int32_t* col = words + l;\n",
         "  const int l = blockIdx.x * blockDim.x + threadIdx.x;\n"
         "  extern __shared__ int32_t staged_rows[];\n"
         "  if (l < lanes)\n"
         "    for (int r = 0; r < nw; ++r)\n"
         "      staged_rows[r * blockDim.x + threadIdx.x] =\n"
         "          __ldg(words + static_cast<long long>(r) * lanes + l);\n"
         "  __syncthreads();\n"
         "  if (l >= lanes) return;\n"
         "  const int32_t* col = staged_rows + threadIdx.x;\n"),
        ("v[k] = ok[k] ? __ldg(col + static_cast<long long>(at[k]) * lanes) : 0;",
         "v[k] = ok[k] ? col[at[k] * blockDim.x] : 0;"),
        (_GATHER_LAUNCH, _GATHER_LAUNCH.replace(", 0,\n", ", 4 * nw * threads,\n")),
    ],
    "vec4": [(_COL_ENTRY, _VEC4_KERNEL + _COL_ENTRY), (_COL_LAUNCH, _VEC4_LAUNCH + _COL_LAUNCH)],
    "grid256": [(_GATHER_LAUNCH, _GATHER_LAUNCH.replace("spread_threads(lanes, sms)", "256")),
                (_COL_LAUNCH, _COL_LAUNCH.replace("spread_threads(lanes, sms)", "256"))],
    "spread128": [("constexpr int kOneBlock = 128;", "constexpr int kOneBlock = 0;")],
    "chunk8": [("constexpr int kChunk = 16;", "constexpr int kChunk = 8;")],
    # not the kernel's function (outputs not held): the rows constant (1 ..
    # 16), and one store a chunk (the xor of its loads) for its 16
    "no_rows": [(_ROW, "      at[k] = k + 1;\n")],
    # 32-bit offsets for the rows' loads and stores (right while nw and
    # steps times lanes stay below 2^31, as here), where the kernel takes 64
    "narrow": [("v[k] = ok[k] ? __ldg(col + static_cast<long long>(at[k]) * lanes) : 0;",
                "v[k] = ok[k] ? __ldg(col + static_cast<int>(at[k]) * lanes) : 0;"),
               ("oc[static_cast<long long>(t0 + k) * lanes] = v[k];", "oc[(t0 + k) * lanes] = v[k];")],
    # rows that wait on j's load but take no floor mod and no offsets
    "j_rows": [(_ROW, "      at[k] = (static_cast<uint32_t>(j0) + k) & 31u;\n")],
    "one_store": [(_STORES, "  int32_t acc = 0;\n#pragma unroll\n  for (int k = 0; k < kChunk; ++k) acc ^= v[k];\n"
                            "  oc[static_cast<long long>(t0) * lanes] = acc;\n")],
}
NOT_HELD = ("no_rows", "j_rows", "one_store")
GATHER_VARIANTS = ("chain", "staged", "grid256", "spread128", "chunk8", "narrow", "no_rows",
                   "j_rows", "one_store")
COL_VARIANTS = ("vec4", "grid256", "spread128", "chunk8")
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_ARGS = {"tz_gather_store_loop": [_P, _I, _I, _P, _I, _P, _P],
            "tz_col_min_sum": [_P, _I, _I, _P, _P]}
KERNELS = ("gather_store_loop_kernel", "col_min_sum_kernel")


def nvcc(src: str, name: str) -> subprocess.Popen:
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o",
                             os.path.join(OUT, "lib%s.so" % name), src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def entry(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    f = getattr(ctypes.CDLL(os.path.join(OUT, "lib%s.so" % name)), fn)
    f.restype, f.argtypes = _I, argtypes
    return f


def sass(label: str, lib: str) -> None:
    """One JSON line for each kernel of KERNELS in the library `lib`."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split(None, 1)[0]
        kernel = next((k for k in KERNELS if k in name), None)
        if kernel is None:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*(?:\.[A-Z0-9.]+)?)",
                         part)
        run = best = 0
        for op in ops:
            if op.startswith("LDG"):
                run += 1
                best = max(best, run)
            elif op.startswith(("STG", "VIMNMX", "IMNMX")):
                run = 0
        print(json.dumps({"probe": "sass", "which": label, "kernel": name,
                          "LDG": sum(o.startswith("LDG") for o in ops),
                          "STG": sum(o.startswith("STG") for o in ops),
                          "I2F.RP": ops.count("I2F.RP"), "MUFU.RCP": ops.count("MUFU.RCP"),
                          "ldg_run": best, "instructions": len(ops)}), flush=True)


def device_ms(fn, reps: int = REPS) -> float:
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


def caller(fn, *args):
    ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    stream = _build._raw_stream(torch.cuda.current_device())

    def go():
        err = fn(*ptrs, stream)
        if err:
            raise SystemExit("%s: a launch was refused (%d)" % (os.path.basename(sys.argv[0]), err))
    return go


def turns(go: dict, row: dict, floor_ms: float) -> dict:
    """old and new in turns old, new, new, old, their speedup the ratio of
    old's two times to new's, each time's excess over the floor; then each
    other entry of `go` once."""
    t = [device_ms(go[k]) for k in ("old", "new", "new", "old")]
    row.update(old_ms=[t[0], t[3]], new_ms=[t[1], t[2]], speedup=(t[0] + t[3]) / (t[1] + t[2]),
               over_floor_old_ms=[t[0] - floor_ms, t[3] - floor_ms],
               over_floor_new_ms=[t[1] - floor_ms, t[2] - floor_ms])
    for k in go:
        if k not in ("old", "new"):
            row[k + "_ms"] = device_ms(go[k])
            row["over_floor_" + k + "_ms"] = row[k + "_ms"] - floor_ms
    return row


def held(outs: dict, want: torch.Tensor, what) -> None:
    torch.cuda.synchronize()
    for k, o in outs.items():
        if k not in NOT_HELD and not torch.equal(o, want):
            raise SystemExit("store_min_breakdown: %s differs from the plain version at %s"
                             % (k, what))


def ints(rng, shape, lo, hi, dev, offset=0) -> torch.Tensor:
    """Seeded int32 values in [lo, hi) on the card, `offset` words past a
    16-byte boundary."""
    a = torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int32))
    buf = torch.empty(a.numel() + 4, dtype=torch.int32, device=dev)
    t = buf[offset : offset + a.numel()].view(shape)
    t.copy_(a)
    return t


def floor(dev) -> float:
    one = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    out = torch.empty_like(one)
    go = caller(_build.lib.fns["tz_take_along"], one, 1, 1, one, 1, 1, 1, 0, out)
    ms = device_ms(go)
    print(json.dumps({"probe": "floor", "kernel": "take_along", "shape": [1, 1],
                      "device_ms": ms}), flush=True)
    return ms


def gather(old, variants, dev, floor_ms) -> None:
    rng = np.random.default_rng(20)
    new = _build.lib.fns["tz_gather_store_loop"]
    for lanes in LANES:
        words, j = ints(rng, (40, lanes), -(1 << 31), (1 << 31) - 1, dev), ints(
            rng, (1, lanes), 0, 37, dev)
        libs = {"new": new, **{k: f for k, f in variants.items()
                               if k in GATHER_VARIANTS and (k != "spread128" or lanes <= 128)}}
        outs = {k: torch.empty(16, lanes, dtype=torch.int32, device=dev) for k in ("old", *libs)}
        go = {k: caller(old if k == "old" else libs[k], words, 40, lanes, j, 16, outs[k])
              for k in outs}
        for f in go.values():
            f()
        held(outs, ip.gather_store_loop_plain(words, j, 16), ("gather", lanes))
        print(json.dumps(turns(go, {"probe": "gather", "lanes": lanes, "nw": 40, "steps": 16,
                                    "floor_ms": floor_ms}, floor_ms)), flush=True)


def col(old, variants, dev, floor_ms) -> None:
    rng = np.random.default_rng(21)
    new = _build.lib.fns["tz_col_min_sum"]
    for offset in (0, 1):
        for lanes in LANES:
            x = ints(rng, (16, lanes), 0, 1000, dev, offset)
            libs = {"old": old, "new": new}
            if offset == 0:
                libs.update({k: f for k, f in variants.items()
                             if k in COL_VARIANTS and (k != "spread128" or lanes <= 128)})
            outs = {k: torch.empty(2, lanes, dtype=torch.int32, device=dev) for k in libs}
            go = {k: caller(f, x, 16, lanes, outs[k]) for k, f in libs.items()}
            for f in go.values():
                f()
            held(outs, ip.col_min_sum_plain(x), ("col", offset, lanes))
            print(json.dumps(turns(go, {"probe": "col", "lanes": lanes, "rows": 16,
                                        "offset": offset, "floor_ms": floor_ms}, floor_ms)),
                  flush=True)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("store_min_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    old_src = os.path.join(sys.argv[1], "tpuzlib_torch", "kernels", "csrc", "inflate_prims.cu")
    procs = {"prims_old": nvcc(old_src, "prims_old")}
    with open(os.path.join(CSRC, "inflate_prims.cu")) as f:
        text = f.read()
    for name, patches in PATCHES.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise SystemExit("%r is not once in inflate_prims.cu" % old)
            src = src.replace(old, new)
        path = os.path.join(OUT, "prims_" + name + ".cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = nvcc(path, "prims_" + name)
    _build.lib()
    built = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        built[name] = p.returncode == 0
        if not built[name]:
            print(json.dumps({"variant": name, "built": False, "nvcc": log[-2000:]}), flush=True)
    if not built["prims_old"]:
        raise SystemExit("store_min_breakdown: OLD_ROOT's inflate_prims.cu does not build")
    sass("old", os.path.join(OUT, "libprims_old.so"))
    sass("new", _build.build())
    dev = torch.device("cuda", torch.cuda.current_device())
    floor_ms = floor(dev)
    gather(entry("prims_old", "tz_gather_store_loop", OLD_ARGS["tz_gather_store_loop"]),
           {k: entry("prims_" + k, "tz_gather_store_loop",
                     _build._ARGTYPES["tz_gather_store_loop"]) for k in PATCHES if built[k]},
           dev, floor_ms)
    col(entry("prims_old", "tz_col_min_sum", OLD_ARGS["tz_col_min_sum"]),
        {k: entry("prims_" + k, "tz_col_min_sum", _build._ARGTYPES["tz_col_min_sum"])
         for k in PATCHES if built[k]}, dev, floor_ms)
    floor(dev)  # again after the kernels
    return 0


if __name__ == "__main__":
    sys.exit(main())
