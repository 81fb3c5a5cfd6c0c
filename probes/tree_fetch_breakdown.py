"""tree_decode and fetch_rows before and after their redesign, on one CUDA
card.

    python3 probes/tree_fetch_breakdown.py OLD_ROOT

OLD_ROOT is a checkout whose inflate_prims.cu runs both kernels a thread a
lane on blocks of 256 threads (32 blocks at 8,192 lanes), tree_decode
loading first[L] and cnt[L] as its loop compares and then off and first at
the selected row, fetch_rows its k rows in a loop of loads and stores (the
commit before the redesign, unpacked with `git archive`).  Builds OLD_ROOT's
inflate_prims.cu alone, and copies of this checkout's changed by the text
patches of PATCHES, into probes/_build/ (one nvcc each, all at once; a
variant that does not build is reported and left out), then prints, after
the card's name and power limit, one JSON object a line:

  sass   for each of the two kernels, old, new and in each patched copy,
         from `cuobjdump -sass` of its library: its LDG and STG,
         `ldg_before_use` (the LDGs issued before the first instruction
         that reads a loaded value) and `ldg_runs` (the LDGs issued
         between one such read and the next, where any: a run is what a
         thread has in flight when it first waits);
  floor  the bare-launch floor in this process: take_along on (1, 1), as
         chip_smoke's "I launch floor" line, device ms;
  tree   tree_decode on the fixed lit/len tables (inflate_cuda.canon_tables,
         each column tiled over the lanes) and random windows, and
  fetch  fetch_rows on words (40, lanes), j (1, lanes) in [0, 37), k = 3,
         (fetch_k17: the same at k = 17, past a chunk of 16, with rows
         past the 40th),
         each at 128 and 8,192 lanes (the probes' shapes): device ms of
         OLD_ROOT's kernel and this checkout's in turns old, new, new, old
         (bare launches queued behind a sleep kernel, 50 a timing), every
         output held to the plain version's, with each time's excess over
         the floor (`over_floor_`), beside the patched copies:
           bound      tree_decode under __launch_bounds__(256), as the
                      other kernels, where the kernel takes a ceiling of
                      128 registers (__maxnreg__);
           if_chain   tree_decode with the selected length's code, first
                      and off assigned in a branch, the chain as first
                      written, where the kernel sums the rank at every
                      length and selects it;
           if_chain_ptx
                      the same with the table loads in inline PTX;
           gather_at  tree_decode with first and off loaded at the
                      selected row after the chain, as the parent does
                      (the new grid), where the kernel loads rows 1-15 of
                      both up front and selects in registers;
           rows16     tree_decode loading row 0 of the three tables too
                      (used only by a test that the probe's tables never
                      meet, so the loads are not dropped);
           grid256    both kernels on the parent's grid (blocks of 256
                      threads) with the new loads;
           chunk16    fetch_rows in chunks of 16 rows, the last
                      predicated on i < k (k = 3: 16 predicated slots),
                      where the kernel takes chunks of 4;
           loop       fetch_rows with every chunk of 4 in one loop, each
                      predicated on i < k, where the kernel takes whole
                      chunks and then one predicated chunk;
           lead16     fetch_rows with whole chunks of 16 ahead of the
                      chunks of 4 (timed at k = 17 too, where it runs);
           ucmp       fetch_rows with the range test as one unsigned
                      compare of j + i with nw;
           narrow     fetch_rows with 32-bit element offsets (right while
                      words.numel() < 2^31, as here), where the kernel
                      takes 64.
"""

from __future__ import annotations

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

from probes.store_min_breakdown import (  # noqa: E402
    CSRC, OUT, caller, entry, floor, ints, nvcc, turns)
from tpuzlib_torch.codec.tables import FIXED_LITLEN_LENGTHS  # noqa: E402
from tpuzlib_torch.kernels import _build, inflate_cuda, inflate_prims as ip  # noqa: E402

LANES = (128, 8192)
I32 = np.iinfo(np.int32)

_LOADS = ("    c[L] = __ldg(cnt + at);\n"
          "    f[L] = __ldg(first + at);\n"
          "    o[L] = __ldg(off + at);\n")
_TREE_TABLES = "  int32_t c[16], f[16], o[16];  // rows 1-15; [0] unused\n"
_CHAIN_HEAD = ("  int sel = 99;\n"
               "  uint32_t rank = static_cast<uint32_t>(o[15]) + static_cast<uint32_t>(rv >> 1) -\n"
               "                  static_cast<uint32_t>(f[15]);\n")
_CHAIN_BODY = ("    sel = hit ? L : sel;\n"
               "    rank = hit ? static_cast<uint32_t>(o[L]) + static_cast<uint32_t>(cl) - "
               "static_cast<uint32_t>(f[L])\n"
               "               : rank;\n")
_MATCH = "    const bool hit = cl >= f[L] && d < c[L];\n"
_TREE_OUT = "  out[l] = sel;\n  out[lanes + l] = static_cast<int32_t>(rank);\n"
# the chain as first written: the selected length's code, first
# and off assigned in a branch (ptxas: each off[L] a load predicated on
# its match, all into one register)
_IF_CHAIN = [
    (_CHAIN_HEAD, "  int sel = 99;\n  int32_t code = rv >> 1, fs = f[15], os = o[15];\n"),
    (_MATCH + _CHAIN_BODY,
     "    if (cl >= f[L] && d < c[L]) {\n      sel = L;\n      code = cl;\n      fs = f[L];\n"
     "      os = o[L];\n    }\n"),
    (_TREE_OUT, "  out[l] = sel;\n"
                "  out[lanes + l] = static_cast<int32_t>(static_cast<uint32_t>(os) +\n"
                "                                        static_cast<uint32_t>(code) -\n"
                "                                        static_cast<uint32_t>(fs));\n")]
_FETCH_LOAD = "? __ldg(col + static_cast<long long>(j0 + i) * lanes)"
_FETCH_RANGE = ("    v[t] = (!Tail || i < k) && j0 >= -i && j0 < nw - i\n"
                "               " + _FETCH_LOAD + "\n")
_FETCH_CHUNK = "constexpr int kFetchChunk = 4;"
_FETCH_LOOPS = ("  int i0 = 0;\n"
                "  for (; i0 + kFetchChunk <= k; i0 += kFetchChunk)\n"
                "    fetch_chunk<false>(col, nw, lanes, j0, i0, k, oc);\n"
                "  if (i0 < k) fetch_chunk<true>(col, nw, lanes, j0, i0, k, oc);\n")
_FETCH_LAUNCH = ("  const int threads = spread_threads(lanes, sms);\n"
                 "  fetch_rows_kernel<<<")
_TREE_LAUNCH = ("  const int threads = spread_threads(lanes, sms);\n"
                "  tree_decode_kernel<<<")
# the variants of inflate_prims.cu: [(text in the file, its replacement)]
PATCHES = {
    "if_chain": _IF_CHAIN,
    # the same with the table loads in inline PTX, which the compiler's
    # front end may not move: ptxas makes the same predicated loads
    "if_chain_ptx": _IF_CHAIN + [(_LOADS, "".join(
        '    asm volatile("ld.global.nc.b32 %%0, [%%1];" : "=r"(%s[L]) : "l"(%s + at));\n' % v
        for v in (("c", "cnt"), ("f", "first"), ("o", "off"))))],
    # first and off at the selected row, loaded after the chain (off's
    # rows 1-15 then go unused and are not loaded)
    "gather_at": [
        (_CHAIN_HEAD, "  int sel = 99;\n  int32_t code = rv >> 1;\n"),
        (_CHAIN_BODY, "    sel = hit ? L : sel;\n    code = hit ? cl : code;\n"),
        (_TREE_OUT,
         "  const long long at = static_cast<long long>(sel < 15 ? sel : 15) * lanes + l;\n"
         "  out[l] = sel;\n"
         "  out[lanes + l] = static_cast<int32_t>(static_cast<uint32_t>(__ldg(off + at)) +\n"
         "                                        static_cast<uint32_t>(code) -\n"
         "                                        static_cast<uint32_t>(__ldg(first + at)));\n")],
    # row 0's three words loaded too; they change the output only where
    # all three are INT32_MAX, which the probe's tables never are
    "rows16": [(_TREE_TABLES,
                "  const int32_t c0 = __ldg(cnt + l), f0 = __ldg(first + l), o0 = __ldg(off + l);\n"
                + _TREE_TABLES),
               (_TREE_OUT, "  if (c0 == INT32_MAX && f0 == INT32_MAX && o0 == INT32_MAX) sel = 0;\n"
                + _TREE_OUT)],
    "grid256": [(_FETCH_LAUNCH, _FETCH_LAUNCH.replace("spread_threads(lanes, sms)", "256")),
                (_TREE_LAUNCH, _TREE_LAUNCH.replace("spread_threads(lanes, sms)", "256"))],
    "narrow": [(_FETCH_LOAD, "? __ldg(col + (j0 + i) * lanes)"),
               ("oc[static_cast<long long>(i0 + t) * lanes] = v[t];",
                "oc[(i0 + t) * lanes] = v[t];")],
    # the issue's design: chunks of 16, the last predicated on i < k (k =
    # 3: 16 predicated slots)
    "chunk16": [(_FETCH_CHUNK, _FETCH_CHUNK.replace("4", "16"))],
    # every chunk of 4 in one loop, each predicated on i < k
    "loop": [(_FETCH_LOOPS, "  for (int i0 = 0; i0 < k; i0 += kFetchChunk)\n"
                            "    fetch_chunk<true>(col, nw, lanes, j0, i0, k, oc);\n")],
    # this design first shipped: whole chunks of 16 ahead of the chunks of 4
    "lead16": [(_FETCH_LOOPS, _FETCH_LOOPS.replace("  for (;", "".join((
        "  for (; i0 + 16 <= k; i0 += 16) {\n",
        "    int32_t v[16];\n",
        "#pragma unroll\n",
        "    for (int t = 0; t < 16; ++t) {\n",
        "      const int i = i0 + t;\n",
        "      v[t] = j0 >= -i && j0 < nw - i ", _FETCH_LOAD, " : 0;\n",
        "    }\n",
        "#pragma unroll\n",
        "    for (int t = 0; t < 16; ++t) oc[static_cast<long long>(i0 + t) * lanes] = v[t];\n",
        "  }\n",
        "  for (;"))))],
    # the range test as one unsigned compare of j + i, summed in uint32,
    # with nw (exact for i < 2^31: a true sum below 0 or past INT32_MAX
    # lands at 2^31 or above), where the kernel makes two signed ones
    "ucmp": [(_FETCH_RANGE,
              "    const uint32_t r = static_cast<uint32_t>(j0) + static_cast<uint32_t>(i);\n"
              "    v[t] = (!Tail || i < k) && r < static_cast<uint32_t>(nw)\n"
              "               ? __ldg(col + static_cast<long long>(r) * lanes)\n")],
    # tree_decode under the launch bound the other kernels take, where the
    # kernel takes a ceiling of 128 registers (ptxas then keeps to 64)
    "bound": [("__global__ void __maxnreg__(128)\ntree_decode_kernel(",
               "__global__ void __launch_bounds__(kThreads)\ntree_decode_kernel(")],
}
TREE_VARIANTS = ("bound", "if_chain", "if_chain_ptx", "gather_at", "rows16", "grid256")
FETCH_VARIANTS = ("chunk16", "loop", "lead16", "ucmp", "grid256", "narrow")
KERNELS = ("fetch_rows_kernel", "tree_decode_kernel")
_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*(?:\.[A-Z0-9_.]+)?)"
                   r"\s*([^;]*);")
_REG = re.compile(r"\bR(\d+)\b")


def load_runs(code: str) -> list:
    """The LDGs issued between successive reads of a loaded value: each
    instruction's first operand is its destination (a store's are all
    sources), and a value stops being pending once read or overwritten."""
    pending, runs, run = set(), [], 0
    for op, args in _LINE.findall(code):
        regs = [set(_REG.findall(a)) for a in args.split(",")]
        if op.startswith(("ST", "RED", "ATOM")):
            dst, srcs = set(), set().union(*regs) if regs else set()
        else:
            dst, srcs = regs[0] if regs else set(), set().union(*regs[1:])
        if pending & srcs:
            runs.append(run)
            run = 0
            pending -= srcs
        pending -= dst
        if op.startswith("LDG"):
            run += 1
            pending |= dst
    return runs + [run] if run else runs


def sass(label: str, lib: str) -> None:
    """One JSON line for each kernel of KERNELS in the library `lib`."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split(None, 1)[0]
        if not any(k in name for k in KERNELS):
            continue
        ops = [op for op, _ in _LINE.findall(part)]
        runs = load_runs(part)
        print(json.dumps({"probe": "sass", "which": label, "kernel": name,
                          "LDG": sum(o.startswith("LDG") for o in ops),
                          "STG": sum(o.startswith("STG") for o in ops),
                          "ldg_before_use": runs[0] if runs else 0,
                          "ldg_runs": [r for r in runs if r],
                          "instructions": len(ops)}), flush=True)


def held(outs: dict, want: torch.Tensor, what) -> None:
    torch.cuda.synchronize()
    for k, o in outs.items():
        if not torch.equal(o, want):
            raise SystemExit("tree_fetch_breakdown: %s differs from the plain version at %s"
                             % (k, what))


def measure(probe: str, fn: str, old, variants: dict, make, dev, floor_ms) -> None:
    """`make(lanes)` gives (the arguments before out, out's shape, the plain
    version's output, the row's fields); each library's `fn` is timed on
    them in turns."""
    libs = {"old": old, "new": _build.lib.fns[fn], **variants}
    for lanes in LANES:
        args, shape, want, row = make(lanes)
        outs = {k: torch.empty(shape, dtype=torch.int32, device=dev) for k in libs}
        go = {k: caller(f, *args, outs[k]) for k, f in libs.items()}
        for f in go.values():
            f()
        held(outs, want, (probe, lanes))
        print(json.dumps(turns(go, {"probe": probe, "lanes": lanes, **row,
                                    "floor_ms": floor_ms}, floor_ms)), flush=True)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("tree_fetch_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    old_src = os.path.join(sys.argv[1], "tpuzlib_torch", "kernels", "csrc", "inflate_prims.cu")
    procs = {"tf_old": nvcc(old_src, "tf_old")}
    with open(os.path.join(CSRC, "inflate_prims.cu")) as f:
        text = f.read()
    for name, patches in PATCHES.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise SystemExit("%r is not once in inflate_prims.cu" % old)
            src = src.replace(old, new)
        path = os.path.join(OUT, "tf_" + name + ".cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = nvcc(path, "tf_" + name)
    _build.lib()
    built = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        built[name] = p.returncode == 0
        if not built[name]:
            print(json.dumps({"variant": name, "built": False, "nvcc": log[-2000:]}), flush=True)
    if not built["tf_old"]:
        raise SystemExit("tree_fetch_breakdown: OLD_ROOT's inflate_prims.cu does not build")
    sass("old", os.path.join(OUT, "libtf_old.so"))
    sass("new", _build.build())
    for name in PATCHES:
        if built[name]:
            sass(name, os.path.join(OUT, "libtf_%s.so" % name))
    dev = torch.device("cuda", torch.cuda.current_device())
    floor_ms = floor(dev)
    rng = np.random.default_rng(19)
    _, *cols = inflate_cuda.canon_tables(FIXED_LITLEN_LENGTHS, "litlen")

    def tree_case(lanes):
        tabs = [torch.from_numpy(np.tile(c[:, None], (1, lanes))).to(dev) for c in cols]
        w = ints(rng, (1, lanes), I32.min, I32.max, dev)
        return (w, *tabs, lanes), (2, lanes), ip.tree_decode_plain(w, *tabs), {"table": "fixed"}

    def fetch_case(lanes, k=3):
        words, j = ints(rng, (40, lanes), I32.min, I32.max, dev), ints(rng, (1, lanes), 0, 37, dev)
        return ((words, 40, lanes, j, k), (k, lanes), ip.fetch_rows_plain(words, j, k),
                {"nw": 40, "k": k})

    for probe, fn, names, make in (("tree", "tz_tree_decode", TREE_VARIANTS, tree_case),
                                   ("fetch", "tz_fetch_rows", FETCH_VARIANTS, fetch_case),
                                   ("fetch_k17", "tz_fetch_rows", FETCH_VARIANTS,
                                    lambda lanes: fetch_case(lanes, 17))):
        args = _build._ARGTYPES[fn]  # the parent's entry points take the same arguments
        variants = {k: entry("tf_" + k, fn, args) for k in names if built[k]}
        measure(probe, fn, entry("tf_old", fn, args), variants, make, dev, floor_ms)
    floor(dev)  # again after the kernels
    return 0


if __name__ == "__main__":
    sys.exit(main())
