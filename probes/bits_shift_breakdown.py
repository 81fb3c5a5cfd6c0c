"""gf2_bits_mm and shift_screen before and after their redesign, on one CUDA
card.

    python3 probes/bits_shift_breakdown.py OLD_ROOT

OLD_ROOT is a checkout whose crc32_probe.cu runs gf2_bits_mm on the legacy
nvcuda::wmma (fragments from device memory, K split over a block's 8 warps)
and whose gather_probe.cu stages shift_screen's words in shared memory with
a 64-bit modulo a word (the commit before the redesign, unpacked with `git
archive`).  Builds OLD_ROOT's two sources alone, and copies of this
checkout's crc32_probe.cu and gather_probe.cu changed by the text patches
of BITS_PATCHES and SHIFT_PATCHES, into probes/_build/ (one nvcc each, all
at once; a variant that does not build is reported and left out), then
prints, after the card's name and power limit, one JSON object a line:

  bits   gf2_bits_mm on the tool's shape (8 MiB of seeded bytes in rows of
         1,024, unpacked to (8,192, 8,192) bf16 bits, M_1024), the bits on
         a 16-byte boundary (route "tma") and 3 elements past one ("ldg"):
         device ms of OLD_ROOT's kernel and this checkout's in turns old,
         new, new, old (bare launches queued behind a sleep kernel), each
         output held to the other, beside the patched copies (their outputs
         held to new's) and, on each route, one PyTorch call of the same
         function on the same bf16 input, torch.mm(bits, m, out_dtype=torch.float32)
         (its product, not the parity); then the wrapper's ms in turns:
           cluster1, cluster4
                   K split over 1 (no split: 64 CUDA blocks of 128 rows)
                   or 4 CUDA blocks, where the kernel takes 2;
           stages4 4 stages in the ring (two CUDA blocks an SM), where it
                   takes 6;
  shift  shift_screen on the encoder batch's (8, 2304, 128) at steps 16
         (route "regs") and 40 ("staged"): device ms in turns old, new,
         new, old with the L2 warm, then with a 64 MiB read that evicts
         the L2 before each launch, events around the launch alone
         (`flushed_`), beside the patched copies
         of the register route, outputs held to new's:
           prefetch
                   the next tile loaded before the current one's
                   arithmetic, where the kernel loads a tile as it
                   screens it;
           word_loop
                   the words outside the body (a chunk's first 16-19 and
                   last 0-3) screened by a loop of dependent steps, a load
                   each, where the kernel issues their loads together;
           max3    the maxes by pairs with __vimax3_s32 (Hopper's DPX);
           fill2   twice the blocks (each warp ~1 tile where it takes ~2);
           pair    two tiles a warp loaded together, then both screened;
           tree    a word's 16 xors first, then their max as a tree;
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

CSRC = os.path.join(ROOT, "tpuzlib_torch", "kernels", "csrc")
OUT = os.path.join(HERE, "_build")
CLOCK_HZ = 1.98e9  # the H100's boost clock: sleep cycles a second
FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2

# the variants of crc32_probe.cu: [(text in the file, its replacement)]
BITS_PATCHES = {
    "cluster1": [("constexpr int kBitsCluster = 2;", "constexpr int kBitsCluster = 1;")],
    "cluster4": [("constexpr int kBitsCluster = 2;", "constexpr int kBitsCluster = 4;")],
    "stages4": [("constexpr int kBitsStages = 6; ", "constexpr int kBitsStages = 4; ")],
}
# the variants of gather_probe.cu's register route
_TILES = ("  for (; tile < tiles; tile += stride) {\n"
          "    int4 cur, hd;\n"
          "    load_tile(bx + 32 * tile, n4 - 32 * tile, lane, cur, hd);\n"
          "    const int4 r = screen4<Full>(cur, hd, lane, steps);\n"
          "    if (lane < n4 - 32 * tile) bo[32 * tile + lane] = r;\n"
          "  }\n")
_PREFETCH = ("  if (tile >= tiles) return;\n"
             "  int4 cur, hd;\n"
             "  load_tile(bx + 32 * tile, n4 - 32 * tile, lane, cur, hd);\n"
             "  for (;;) {\n"
             "    const long long next = tile + stride;\n"
             "    int4 ncur, nhd;\n"
             "    if (next < tiles) load_tile(bx + 32 * next, n4 - 32 * next, lane, ncur, nhd);\n"
             "    const int4 r = screen4<Full>(cur, hd, lane, steps);\n"
             "    if (lane < n4 - 32 * tile) bo[32 * tile + lane] = r;\n"
             "    if (next >= tiles) break;\n"
             "    tile = next;\n"
             "    cur = ncur;\n"
             "    hd = nhd;\n"
             "  }\n")
_WORD = ("  int32_t v[kShiftWindow];\n"
         "#pragma unroll\n"
         "  for (int s = 1; s <= kShiftWindow; ++s) {\n"
         "    long long q = p - s;\n"
         "    while (q < 0) q += n;  // more than once only in a chunk shorter than the shift\n"
         "    v[s - 1] = s <= steps ? __ldg(cx + q) : cur;  // cur ^ cur adds nothing\n"
         "  }\n"
         "  int32_t acc = 0;\n"
         "#pragma unroll\n"
         "  for (int s = 0; s < kShiftWindow; ++s) acc = max(acc, v[s] ^ cur);\n")
_MAX = ("    for (int s = 1; s <= kShiftWindow; ++s)\n"
        "      if (Full || s <= steps) acc = max(acc, w[16 + k - s] ^ c);\n")
SHIFT_PATCHES = {
    # the next tile loaded before the current one's arithmetic (the
    # issue's design; it spilled 16 bytes at steps 16)
    "prefetch": [(_TILES, _PREFETCH)],
    # the words outside the body screened by a loop of dependent steps, a
    # load each
    "word_loop": [(_WORD, "  int32_t acc = 0;\n"
                          "  for (int s = 1; s <= steps; ++s) {\n"
                          "    long long q = p - s;\n"
                          "    while (q < 0) q += n;\n"
                          "    acc = max(acc, __ldg(cx + q) ^ cur);\n"
                          "  }\n")],
    "max3": [(_MAX, "    for (int s = 1; s <= kShiftWindow; s += 2) {\n"
                    "      if (Full || s + 1 <= steps)\n"
                    "        acc = __vimax3_s32(acc, w[16 + k - s] ^ c, w[15 + k - s] ^ c);\n"
                    "      else if (s <= steps)\n"
                    "        acc = max(acc, w[16 + k - s] ^ c);\n"
                    "    }\n")],
    "fill2": [("  if (grid > fill) grid = fill;\n", "  if (grid > 2 * fill) grid = 2 * fill;\n")],
    # two tiles a warp in flight: both loaded, then both screened
    "pair": [(_TILES, "  for (; tile < tiles; tile += 2 * stride) {\n"
                      "    const long long next = tile + stride;\n"
                      "    int4 cur, hd, ncur, nhd;\n"
                      "    load_tile(bx + 32 * tile, n4 - 32 * tile, lane, cur, hd);\n"
                      "    if (next < tiles) load_tile(bx + 32 * next, n4 - 32 * next, lane, ncur, nhd);\n"
                      "    const int4 r = screen4<Full>(cur, hd, lane, steps);\n"
                      "    if (lane < n4 - 32 * tile) bo[32 * tile + lane] = r;\n"
                      "    if (next < tiles) {\n"
                      "      const int4 nr = screen4<Full>(ncur, nhd, lane, steps);\n"
                      "      if (lane < n4 - 32 * next) bo[32 * next + lane] = nr;\n"
                      "    }\n"
                      "  }\n")],
    # the 16 xors of a word first, then their max as a tree of pairs
    "tree": [("#pragma unroll\n" + _MAX, "    int32_t x[kShiftWindow];\n"
                    "#pragma unroll\n"
                    "    for (int s = 1; s <= kShiftWindow; ++s)\n"
                    "      x[s - 1] = (Full || s <= steps) ? w[16 + k - s] ^ c : 0;\n"
                    "#pragma unroll\n"
                    "    for (int h = kShiftWindow / 2; h; h /= 2)\n"
                    "#pragma unroll\n"
                    "      for (int i = 0; i < h; ++i) x[i] = max(x[i], x[i + h]);\n"
                    "    acc = max(acc, x[0]);\n")],
}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_ARGS = {"tz_gf2_bits_mm": [_P, _L, _I, _P, _P, _P],
            "tz_shift_screen": [_P, _I, _L, _I, _P, _P]}


def nvcc(src: str, name: str) -> subprocess.Popen:
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o",
                             os.path.join(OUT, "lib%s.so" % name), src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


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


def flushed_ms(fn, reps: int = 20) -> float:
    """Device ms of one fn() call with a cold, clean L2: before each of
    `reps` calls a read of 64 MiB (it evicts the L2 and writes its dirty
    lines back), CUDA events around each call alone, all queued behind a
    sleep kernel after 3; the mean of the calls."""
    evict = torch.ones(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    total = torch.empty((), dtype=torch.int64, device="cuda")
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2 * reps)]

    def call(i):
        torch.sum(evict, 0, out=total)
        marks[2 * i].record()
        fn()
        marks[2 * i + 1].record()

    for i in range(3):
        call(i)
    torch.cuda.synchronize()
    torch.cuda._sleep(int((reps * 200e-6 + 1e-3) * CLOCK_HZ))
    for i in range(reps):
        call(i)
    torch.cuda.synchronize()
    return sum(marks[2 * i].elapsed_time(marks[2 * i + 1]) for i in range(reps)) / reps


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
            raise SystemExit("bits_shift_breakdown: a launch was refused (%d)" % err)
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
            raise SystemExit("bits_shift_breakdown: %s differs from new at %s" % (k, what))


def at_offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of t `offset` elements past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[offset : offset + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def bits(old, variants, dev) -> None:
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    rows = torch.randint(0, 256, (8192, 1024), dtype=torch.uint8, device=dev, generator=g)
    aligned = cp.plane_bits(rows)
    m = cp.form_matrix(1024, torch.bfloat16, dev)
    nb, K = aligned.shape
    new = _build.lib.fns["tz_gf2_bits_mm"]
    for offset in (0, 3):
        x = aligned if offset == 0 else at_offset(aligned, offset)
        route = cp.bits_mm_route(x)
        code = cp.ROUTES.index(route)
        libs = {"new": new, **variants}
        outs = {k: torch.empty(nb, 32, dtype=torch.int32, device=dev) for k in ("old", *libs)}
        go = {"old": caller(old, x, nb, K, m, outs["old"]),
              **{k: caller(f, x, nb, K, code, m, outs[k]) for k, f in libs.items()}}
        for f in go.values():
            f()
        held(outs, route)
        row = {"probe": "bits", "route": route, "offset": offset, "nb": nb, "K": K,
               "bytes": x.numel() * 2 + m.numel() * 2 + nb * 32 * 4}
        try:
            torch.mm(x, m, out_dtype=torch.float32)
            go["library_mm_bf16"] = lambda: torch.mm(x, m, out_dtype=torch.float32)
        except (TypeError, RuntimeError) as e:
            row["library_mm_bf16"] = "refused: %s" % e
        turns(go, row)

        def old_wrapper():
            out = torch.empty(nb, 32, dtype=torch.int32, device=dev)
            caller(old, x, nb, K, m, out)()
            return out

        turns({"old": old_wrapper, "new": lambda: cp.gf2_bits_mm(x, m)}, row,
              lambda f: call_ms(f, 10, 3), "wrapper_")
        print(json.dumps(row), flush=True)


def shift(old, variants, dev) -> None:
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.integers(-(1 << 31), (1 << 31) - 1, (8, 2304, 128),
                                      dtype=np.int32)).to(dev)
    b, n = x.shape[0], x[0].numel()
    new = _build.lib.fns["tz_shift_screen"]
    for steps in (16, 40):
        route = gp.shift_route(x, steps)
        code = gp.SHIFT_DESIGNS.index(route)
        libs = {"new": new, **(variants if route == "regs" else {})}
        outs = {k: torch.empty_like(x) for k in ("old", *libs)}
        go = {"old": caller(old, x, b, n, steps, outs["old"]),
              **{k: caller(f, x, b, n, steps, code, outs[k]) for k, f in libs.items()}}
        for f in go.values():
            f()
        held(outs, steps)
        row = {"probe": "shift", "route": route, "steps": steps, "shape": list(x.shape),
               "bytes": 2 * x.numel() * 4}
        turns(go, row)
        turns(go, row, flushed_ms, "flushed_")

        def old_wrapper():
            out = torch.empty_like(x)
            caller(old, x, b, n, steps, out)()
            return out

        turns({"old": old_wrapper, "new": lambda: gp.shift_screen(x, steps)}, row,
              lambda f: call_ms(f, 200, 20), "wrapper_")
        print(json.dumps(row), flush=True)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bits_shift_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    old_csrc = os.path.join(sys.argv[1], "tpuzlib_torch", "kernels", "csrc")
    procs = {"bits_old": nvcc(os.path.join(old_csrc, "crc32_probe.cu"), "bits_old"),
             "shift_old": nvcc(os.path.join(old_csrc, "gather_probe.cu"), "shift_old")}
    for source, prefix, patch_sets in (("crc32_probe.cu", "bits_", BITS_PATCHES),
                                       ("gather_probe.cu", "shift_", SHIFT_PATCHES)):
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
            procs[prefix + name] = nvcc(path, prefix + name)
    _build.lib()
    built = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        built[name] = p.returncode == 0
        if not built[name]:
            print(json.dumps({"variant": name, "built": False, "nvcc": log[-2000:]}), flush=True)
    if not (built["bits_old"] and built["shift_old"]):
        raise SystemExit("bits_shift_breakdown: OLD_ROOT's sources do not build")
    dev = torch.device("cuda", torch.cuda.current_device())
    bits(entry("bits_old", "tz_gf2_bits_mm", OLD_ARGS["tz_gf2_bits_mm"]),
         {k: entry("bits_" + k, "tz_gf2_bits_mm", _build._ARGTYPES["tz_gf2_bits_mm"])
          for k in BITS_PATCHES if built["bits_" + k]}, dev)
    shift(entry("shift_old", "tz_shift_screen", OLD_ARGS["tz_shift_screen"]),
          {k: entry("shift_" + k, "tz_shift_screen", _build._ARGTYPES["tz_shift_screen"])
           for k in SHIFT_PATCHES if built["shift_" + k]}, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
