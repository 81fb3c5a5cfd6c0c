"""Where the CRC-32 kernel's time goes, and the public crc32 before and
after its redesign, on one CUDA card.

    python3 probes/crc_breakdown.py OLD_ROOT

OLD_ROOT is a checkout whose CRC kernel stages bytes through shared
memory and whose crc32 combines the forms on the host (the commit before
the redesign, unpacked with `git archive`).  Builds its
tpuzlib_torch/kernels/csrc/crc32.cu, probes/crc32_direct.cu and patched
copies of this checkout's (one nvcc each, all at once, into
probes/_build/), then, on 256 MiB of the seeded mixed corpus
(chip_smoke.py's checksum input):

  variants  device ms of tile-1 and tile-256 forms on 256 MiB, and of
            tile-1 forms on 200 KiB (one CUDA block: the latency of a
            chain), for: the earlier kernel (bytes staged one a thread
            through shared memory, one table, one chain a thread); the
            first redesign (probes/crc32_direct.cu: each thread's block
            loaded straight into registers, 8 chains a block joined by
            A^128); the second (probes/crc32_rounds.cu: 4 blocks a lane,
            32 bytes of each staged a round by cp.async); this kernel
            (a warp's contiguous chunk staged by cp.async, slice-by-4, a
            128-byte piece a lane, 2 stages) with other pieces, chains
            and stages, with one span a CUDA block instead of four, with
            a lookup a byte (one table, and a table copy a lane), and with
            the lookups replaced by shifts and with no fold at all (the
            floors of its loads and staging);
  scalar    device ms of crc32_device_scalar (one launch: forms, tail and
            finish) beside the forms alone at 200 KiB, 8 MiB and 256 MiB;
  public    host ms of a warm tpuzlib_torch.crc32 of a card tensor of
            200 KiB, 8 MiB and 256 MiB (median of 10 after 3 warm-ups),
            OLD_ROOT's and this checkout's, each in a process of its own,
            in turns old, new, new, old.

It requires every variant but the shifts and the loads alone to give
this kernel's forms, prints the card's name and power limit, then one
JSON object a line.
Device times are the mean of 10 calls after 3 warm-ups from CUDA events
with every call queued behind a sleep kernel (launch overhead hidden).
The patched copies are for timing only.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(HERE)))

from screen_breakdown import OUT, call, cuda_ms, entry, nvcc, patched  # noqa: E402

from tpuzlib_torch import testing  # noqa: E402
from tpuzlib_torch.kernels import _build, crc32, crc32_cuda  # noqa: E402

ROOT = os.path.dirname(HERE)
CSRC = os.path.join(ROOT, "tpuzlib_torch", "kernels", "csrc")
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ARGS = [_P, _L, _L, _P, _P, _P, _L, _I, _P]  # tz_crc32_forms, before and after
CHAINS = "constexpr int kChains = 1;"
PIECE = "constexpr int kPiece = 128;"
STAGES = "constexpr int kStages = 2; "
PER_CTA = "      nb >= static_cast<long long>(kMaxBlocksPerCta) * sms ? kMaxBlocksPerCta : kSpan;"
LOOKUPS = ("  return t[768 + (x & 0xFFu)] ^ t[512 + ((x >> 8) & 0xFFu)] ^ "
           "t[256 + ((x >> 16) & 0xFFu)] ^\n         t[x >> 24];")
BYTEWISE = "  for (int b = 0; b < 4; ++b) x = %s ^ (x >> 8);\n  return x;"
SLICES = ("    for (int k = 1; k < 4; ++k) {\n      const uint32_t v = t[(k - 1) * 256 + i];\n"
          "      t[k * 256 + i] = t[v & 0xFFu] ^ (v >> 8);\n    }")
FOLD = "crc[j] = fold_word(t, crc[j] ^ word_at<Q>(prev[j], cur[j], k, sh));"
# variant -> patches of crc32.cu
PATCHES = {**{"pieces of %d B, %d chains, %d stages" % (p, c, st): [
                  (PIECE, "constexpr int kPiece = %d;" % p),
                  (CHAINS, "constexpr int kChains = %d;" % c),
                  (STAGES, "constexpr int kStages = %d;" % st)]
              for p, c, st in ((64, 2, 2), (64, 1, 2), (128, 1, 3), (128, 2, 2))},
           "one span a CUDA block at any size": [(PER_CTA, "      kSpan;")],
           "four spans a CUDA block at any size": [(PER_CTA, "      kMaxBlocksPerCta;")],
           "a byte a lookup, one table": [(LOOKUPS, BYTEWISE % "t[x & 0xFFu]")],
           "a byte a lookup, a table copy a lane": [
               (LOOKUPS, BYTEWISE % "t[((x & 0xFFu) << 5) + (threadIdx.x & 31)]"),
               ("    4 * 256 + kPowers", "    256 * 32 + kPowers"),
               ("uint32_t* pw = t + 4 * 256;", "uint32_t* pw = t + 256 * 32;"),
               ("for (int i = tid; i < 256; i += kThreads) t[i] = a.table[i];",
                "for (int i = tid; i < 256 * 32; i += kThreads) t[i] = a.table[i >> 5];"),
               (SLICES, "")],
           "shifts, no lookups": [
               (LOOKUPS, "  return (x >> 8) ^ (x << 3) ^ (x >> 16) ^ (t == nullptr);")],
           "no fold: loads and staging only": [
               (FOLD, "crc[j] ^= word_at<Q>(prev[j], cur[j], k, sh);")]}
SIZES = {"200KiB": 200 << 10, "8MiB": 8 << 20, "256MiB": 256 << 20}

# run in OLD_ROOT and in this checkout: warm host ms of the public crc32
PUBLIC = r"""
import json, statistics, sys, time, zlib
import numpy as np, torch
sys.path.insert(0, ".")
import tpuzlib_torch
from tpuzlib_torch import testing
host = np.tile(testing.mixed(32 << 20, seed=1), 8)
big = torch.from_numpy(host).cuda()
out = {}
for name, n in %r.items():
    x, want = big[:n], zlib.crc32(host[:n])
    ms = []
    for _ in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = tpuzlib_torch.crc32(x)
        ms.append((time.perf_counter() - t0) * 1e3)
        assert got == want, name
    out[name] = statistics.median(ms[3:])
print(json.dumps(out))
""" % SIZES


def public_ms(root: str) -> dict:
    r = subprocess.run([sys.executable, "-c", PUBLIC], cwd=root, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit("crc_breakdown: the public crc32 in %s failed:\n%s"
                         % (root, r.stderr[-3000:]))
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("crc_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    old_root = os.path.abspath(sys.argv[1])
    # the earlier checkout's whole library, for its public crc32, builds meanwhile
    old_lib = subprocess.Popen([sys.executable, "-c", "from tpuzlib_torch.kernels import _build;"
                                " _build.lib()"], cwd=old_root)
    procs = [nvcc(os.path.join(old_root, "tpuzlib_torch", "kernels", "csrc", "crc32.cu"),
                  os.path.join(OUT, "libcrc_old.so")),
             nvcc(os.path.join(HERE, "crc32_direct.cu"), os.path.join(OUT, "libcrc_direct.so")),
             nvcc(os.path.join(HERE, "crc32_rounds.cu"), os.path.join(OUT, "libcrc_rounds.so"))]
    text = open(os.path.join(CSRC, "crc32.cu")).read()
    procs += [patched(text, edits, "crc_variant%d" % i, "crc32.cu")
              for i, edits in enumerate(PATCHES.values())]
    _build.lib()
    if any(p.wait() for p in procs + [old_lib]):
        raise SystemExit("crc_breakdown: a build failed")

    big = torch.from_numpy(np.tile(testing.mixed(32 << 20, seed=1), 8)).cuda()
    table, powers = crc32_cuda._constants(big.device)
    # the earlier kernel's span tree: A^(1024 * 2^l), l < 8
    old_cols = powers.view(64, 32)[10:18].contiguous()
    fns = {"earlier kernel": (entry("libcrc_old.so", "tz_crc32_forms", ARGS), old_cols),
           "direct loads, 8 chains a block": (entry("libcrc_direct.so", "tz_crc32_forms", ARGS),
                                              powers),
           "block rounds, 4 blocks a lane": (entry("libcrc_rounds.so", "tz_crc32_forms", ARGS),
                                             powers),
           "slice-by-4, pieces of 128 B, 1 chain, 2 stages (this kernel)":
               (_build.lib().tz_crc32_forms, powers)}
    fns.update({name: (entry("libcrc_variant%d.so" % i, "tz_crc32_forms", ARGS), powers)
                for i, name in enumerate(PATCHES)})
    cases = {"256MiB tile 1": (big, 1), "256MiB tile 256": (big, 256),
             "200KiB tile 1": (big[: 200 << 10], 1)}
    bad = []
    for name, (fn, cols) in fns.items():
        line = {"stage": "variants", "variant": name}
        for case, (x, tile) in cases.items():
            nb = x.numel() // 1024
            out = torch.empty(nb // tile, dtype=torch.int32, device=x.device)
            run = (lambda fn=fn, x=x, out=out, nb=nb, tile=tile, cols=cols:
                   call(fn, x, x.numel(), 0, table, cols, out, nb, tile))
            run()
            same = torch.equal(out, crc32_cuda.crc32_forms(x, 0, tile))
            if not (same or name.startswith(("shifts", "no fold"))):
                bad.append("%s, %s" % (name, case))
            line[case + " ms"] = cuda_ms(run)[0]
        print(json.dumps(line), flush=True)

    for size, n in SIZES.items():
        x = big[:n]
        tile, pad = crc32_cuda._layout(n)
        print(json.dumps({
            "stage": "scalar", "bytes": n, "tile": tile,
            "scalar_ms": cuda_ms(lambda: crc32_cuda.crc32_device_scalar(x))[0],
            "forms_ms": cuda_ms(lambda: crc32_cuda.crc32_forms(x, pad, tile))[0],
            "forms_then_host_tree_host_ms": cuda_ms(lambda: crc32._finish(crc32._combine_blocks(
                crc32_cuda.crc32_forms(x, pad, tile).cpu().numpy().view(np.uint32),
                1024 * tile), n, 0))[1]}), flush=True)

    turns = [public_ms(root) for root in (old_root, ROOT, ROOT, old_root)]
    print(json.dumps({"stage": "public", "host_ms_old": [turns[0], turns[3]],
                      "host_ms_new": [turns[1], turns[2]]}), flush=True)
    if bad:
        raise SystemExit("crc_breakdown: forms differ: %s" % "; ".join(bad))
    return 0


if __name__ == "__main__":
    sys.exit(main())
