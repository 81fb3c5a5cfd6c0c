"""crc_forms_mm and take_along_loop before and after their redesign, on one
CUDA card.

    python3 probes/forms_breakdown.py OLD_ROOT

OLD_ROOT is a checkout whose crc32_probe.cu has the nvcuda::wmma forms
kernel and whose gather_probe.cu has the take_along_loop of a thread an
element with a % a step (the commit before the redesign, unpacked with
`git archive`).  Builds OLD_ROOT's two sources alone, and copies of this
checkout's crc32_probe.cu changed by the text patches of PATCHES, into
probes/_build/ (one nvcc each, all at once), then prints, after the
card's name and power limit, one JSON object a line:

  forms  crc_forms_mm on 256 MiB of seeded bytes, B 1024 and 4096, every
         tile, both dtypes: device ms of OLD_ROOT's kernel and this
         checkout's in turns old, new, new, old (bare launches queued
         behind a sleep kernel), each output held to the other; the same
         bytes at offset 3 (this checkout's "ldg" route, OLD_ROOT's
         unaligned loads) in turns old_ldg, ldg, ldg, old_ldg; beside them
         this checkout's kernel patched to
           copies      the copies alone: the consumers read their words
                       and release the stage;
           a_build     the copies and the A build, no wgmma;
           mma         the copies and the wgmmas on unbuilt words;
           cluster2, cluster4
                       M's slices multicast to clusters of 2 and 4 CUDA
                       blocks, outputs held to new's;
           l2_256, l2_none
                       the rows' tensor map promoting its L2 fills to 256
                       bytes, or not at all (128 in the kernel), outputs
                       held to new's;
  loop   take_along_loop at the tools' three shapes ((1024, 128) on axis
         1, (1024, 128) and (4352, 128) on axis 0) and one past the staged
         limit, 64 steps: old, new, new, old, outputs held to each other.
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

# ---- the variants of crc32_probe.cu: [(text in the file, its replacement)]

_BUILD_A = "          for (int e = 0; e < 2; ++e) F::build(a[e], w, h + e);\n"
_ARRIVE = "      if (lane == 0) mbar_arrive(&empty[st]);\n    }\n"
# the partial builds keep what they compute live: a store on a compare the
# compiler cannot decide
_SINK = [("    uint32_t a[2][4][4];  // a batch's A: 2 groups of 4 wgmmas\n",
          "    uint32_t a[2][4][4];  // a batch's A: 2 groups of 4 wgmmas\n    uint32_t sink = 0;\n"),
         (_ARRIVE, _ARRIVE + "    if (sink == 0x9E3779B9u) out[0] = 0;\n")]


def _cluster(n: int) -> list:
    """Clusters of n CUDA blocks: each block's producer sends its n-th of
    every slice of M to the whole cluster (TMA multicast), and a stage is
    refilled once the consumers of every block of the cluster have
    released it."""
    return [
        ("__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {\n"
         "  asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\" ::\"r\"(smem_u32(bar)) : \"memory\");\n"
         "}\n",
         "constexpr int kCluster = %d;\n"
         "__device__ __forceinline__ uint32_t cluster_rank() {\n"
         "  uint32_t r;\n"
         "  asm volatile(\"mov.u32 %%0, %%%%cluster_ctarank;\" : \"=r\"(r));\n"
         "  return r;\n"
         "}\n"
         "__device__ __forceinline__ void cluster_sync() {\n"
         "  __syncwarp();\n"
         "  asm volatile(\"barrier.cluster.arrive.release.aligned;\\nbarrier.cluster.wait.acquire.aligned;\"\n"
         "               ::: \"memory\");\n"
         "}\n"
         "// one arrival on the barrier at bar's offset in the cluster's block cta\n"
         "__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t cta) {\n"
         "  asm volatile(\n"
         "      \"{\\n.reg .b32 ra;\\nmapa.shared::cluster.u32 ra, %%0, %%1;\\n\"\n"
         "      \"mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\\n}\" ::\"r\"(smem_u32(bar)),\n"
         "      \"r\"(cta)\n"
         "      : \"memory\");\n"
         "}\n" % n),
        ("\"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\"\n"
         "      ::\"r\"(smem_u32(dst)), \"l\"(src), \"r\"(bytes), \"r\"(smem_u32(bar))\n",
         "\"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster\"\n"
         "      \" [%0], [%1], %2, [%3], %4;\" ::\"r\"(smem_u32(dst)), \"l\"(src), \"r\"(bytes),\n"
         "      \"r\"(smem_u32(bar)), \"h\"(static_cast<uint16_t>((1 << kCluster) - 1))\n"),
        ("mbar_init(&empty[s], kConsumers * 4);", "mbar_init(&empty[s], kCluster * kConsumers * 4);"),
        ("  __syncthreads();\n  if (warp >= kConsumers * 4) {\n",
         "  const uint32_t rank = cluster_rank();\n  cluster_sync();\n"
         "  if (warp >= kConsumers * 4) {\n"),
        ("bulk_copy(buf, mimg + static_cast<long long>(s) * F::kMBytes, F::kMBytes, &full[st]);",
         "bulk_copy(buf + rank * (F::kMBytes / kCluster),\n"
         "                  mimg + static_cast<long long>(s) * F::kMBytes + rank * (F::kMBytes / kCluster),\n"
         "                  F::kMBytes / kCluster, &full[st]);"),
        (_ARRIVE, "      if (lane < kCluster) mbar_arrive(&empty[st], lane);\n    }\n"),
        ("    }\n  }\n}\n\n// gf2_bits_mm: ",
         "    }\n  }\n  cluster_sync();  // no block leaves while its cluster may write to it\n}\n\n"
         "// gf2_bits_mm: "),
        ("  const unsigned blocks = static_cast<unsigned>((nb + kTile - 1) / kTile);\n"
         "  kernel<<<blocks, forms_threads<R>(), kSmem, stream>>>(\n"
         "      map, static_cast<const uint8_t*>(data), nb, block, static_cast<const uint8_t*>(mimg),\n"
         "      static_cast<int32_t*>(out));\n",
         "  cudaLaunchAttribute cluster[1];\n"
         "  cluster[0].id = cudaLaunchAttributeClusterDimension;\n"
         "  cluster[0].val.clusterDim.x = kCluster;\n"
         "  cluster[0].val.clusterDim.y = 1;\n"
         "  cluster[0].val.clusterDim.z = 1;\n"
         "  cudaLaunchConfig_t cfg = {};\n"
         "  cfg.gridDim = dim3(static_cast<unsigned>(\n"
         "      ((nb + kTile - 1) / kTile + kCluster - 1) / kCluster * kCluster));\n"
         "  cfg.blockDim = dim3(forms_threads<R>());\n"
         "  cfg.dynamicSmemBytes = kSmem;\n"
         "  cfg.stream = stream;\n"
         "  cfg.attrs = cluster;\n"
         "  cfg.numAttrs = 1;\n"
         "  const cudaError_t launched = cudaLaunchKernelEx(\n"
         "      &cfg, kernel, map, static_cast<const uint8_t*>(data), nb, block,\n"
         "      static_cast<const uint8_t*>(mimg), static_cast<int32_t*>(out));\n"
         "  if (launched != cudaSuccess) return static_cast<int>(launched);\n"),
    ]


PATCHES = {
    # the consumers read their words and release the stage
    "copies": _SINK + [("          pin(w);  // the build stays after the last batch's wait\n",
                        "          sink ^= w[0] ^ w[1] ^ w[2] ^ w[3];\n          continue;\n")],
    # and build the A fragments, but issue no wgmma
    "a_build": _SINK + [(_BUILD_A, _BUILD_A + "#pragma unroll\n"
                         "          for (int e = 0; e < 2; ++e)\n"
                         "#pragma unroll\n"
                         "            for (int u = 0; u < 4; ++u)\n"
                         "              sink ^= a[e][u][0] ^ a[e][u][1] ^ a[e][u][2] ^ a[e][u][3];\n"
                         "          continue;\n")],
    # the wgmmas on the words themselves, no A build
    "mma": [(_BUILD_A, "#pragma unroll\n"
             "          for (int e = 0; e < 2; ++e)\n"
             "#pragma unroll\n"
             "            for (int u = 0; u < 4; ++u)\n"
             "#pragma unroll\n"
             "              for (int k = 0; k < 4; ++k) a[e][u][k] = w[k];\n")],
    "cluster2": _cluster(2),
    "cluster4": _cluster(4),
    "l2_256": [("CU_TENSOR_MAP_L2_PROMOTION_L2_128B", "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")],
    "l2_none": [("CU_TENSOR_MAP_L2_PROMOTION_L2_128B", "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
}
# outputs held to new's
HELD = ("old", "new", "old_ldg", "ldg", "cluster2", "cluster4", "l2_256", "l2_none")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_ARGS = {"tz_crc_forms_mm": [_P, _L, _I, _I, _I, _P, _P, _P],
            "tz_take_along_loop": [_P, _I, _I, _P, _I, _I, _P, _P]}


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


def caller(fn, *args):
    ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    stream = _build._raw_stream(torch.cuda.current_device())

    def go():
        err = fn(*ptrs, stream)
        if err:
            raise SystemExit("forms_breakdown: a launch was refused (%d)" % err)
    return go


def turns(go: dict, outs: dict, label: dict, pairs=(("old", "new"),)) -> None:
    """Each pair (a, b) of `pairs` in turns a, b, b, a, its speedup the
    ratio of a's two times to b's (the first pair's as "speedup", a later
    one's as b + "_speedup"), then each other variant once; outputs held
    to new's where `outs` names them."""
    for f in go.values():
        f()
    torch.cuda.synchronize()
    for k, o in outs.items():
        if not torch.equal(o, outs["new"]):
            raise SystemExit("forms_breakdown: %s differs from new at %s" % (k, label))
    row = dict(label)
    for i, (a, b) in enumerate(pairs):
        t = [device_ms(go[k]) for k in (a, b, b, a)]
        row[a + "_ms"], row[b + "_ms"] = [t[0], t[3]], [t[1], t[2]]
        row["speedup" if i == 0 else b + "_speedup"] = (t[0] + t[3]) / (t[1] + t[2])
    paired = {k for pair in pairs for k in pair}
    for k in go:
        if k not in paired:
            row[k + "_ms"] = device_ms(go[k])
    print(json.dumps(row), flush=True)


def forms(old, variants, dev) -> None:
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    big = torch.randint(0, 256, (256 << 20,), dtype=torch.uint8, device=dev, generator=g)
    shifted = torch.zeros((256 << 20) + 3, dtype=torch.uint8, device=dev)[3:]
    shifted.copy_(big)
    for dtype, (torch_dtype, code) in cp.DTYPES.items():
        for B in cp.FORM_BLOCKS:
            nb = big.numel() // B
            m_old = cp.form_matrix(B, torch_dtype, dev)
            m_new = cp.card_matrix(B, dtype, dev)
            for tile in cp.TILES:
                outs = {k: torch.empty(nb, 32, dtype=torch.int32, device=dev)
                        for k in ("old", "new", "old_ldg", "ldg", *variants)}
                new = _build.lib.fns["tz_crc_forms_mm"]
                go = {"old": caller(old, big, nb, B, tile, code, m_old, outs["old"]),
                      "new": caller(new, big, nb, B, tile, code, 0, m_new, outs["new"]),
                      "old_ldg": caller(old, shifted, nb, B, tile, code, m_old, outs["old_ldg"]),
                      "ldg": caller(new, shifted, nb, B, tile, code, 1, m_new, outs["ldg"])}
                for k, f in variants.items():
                    go[k] = caller(f, big, nb, B, tile, code, 0, m_new, outs[k])
                turns(go, {k: outs[k] for k in HELD},
                      {"probe": "forms", "dtype": dtype, "B": B, "tile": tile, "MiB": 256},
                      (("old", "new"), ("old_ldg", "ldg")))
                del outs


def loops(old, dev) -> None:
    rng = np.random.default_rng(11)
    staged = gp.staged_words(dev)
    for shape, axis in (((1024, 128), 1), ((1024, 128), 0), ((4352, 128), 0),
                        ((staged + 1, 32), 0)):
        x = torch.from_numpy(rng.integers(-(1 << 31), (1 << 31) - 1, shape,
                                          dtype=np.int32)).to(dev)
        idx = torch.from_numpy(rng.integers(0, shape[axis], shape, dtype=np.int32)).to(dev)
        outs = {k: torch.empty_like(x) for k in ("old", "new")}
        design = gp.loop_design(x, axis)
        go = {"old": caller(old, x, *shape, idx, axis, 64, outs["old"]),
              "new": caller(_build.lib.fns["tz_take_along_loop"], x, *shape, idx, axis, 64,
                            gp.LOOP_DESIGNS.index(design), outs["new"])}
        turns(go, outs, {"probe": "loop", "shape": list(shape), "axis": axis, "iters": 64,
                         "design": design})


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("forms_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    old_csrc = os.path.join(sys.argv[1], "tpuzlib_torch", "kernels", "csrc")
    procs = [nvcc(os.path.join(old_csrc, "crc32_probe.cu"), "forms_old"),
             nvcc(os.path.join(old_csrc, "gather_probe.cu"), "loop_old")]
    with open(os.path.join(CSRC, "crc32_probe.cu")) as f:
        text = f.read()
    for name, patches in PATCHES.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise SystemExit("%r is not once in crc32_probe.cu" % old)
            src = src.replace(old, new)
        path = os.path.join(OUT, "forms_%s.cu" % name)
        with open(path, "w") as f:
            f.write(src)
        procs.append(nvcc(path, "forms_" + name))
    _build.lib()
    if any(p.wait() for p in procs):
        raise SystemExit("forms_breakdown: nvcc failed")
    dev = torch.device("cuda", torch.cuda.current_device())
    new_args = _build._ARGTYPES["tz_crc_forms_mm"]
    variants = {k: entry("forms_" + k, "tz_crc_forms_mm", new_args) for k in PATCHES}
    forms(entry("forms_old", "tz_crc_forms_mm", OLD_ARGS["tz_crc_forms_mm"]), variants, dev)
    loops(entry("loop_old", "tz_take_along_loop", OLD_ARGS["tz_take_along_loop"]), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
