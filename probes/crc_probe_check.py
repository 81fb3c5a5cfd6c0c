"""Show the registers, shared memory and spills of a kernel source.

    python3 probes/crc_probe_check.py [SOURCE] [--sass]

On a machine with `nvcc`, from the repo root.  It compiles
tpuzlib_torch/kernels/csrc/SOURCE (crc32_probe.cu by default; crc32.cu
for the CRC kernel) alone, with the kernel library's flags and
`-Xptxas -v`, into probes/_build/ and prints ptxas's line for each
kernel's registers and shared memory, every line that reports a spill
other than none, and every warning (ptxas names a wgmma it serialises).
Exits non-zero when the file does not compile.  With --sass it also
reads the object with `cuobjdump -sass` and prints, for each row kernel
(crc_rowsum_kernel<mode>), one JSON line of its loads, integer, bf16 and
conversion steps (ROW_OPS) and all its instructions, and for each
crc_forms_mm kernel one of its instruction counts: HGMMA
and IGMMA (one a bf16 or int8 wgmma), LDSM (ldmatrix), the integer steps LOP3, IMAD, PRMT,
SHF, IADD3, and `build_per_a_register`, (LOP3 + IMAD + PRMT) over the
four A registers of each wgmma: an upper bound on the A build's steps a
register (the kernel's addresses and loop counters count too).
The kernels' checks are the card tests' (tests/test_torch_cuda.py,
test_torch_cuda_crc.py, test_torch_cuda_forms.py), their times
chip_smoke's phases A and H.
"""

import collections
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpuzlib_torch.kernels import _build  # noqa: E402

OPS = ("HGMMA", "IGMMA", "LDSM", "LOP3", "IMAD", "PRMT", "SHF", "IADD3")
# the row kernels' (crc_rowsum and crc_unpack's modes) steps besides
ROW_OPS = ("LDG", "PRMT", "LOP3", "IMAD", "SHF", "IADD3", "IDP", "HADD2", "HFMA2", "I2F", "F2I",
           "F2FP", "VABSDIFF4")


def sass_counts(obj: str) -> None:
    """One JSON line of OPS counts for each crc_forms_mm kernel in obj."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", obj], capture_output=True, text=True,
                          check=True).stdout
    name, counts = None, collections.Counter()

    def flush():
        if name and "crc_rowsum_kernel" in name:
            print(json.dumps({"kernel": name, **{op: counts[op] for op in ROW_OPS},
                              "instructions": sum(counts.values())}), flush=True)
        if name and "crc_forms_mm_kernel" in name:
            row = {"kernel": name, **{op: counts[op] for op in OPS}}
            wgmmas = counts["HGMMA"] + counts["IGMMA"]
            row["build_per_a_register"] = (counts["LOP3"] + counts["IMAD"] + counts["PRMT"]) / max(
                1, 4 * wgmmas)
            print(json.dumps(row), flush=True)

    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            flush()
            name, counts = m.group(1), collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m:
            counts[m.group(1)] += 1
    flush()


def main(argv) -> int:
    args = [a for a in argv if a != "--sass"]
    source = args[0] if args else "crc32_probe.cu"
    out = os.path.join(ROOT, "probes", "_build")
    os.makedirs(out, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    obj = os.path.join(out, source[:-3] + ".o")
    r = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v", "-c",
                        os.path.join(ROOT, "tpuzlib_torch", "kernels", "csrc", source),
                        "-o", obj], capture_output=True, text=True)
    text = r.stdout + r.stderr
    print("ptxas rc", r.returncode, flush=True)
    for line in text.splitlines():
        if any(k in line for k in ("registers", "smem", "arning", "entry function")) or (
                "error" in line.lower()) or ("spill" in line and " 0 bytes spill stores" not in line):
            print(line, flush=True)
    if r.returncode:
        return 1
    if "--sass" in argv:
        sass_counts(obj)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
