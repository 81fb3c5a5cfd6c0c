"""Show the registers, shared memory and spills of a kernel source.

    python3 probes/crc_probe_check.py [SOURCE]

On a machine with `nvcc`, from the repo root.  It compiles
tpuzlib_torch/kernels/csrc/SOURCE (crc32_probe.cu by default; crc32.cu
for the CRC kernel) alone, with the kernel library's flags and
`-Xptxas -v`, into probes/_build/ and prints ptxas's line for each
kernel's registers and shared memory, and every line that reports a
spill other than none.  Exits non-zero when the file does not compile.
The kernels' checks are the card tests' (tests/test_torch_cuda.py,
test_torch_cuda_crc.py), their times chip_smoke's phases A and H.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpuzlib_torch.kernels import _build  # noqa: E402


def main(argv) -> int:
    source = argv[0] if argv else "crc32_probe.cu"
    out = os.path.join(ROOT, "probes", "_build")
    os.makedirs(out, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    r = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v", "-c",
                        os.path.join(ROOT, "tpuzlib_torch", "kernels", "csrc", source),
                        "-o", os.path.join(out, source[:-3] + ".o")], capture_output=True, text=True)
    text = r.stdout + r.stderr
    print("ptxas rc", r.returncode, flush=True)
    for line in text.splitlines():
        if "registers" in line or "smem" in line or "error" in line.lower() or (
                "spill" in line and " 0 bytes spill stores" not in line):
            print(line, flush=True)
    return 1 if r.returncode else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
