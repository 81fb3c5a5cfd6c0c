"""Show the registers, shared memory and spills of the CRC probe kernels.

    python3 probes/crc_probe_check.py

On a machine with `nvcc`, from the repo root.  It compiles
tpuzlib_torch/kernels/csrc/crc32_probe.cu alone, with the kernel library's
flags and `-Xptxas -v`, into probes/_build/ and prints ptxas's line for
each kernel's registers, and every line that reports a spill other than
none.  Exits non-zero when the file does not compile.  The kernels'
checks are the card tests' (tests/test_torch_cuda.py), their times
chip_smoke's phase H.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpuzlib_torch.kernels import _build  # noqa: E402


def main() -> int:
    out = os.path.join(ROOT, "probes", "_build")
    os.makedirs(out, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    r = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v", "-c",
                        os.path.join(ROOT, "tpuzlib_torch", "kernels", "csrc", "crc32_probe.cu"),
                        "-o", os.path.join(out, "crc32_probe.o")], capture_output=True, text=True)
    text = r.stdout + r.stderr
    print("ptxas rc", r.returncode, flush=True)
    for line in text.splitlines():
        if "registers" in line or "error" in line.lower() or (
                "spill" in line and " 0 bytes spill stores" not in line):
            print(line, flush=True)
    return 1 if r.returncode else 0


if __name__ == "__main__":
    sys.exit(main())
