"""Compile a shared library on first use and load it with ctypes.

A `Library` is named by a hash of its compiler flags and its sources and
kept in a build directory, so it is compiled once and then reused while
the sources stay the same.  It is written to a temporary file and renamed
into place, so two processes building at once never load half a file.
Both the CUDA kernels (kernels/_build.py, nvcc) and the inflate path's
host code (native/bindings.py, g++) are built this way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable


class Library:
    """compiler(): the compiler's path, asked only when a build is needed;
    flags: its flags (the output and the sources follow them); sources():
    the files hashed into the name, of which all but headers are compiled;
    signatures: entry point -> (restype, argtypes).  Once loaded, `fns`
    maps each entry point of `signatures` to its bound ctypes function,
    read without the lock."""

    def __init__(self, name: str, compiler: Callable[[], str], flags: list,
                 sources: Callable[[], list], build_dir: str, signatures: dict):
        self.name, self.compiler, self.flags = name, compiler, flags
        self.sources, self.build_dir, self.signatures = sources, build_dir, signatures
        self._lock = threading.Lock()
        self._handle = None
        self.fns = None

    def build(self) -> str:
        """Compile unless a library of these exact sources and flags
        exists; returns its path.  Raises with the compiler's output when
        it fails."""
        srcs = self.sources()
        h = hashlib.sha256(" ".join(self.flags).encode())
        for path in srcs:
            h.update(os.path.basename(path).encode())
            with open(path, "rb") as f:
                h.update(f.read())
        so_path = os.path.join(self.build_dir, "lib%s_%s.so" % (self.name, h.hexdigest()[:16]))
        if os.path.exists(so_path):
            return so_path
        compiler = self.compiler()
        os.makedirs(self.build_dir, exist_ok=True)
        tmp = "%s.tmp.%d" % (so_path, os.getpid())
        cmd = [compiler, *self.flags, "-o", tmp,
               *[s for s in srcs if not s.endswith((".h", ".cuh"))]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("%s failed (%d):\n%s%s" % (os.path.basename(compiler),
                                                          res.returncode, res.stdout, res.stderr))
        os.replace(tmp, so_path)
        return so_path

    def __call__(self) -> ctypes.CDLL:
        """The loaded library, built on first use: the lock is taken only
        until it is loaded."""
        if self._handle is None:
            with self._lock:
                if self._handle is None:
                    handle = ctypes.CDLL(self.build())
                    fns = {}
                    for name, (restype, argtypes) in self.signatures.items():
                        fn = fns[name] = getattr(handle, name)
                        fn.restype = restype
                        fn.argtypes = argtypes
                    self.fns = fns
                    self._handle = handle
        return self._handle
