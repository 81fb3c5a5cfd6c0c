"""The port's host C++ library (tpuzlib_torch_native.cc), built with g++
on first use (bindings.py) and required while it is switched on: the
host inflate and deflate engines' hot loops, the checksums on the host,
the header scans and the token expansion.  While
bindings.set_native(False) has it off, every call site takes tpuzlib's
numpy branch instead."""

from .bindings import get_lib, native_available

__all__ = ["get_lib", "native_available"]
