"""The port's host C++ library (tpuzlib_torch_native.cc), built with g++
on first use (bindings.py) and required: the host inflate and deflate
engines' hot loops, the checksums on the host, the header scans and the
token expansion."""
