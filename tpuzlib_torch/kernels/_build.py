"""Build, load and launch the port's CUDA kernels.

All `csrc/*.cu` files are compiled by one `nvcc` call into a shared
library with a plain C interface, named by a hash of the sources and kept
under `_build/` next to this file; it is built on first use and loaded
with ctypes (`_clib.Library`).  Every C entry point launches on the stream it is given and
returns `cudaGetLastError()`; `launch` raises when that is not 0.

`launch` is the path of every kernel call, so it does as little as
aten's own launch: the entry points are resolved once, when the library
is loaded; the stream is PyTorch's current stream on the tensor's device,
read as a raw handle on every call; the device guard is entered only for
a device other than the current one.

`LAUNCHES` counts, per kernel, the launches that reached the card: each
wrapper adds one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os

import torch

from .._clib import Library

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
# C entry point -> argument types (pointers and the stream are c_void_p);
# each returns a cudaError_t as int
_ARGTYPES = {
    "tz_near_screen": [_P, _P, _P, _P, _I, _I, _P],
    "tz_far_screen": [_P, _P, _P, _P, _I, _I, _P],
    "tz_segment_parse": [_P, _P, _I, _I, _I, _P],
    "tz_pack_words": [_P] * 12 + [_I] * 3 + [_P],
    "tz_crc32_forms": [_P, _L, _L, _P, _P, _P, _L, _I, _P],
    "tz_crc32_scalar": [_P, _L, _L, _P, _P, _P, _P, _P, _L, _I, _U, _P],
    "tz_crc32_segments": [_P, _L, _P, _I, _P, _P, _P, _P],
    "tz_adler32_blocks": [_P, _L, _L, _P, _L, _P],
    "tz_adler32_scalar": [_P, _L, _L, _L, _L, _P, _P, _U, _P, _P],
    "tz_inflate_lut": [_P, _P, _P, _I, _I, _I, _P, _P],
    "tz_inflate_decode": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "tz_header_scan": [_P, _L, _L, _L, _I, _P, _I, _P, _P],
    "tz_crc_rowsum": [_P, _L, _I, _I, _P, _P],
    "tz_crc_forms_mm": [_P, _L, _I, _I, _I, _I, _P, _P, _P],
    "tz_gf2_bits_mm": [_P, _L, _I, _I, _P, _P, _P],
    "tz_take_along": [_P, _I, _I, _P, _I, _I, _I, _I, _P, _P],
    "tz_take_along_loop": [_P, _I, _I, _P, _I, _I, _I, _P, _P],
    "tz_flat_gather": [_P, _L, _P, _L, _P, _P],
    "tz_scatter_max": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "tz_shift_screen": [_P, _I, _L, _I, _I, _P, _P],
    "tz_vec_cond_while": [_P, _I, _I, _P, _P],
    "tz_fetch_rows": [_P, _I, _I, _P, _I, _P, _P],
    "tz_row_store_loop": [_I, _I, _P, _P],
    "tz_gather_store_loop": [_P, _I, _I, _P, _I, _P, _P],
    "tz_col_min_sum": [_P, _I, _I, _P, _P],
    "tz_var_shifts": [_P, _P, _I, _P, _P],
    "tz_tree_decode": [_P, _P, _P, _P, _I, _P, _P],
    "tz_window64": [_P, _P, _P, _P, _P, _I, _P, _P],
}
_SIGNATURES = {**{name: (_I, args) for name, args in _ARGTYPES.items()},
               "tz_error_string": (ctypes.c_char_p, [_I]),
               # the widest source the gathers stage in shared memory, in words
               "tz_gather_staged_words": (_I, [])}

# the CRC kernel counts its two modes apart: per-block forms, span forms;
# a launch that also finishes the CRC counts as crc32_scalar and under the
# mode its fold runs in (one kernel, two modes); the Adler-32 scalar is a
# kernel of its own and counts only as adler32_scalar;
# pack_words' one launch is its two kernels (tile sums, then the words);
# the probes' unpack counts each mode apart, their forms each dtype;
# vec_cond_while counts each launch under its route's name as well;
# the header scan's one call launches and counts its two kernels
LAUNCHES = {"near_screen": 0, "far_screen": 0, "segment_parse": 0, "pack_words": 0,
            "crc32_forms": 0, "crc32_spans": 0, "crc32_scalar": 0, "crc32_segments": 0,
            "adler32": 0,
            "adler32_scalar": 0, "inflate_lut": 0, "inflate_decode": 0, "header_filter": 0,
            "header_parse": 0, "crc_rowsum": 0, "crc_unpack_u8": 0, "crc_unpack_i32": 0,
            "crc_unpack_bf16": 0, "gf2_bits_mm": 0, "crc_forms_mm_bf16": 0,
            "crc_forms_mm_i8": 0, "take_along": 0, "take_along_loop": 0, "flat_gather": 0,
            "scatter_max": 0, "shift_screen": 0, "vec_cond_while": 0, "vec_cond_while_regs": 0,
            "vec_cond_while_smem": 0, "vec_cond_while_global": 0, "fetch_rows": 0,
            "row_store_loop": 0, "gather_store_loop": 0, "col_min_sum": 0, "var_shifts": 0,
            "tree_decode": 0, "window64": 0}

def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")) + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


# lib(): the loaded kernel library, built on first use; lib.build(): its path
lib = Library("tpuzlib_torch", _nvcc, NVCC_FLAGS, sources, _BUILD_DIR, _SIGNATURES)
build = lib.build

# PyTorch's current stream of a device as a raw cudaStream_t (what torch's
# generated code reads), and the current device's index; a CPU build of
# torch has neither, and never launches
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream",
                      lambda index: torch.cuda.current_stream(index).cuda_stream)
_current_device = getattr(torch._C, "_cuda_getDevice", lambda: torch.cuda.current_device())


def device_index(device) -> int:
    """The CUDA index of `device`: an int, or a torch.device (the current
    device where it names none)."""
    if device.__class__ is int:
        return device
    index = device.index
    return _current_device() if index is None else index


def launch(kernel, entry: str, device, *args) -> None:
    """Call C entry point `entry` on `device`'s current stream (`device`: a
    CUDA index or a torch.device); count one launch of `kernel` (a name,
    or a tuple of the names it counts under).  Raises when the launch was
    refused."""
    fns = lib.fns
    if fns is None:
        lib()
        fns = lib.fns
    index = device_index(device)
    if index == _current_device():
        err = fns[entry](*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fns[entry](*args, _raw_stream(index))
    if err:
        raise RuntimeError(
            "%s launch failed: %s" % (kernel, fns["tz_error_string"](err).decode())
        )
    if kernel.__class__ is str:
        LAUNCHES[kernel] += 1
    else:
        for name in kernel:
            LAUNCHES[name] += 1


@functools.lru_cache(maxsize=None)
def _ticket(index: int, stream: int) -> torch.Tensor:
    return torch.zeros(1, dtype=torch.int32, device=torch.device("cuda", index))


def ticket(device) -> torch.Tensor:
    """The ticket of `device`'s current stream, for a kernel whose last CUDA
    block finishes its work (crc32_scalar, adler32_scalar): one int32, 0
    between calls (that last CUDA block resets it), so calls on one stream
    share it in turn and calls on two streams never do."""
    index = device_index(device)
    return _ticket(index, _raw_stream(index))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the caller runs its plain version), False for
    a CUDA tensor (the caller launches its kernel); raises otherwise."""
    if t.is_cpu:
        return True
    if not t.is_cuda:
        raise ValueError("no kernel for tensors on %s" % t.device)
    return False


def check_inputs(name: str, shape: tuple, *tensors: torch.Tensor, dtype=torch.int32,
                 device=None) -> None:
    """Raise unless every tensor has `shape`, is of `dtype` (int32),
    contiguous and on `device` (the first tensor's)."""
    device = tensors[0].device if device is None else device
    for t in tensors:
        if tuple(t.shape) != tuple(shape):
            raise ValueError("%s: expected shape %s, got %s" % (name, tuple(shape), tuple(t.shape)))
        if t.device != device:
            raise ValueError("%s: tensors must share one device (%s vs %s)" % (name, t.device, device))
        if t.dtype != dtype:
            raise TypeError("%s: expected %s tensors, got %s" % (name, dtype, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: tensors must be contiguous" % name)


def check_bytes(name: str, t: torch.Tensor) -> None:
    """Raise unless `t` is a 1-D contiguous uint8 tensor."""
    if t.dtype != torch.uint8:
        raise TypeError("%s: expected a uint8 tensor, got %s" % (name, t.dtype))
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError("%s: expected a 1-D contiguous tensor, got shape %s"
                         % (name, tuple(t.shape)))
