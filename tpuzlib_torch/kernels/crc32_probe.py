"""The CRC-32 probe kernels: the read floor, the bit unpack and the GF(2)
bit-plane product on the tensor cores (csrc/crc32_probe.cu).

Counterparts of the Pallas kernels of tools/probe_crc.py, probe_crc2.py
and probe_crc3.py, which the probes in tpuzlib_torch/tools drive:

  crc_rowsum(x)          int32 row sums of u8 rows (nb, row): the read
                         floor (probe_crc2's mk_sum_kernel, one int32 a
                         row where the TPU broadcast each sum over 128
                         lanes);
  crc_unpack(x, mode)    the 8 bit planes of each byte summed in u8, i32
                         or bf16, then int32 row sums (mk_unpack_kernel):
                         every mode gives the rows' bit counts;
  gf2_bits_mm(bits, m)   (bits @ m) & 1 on bf16 0/1 bits unpacked
                         beforehand (probe_crc2's mm_kernel);
  crc_forms_mm(blocks, dtype, tile)
                         the int32 parity columns of bits(block) @ M_B in
                         bf16 or int8 (probe_crc.make_forms_kernel in all
                         four modes, probe_crc3.make_forms_seeded), with
                         M_B = crc32.plane_matrix_bits(B); pack_forms packs
                         them to the raw linear forms of crc32.py.

The tools' plane and cat modes compute the same product in the same K
order (K = i * B + j for bit i of byte j) and differ only in feeding the
TPU's compiler eight dots or one; on the card they are one kernel per
dtype.  `tile` is the number of blocks a CUDA block owns.

On a CUDA tensor each wrapper launches its kernel and counts it in
_build.LAUNCHES (crc_unpack per mode, crc_forms_mm per dtype); on a CPU
tensor it runs the plain version beside it.  The plain versions are exact
(float64 products of 0/1 values) and work in row slices, so their
working memory stays near 512 MiB at any size.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .crc32 import plane_matrix_bits
from .deflate_device3 import _as_i32

FORM_BLOCKS = (1024, 4096)  # bytes a block of crc_forms_mm
TILES = (256, 512, 1024)  # blocks a CUDA block of crc_forms_mm (the tools' tiles)
DTYPES = {"bf16": (torch.bfloat16, 0), "i8": (torch.int8, 1)}
MODES = {"u8": 1, "i32": 2, "bf16": 3}  # crc_unpack; mode 0 is crc_rowsum
MAX_ROW = 1 << 23  # a row's byte sum stays below 2^31
BITS_K = 128  # gf2_bits_mm's K is a multiple of this (16 for each of its 8 warps)
_WORK = 1 << 29  # bytes a plain version works on at once


def _by_rows(fn, x: torch.Tensor, work_per_row: int) -> torch.Tensor:
    """fn over row slices of x of about _WORK working bytes, concatenated."""
    step = max(1, _WORK // work_per_row)
    parts = [fn(x[i : i + step]) for i in range(0, x.shape[0], step)]
    return torch.cat(parts) if parts else fn(x)


def _check_2d(name: str, x: torch.Tensor, dtype: torch.dtype) -> None:
    if x.dtype != dtype:
        raise TypeError("%s: expected a %s tensor, got %s" % (name, dtype, x.dtype))
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("%s: expected a 2-D contiguous tensor, got shape %s"
                         % (name, tuple(x.shape)))


def _check_rows(name: str, x: torch.Tensor) -> None:
    _check_2d(name, x, torch.uint8)
    if not 0 < x.shape[1] <= MAX_ROW:
        raise ValueError("%s: rows of 1 to %d bytes, got %d" % (name, MAX_ROW, x.shape[1]))


def crc_rowsum_plain(x: torch.Tensor) -> torch.Tensor:
    _check_rows("crc_rowsum", x)
    return _by_rows(lambda c: c.long().sum(1).int(), x, 9 * x.shape[1])


def crc_rowsum(x: torch.Tensor) -> torch.Tensor:
    """int32[nb]: the byte sums of the rows of x, uint8 (nb, row)."""
    if _build.on_cpu(x):
        return crc_rowsum_plain(x)
    _check_rows("crc_rowsum", x)
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    if x.shape[0]:
        _build.launch("crc_rowsum", "tz_crc_rowsum", x.device, x.data_ptr(), x.shape[0],
                      x.shape[1], 0, out.data_ptr())
    return out


def _unpack_rows(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "u8":
        acc = torch.zeros_like(x)
        for i in range(8):
            acc += (x >> i) & 1
    else:
        raw = x.int()
        acc = torch.zeros(x.shape, dtype=torch.int32 if mode == "i32" else torch.bfloat16,
                          device=x.device)
        for i in range(8):
            acc += ((raw >> i) & 1).to(acc.dtype)
    return acc.int().sum(1, dtype=torch.int32)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError("crc_unpack: mode must be one of %s, got %r" % (sorted(MODES), mode))


def crc_unpack_plain(x: torch.Tensor, mode: str) -> torch.Tensor:
    _check_rows("crc_unpack", x)
    _check_mode(mode)
    return _by_rows(lambda c: _unpack_rows(c, mode), x, 16 * x.shape[1])


def crc_unpack(x: torch.Tensor, mode: str) -> torch.Tensor:
    """int32[nb]: the rows' bit counts, each byte's 8 bit planes summed in
    `mode`'s type (u8, i32 or bf16), then the row's int32 sum."""
    if _build.on_cpu(x):
        return crc_unpack_plain(x, mode)
    _check_rows("crc_unpack", x)
    _check_mode(mode)
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    if x.shape[0]:
        _build.launch("crc_unpack_" + mode, "tz_crc_rowsum", x.device, x.data_ptr(), x.shape[0],
                      x.shape[1], MODES[mode], out.data_ptr())
    return out


def _check_bits(bits: torch.Tensor, m: torch.Tensor) -> None:
    _check_2d("gf2_bits_mm", bits, torch.bfloat16)
    _check_2d("gf2_bits_mm", m, torch.bfloat16)
    K = bits.shape[1]
    if K == 0 or K % BITS_K or tuple(m.shape) != (K, 32):
        raise ValueError("gf2_bits_mm: bits (nb, K) with K a multiple of %d and m (K, 32), got "
                         "%s and %s" % (BITS_K, tuple(bits.shape), tuple(m.shape)))
    if m.device != bits.device:
        raise ValueError("gf2_bits_mm: tensors must share one device (%s vs %s)"
                         % (bits.device, m.device))


def gf2_bits_mm_plain(bits: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    _check_bits(bits, m)
    md = m.double()
    return _by_rows(lambda c: ((c.double() @ md).long() & 1).int(), bits, 10 * bits.shape[1])


def gf2_bits_mm(bits: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """int32[nb, 32]: (bits @ m) & 1 for 0/1 entries; bits bf16 (nb, K),
    m bf16 (K, 32)."""
    if _build.on_cpu(bits):
        return gf2_bits_mm_plain(bits, m)
    _check_bits(bits, m)
    if m.data_ptr() % 32:
        raise ValueError("gf2_bits_mm: m must start on a 32-byte boundary")
    out = torch.empty(bits.shape[0], 32, dtype=torch.int32, device=bits.device)
    if bits.shape[0]:
        _build.launch("gf2_bits_mm", "tz_gf2_bits_mm", bits.device, bits.data_ptr(),
                      bits.shape[0], bits.shape[1], m.data_ptr(), out.data_ptr())
    return out


@functools.lru_cache(maxsize=None)
def form_matrix(block: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """M_B, plane-major, as a (8 * block, 32) tensor of `dtype` on `device`."""
    return torch.from_numpy(plane_matrix_bits(block)).to(device=device, dtype=dtype)


def _check_forms(blocks: torch.Tensor, dtype: str, tile: int) -> None:
    _check_2d("crc_forms_mm", blocks, torch.uint8)
    if blocks.shape[1] not in FORM_BLOCKS:
        raise ValueError("crc_forms_mm: blocks of %s bytes, got %d"
                         % (FORM_BLOCKS, blocks.shape[1]))
    if dtype not in DTYPES:
        raise ValueError("crc_forms_mm: dtype must be one of %s, got %r" % (sorted(DTYPES), dtype))
    if tile not in TILES:
        raise ValueError("crc_forms_mm: tile must be one of %s, got %r" % (TILES, tile))


def plane_bits(x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The bits of the rows of x, uint8 (nb, row), plane-major: (nb, 8 * row)
    with bit i of byte j at i * row + j, in `dtype` (gf2_bits_mm's input)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device).view(1, 8, 1)
    return ((x.unsqueeze(1) >> shifts) & 1).reshape(x.shape[0], 8 * x.shape[1]).to(dtype)


def crc_forms_mm_plain(blocks: torch.Tensor, dtype: str = "bf16", tile: int = 256) -> torch.Tensor:
    """The exact product in float64: the same for both dtypes and every tile."""
    _check_forms(blocks, dtype, tile)
    B = blocks.shape[1]
    md = form_matrix(B, torch.float64, blocks.device)
    return _by_rows(lambda c: ((plane_bits(c, torch.float64) @ md).long() & 1).int(), blocks,
                    80 * B)


def crc_forms_mm(blocks: torch.Tensor, dtype: str = "bf16", tile: int = 256) -> torch.Tensor:
    """int32[nb, 32]: the parity columns of bits(block) @ M_B for the rows
    of blocks, uint8 (nb, B) with B 1024 or 4096, on the tensor cores in
    `dtype` (bf16 or i8), `tile` blocks a CUDA block."""
    if _build.on_cpu(blocks):
        return crc_forms_mm_plain(blocks, dtype, tile)
    _check_forms(blocks, dtype, tile)
    nb, B = blocks.shape
    torch_dtype, code = DTYPES[dtype]
    m = form_matrix(B, torch_dtype, blocks.device)
    out = torch.empty(nb, 32, dtype=torch.int32, device=blocks.device)
    if nb:
        _build.launch("crc_forms_mm_" + dtype, "tz_crc_forms_mm", blocks.device,
                      blocks.data_ptr(), nb, B, tile, code, m.data_ptr(), out.data_ptr())
    return out


def pack_forms(cols: torch.Tensor) -> torch.Tensor:
    """int32[nb]: the parity columns (nb, 32) packed to raw linear forms,
    bit c from column c, as int32 bit patterns (crc32_pallas.py:63-65)."""
    weights = torch.ones(32, dtype=torch.int64, device=cols.device) << torch.arange(
        32, device=cols.device)
    return _as_i32((cols.long() * weights).sum(1))
