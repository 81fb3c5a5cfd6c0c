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
_build.LAUNCHES (crc_unpack per mode, crc_forms_mm per dtype, and in
FORM_ROUTES per route; gf2_bits_mm in BITS_ROUTES per route); on a CPU
tensor it runs the plain version beside it.  The plain versions are exact (float64 products of 0/1 values) and
work in row slices, so their working memory stays near 512 MiB at any
size.

crc_forms_mm's kernel multiplies in its own K order and, in int8, with
M's rows scaled (csrc/crc32_probe.cu): card_order, card_matrix_rows and
card_image give that order, M's rows in it and their image in the
kernel's shared-memory layout; card_forms_plain replays the kernel's
arithmetic on the host; forms_route gives the route of its rows.
gf2_bits_mm's kernel splits K over a cluster of CUDA blocks whose leader
adds the others' sums, exact in any order (every partial sum is an
integer below 2^24); bits_mm_route gives the route of its bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .crc32 import plane_matrix_bits
from .deflate_device3 import _as_i32

FORM_BLOCKS = (1024, 4096)  # bytes a block of crc_forms_mm
TILES = (256, 512, 1024)  # blocks a CUDA block of crc_forms_mm (the tools' tiles)
DTYPES = {"bf16": (torch.bfloat16, 0), "i8": (torch.int8, 1)}
MODES = {"u8": 1, "i32": 2, "bf16": 3}  # crc_unpack; mode 0 is crc_rowsum
MAX_ROW = 1 << 23  # a row's byte sum stays below 2^31
BITS_K = 128  # gf2_bits_mm's K is a multiple of this
SLICE = 32  # bytes of each row in a K slice of crc_forms_mm's kernel
# the routes of crc_forms_mm's rows and gf2_bits_mm's bits, by the code the
# kernel takes: by TMA (on a 16-byte boundary), or loaded by the consumers
# (any offset)
ROUTES = ("tma", "ldg")
FORM_ROUTES = {route: 0 for route in ROUTES}  # crc_forms_mm's launches by route
BITS_ROUTES = {route: 0 for route in ROUTES}  # gf2_bits_mm's launches by route (its bits')
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


def bits_mm_route(bits: torch.Tensor) -> str:
    """The route of gf2_bits_mm's bits on the card: "tma" where they start
    on a 16-byte boundary (what a TMA tensor map takes; a row's pitch, 2K
    bytes, is a multiple of 256), else "ldg", the kernel's consumers loading
    the rows' words themselves."""
    return "tma" if bits.data_ptr() % 16 == 0 else "ldg"


def gf2_bits_mm(bits: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """int32[nb, 32]: (bits @ m) & 1 for 0/1 entries; bits bf16 (nb, K),
    m bf16 (K, 32); the bits go by the route bits_mm_route gives."""
    if _build.on_cpu(bits):
        return gf2_bits_mm_plain(bits, m)
    _check_bits(bits, m)
    if m.data_ptr() % 32:
        raise ValueError("gf2_bits_mm: m must start on a 32-byte boundary")
    out = torch.empty(bits.shape[0], 32, dtype=torch.int32, device=bits.device)
    if bits.shape[0]:
        route = bits_mm_route(bits)
        _build.launch("gf2_bits_mm", "tz_gf2_bits_mm", bits.device, bits.data_ptr(),
                      bits.shape[0], bits.shape[1], ROUTES.index(route), m.data_ptr(),
                      out.data_ptr())
        BITS_ROUTES[route] += 1
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


def forms_route(blocks: torch.Tensor) -> str:
    """The route of crc_forms_mm's rows on the card: "tma" where they start
    on a 16-byte boundary (what a TMA tensor map takes; the rows are
    contiguous and every B of FORM_BLOCKS a multiple of 16), else "ldg",
    the kernel's consumers loading the rows' words themselves."""
    return "tma" if blocks.data_ptr() % 16 == 0 else "ldg"


def card_order(block: int, dtype: str) -> tuple:
    """(plane, byte) of each K row of crc_forms_mm's product on the card,
    in the kernel's order: slice s (SLICE bytes of each row), wgmma q of
    the slice, element k of its K; bf16: q = 8c + i, bit i of byte 32s +
    16c + 4(k % 8 // 2) + k % 2 + 2(k // 8); int8: q = i, bit i of byte
    32s + k.  Two int64 arrays of 8 * block."""
    s = np.arange(block // SLICE)[:, None, None]
    if dtype == "bf16":
        q, k = np.arange(16)[None, :, None], np.arange(16)[None, None, :]
        plane = q % 8
        byte = SLICE * s + 16 * (q // 8) + 4 * (k % 8 // 2) + k % 2 + 2 * (k // 8)
    else:
        plane, k = np.arange(8)[None, :, None], np.arange(32)[None, None, :]
        byte = SLICE * s + k + 0 * plane
    return np.broadcast_to(plane, byte.shape).reshape(-1), byte.reshape(-1)


def _wrap8(x):
    """int8's two's-complement wrap of integers (128 -> -128)."""
    return (x + 128) % 256 - 128


def card_matrix_rows(block: int, dtype: str) -> np.ndarray:
    """M_B's rows in card_order, int64 (8 * block, 32), as the kernel holds
    them: 0 / 1 in bf16; in int8 bit i's row times 2^(7 - i), wrapped to
    int8 (128 as -128), so that each product is 128 x bit x M mod 256."""
    plane, byte = card_order(block, dtype)
    m = plane_matrix_bits(block)[plane * block + byte].astype(np.int64)
    return _wrap8(m << (7 - plane[:, None])) if dtype == "i8" else m


@functools.lru_cache(maxsize=None)
def card_image(block: int, dtype: str) -> np.ndarray:
    """card_matrix_rows as the kernel's bulk copies take it, uint8: slice
    after slice (256 K rows each), each wgmma's B in wgmma's K-major
    layout with the 128-byte swizzle: boxes of 32 rows (the columns) x 128
    bytes of K, 16-byte chunk j of row n at chunk j ^ (n % 8)."""
    rows = card_matrix_rows(block, dtype)
    size = 2 if dtype == "bf16" else 1
    kk = np.arange(rows.shape[0])
    at = (kk % 256) * size  # the K row's byte in its slice's B
    n = np.arange(32)[None, :]
    off = ((kk // 256) * 256 * 32 * size)[:, None] + (at // 128 * 4096)[:, None] + n * 128 + \
        ((((at % 128) >> 4)[:, None] ^ (n & 7)) << 4) + (at % 128 & 15)[:, None]
    if dtype == "bf16":
        vals = torch.from_numpy(rows.astype(np.float32)).to(torch.bfloat16).view(torch.int16).numpy()
        img = np.zeros(rows.size, np.int16)
    else:
        vals, img = rows.astype(np.int8), np.zeros(rows.size, np.int8)
    img[off // size] = vals
    return img.view(np.uint8)


@functools.lru_cache(maxsize=None)
def card_matrix(block: int, dtype: str, device: torch.device) -> torch.Tensor:
    """card_image on `device`, the M operand of crc_forms_mm's kernel."""
    return torch.from_numpy(card_image(block, dtype)).to(device)


def card_forms_plain(blocks: torch.Tensor, dtype: str = "bf16") -> torch.Tensor:
    """crc_forms_mm's columns by the card kernel's arithmetic: each row's
    bits in card_order as its A fragments hold them (bf16: 0 / 1; int8: the
    bit times 2^i, wrapped to int8), times card_matrix_rows, exact in
    float64, and the kernel's parity: bit 0 of the sum in bf16, bit 7 in
    int8."""
    _check_forms(blocks, dtype, TILES[0])
    B = blocks.shape[1]
    plane, byte = (torch.from_numpy(np.ascontiguousarray(a)) for a in card_order(B, dtype))
    m = torch.from_numpy(card_matrix_rows(B, dtype)).to(blocks.device, torch.float64)

    def part(c):
        a = (c[:, byte.to(c.device)].long() >> plane.to(c.device)) & 1
        if dtype == "i8":
            a = _wrap8(a << plane.to(c.device))
        s = (a.double() @ m).long()
        return ((s >> 7) & 1 if dtype == "i8" else s & 1).int()

    return _by_rows(part, blocks, 100 * B)


def crc_forms_mm(blocks: torch.Tensor, dtype: str = "bf16", tile: int = 256) -> torch.Tensor:
    """int32[nb, 32]: the parity columns of bits(block) @ M_B for the rows
    of blocks, uint8 (nb, B) with B 1024 or 4096, on the tensor cores in
    `dtype` (bf16 or i8), `tile` blocks a CUDA block; the rows go by the
    route forms_route gives."""
    if _build.on_cpu(blocks):
        return crc_forms_mm_plain(blocks, dtype, tile)
    _check_forms(blocks, dtype, tile)
    nb, B = blocks.shape
    out = torch.empty(nb, 32, dtype=torch.int32, device=blocks.device)
    if nb:
        route = forms_route(blocks)
        m = card_matrix(B, dtype, blocks.device)
        _build.launch("crc_forms_mm_" + dtype, "tz_crc_forms_mm", blocks.device,
                      blocks.data_ptr(), nb, B, tile, DTYPES[dtype][1], ROUTES.index(route),
                      m.data_ptr(), out.data_ptr())
        FORM_ROUTES[route] += 1
    return out


def pack_forms(cols: torch.Tensor) -> torch.Tensor:
    """int32[nb]: the parity columns (nb, 32) packed to raw linear forms,
    bit c from column c, as int32 bit patterns (crc32_pallas.py:63-65)."""
    weights = torch.ones(32, dtype=torch.int64, device=cols.device) << torch.arange(
        32, device=cols.device)
    return _as_i32((cols.long() * weights).sum(1))
