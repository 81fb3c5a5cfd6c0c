"""The gather and primitive probe kernels (csrc/gather_probe.cu).

Counterparts of the Pallas kernels of tools/probe_gather.py and
tools/probe_primitives.py, which the probes in tpuzlib_torch/tools drive;
all take and give int32 (uint32 values pass as their bits):

  take_along(x, idx, axis, fill)
                   jnp.take_along_axis on a 2-D x (probe_gather's lane and
                   sublane gathers, probe_primitives' k_tala and k_tala0,
                   and the sublane gathers of the inflate probes): the
                   output has idx's shape; an index in [-n, 0) counts from
                   the end, any other outside [0, n) gives `fill` (jnp's:
                   INT32_MIN for int32, -1 for uint32 bits);
  take_along_loop(x, idx, axis, iters)
                   the int32 sum of take_along(x, (idx + t) mod n, axis)
                   over t < iters (probe_gather's loop_cost); on the card
                   x's lines along the axis are staged in shared memory
                   where they are at most staged_words() long
                   (loop_design; LOOP_ROUTES counts the launches of each);
  flat_gather(table, idx)
                   table.reshape(-1)[idx] (k_flatgather): an index below 0
                   counts from the end, then clamps to the table;
  staged_words()   the widest axis-1 row of x, or table, that take_along
                   and flat_gather stage in shared memory on the card;
  scatter_max(idx, vals, rows)
                   zeros (rows, w) max-scattered along rows:
                   out[idx[i, c], c] = max(out[...], vals[i, c]) (k_scatter,
                   whose values were zeros); an index below 0 counts from
                   the end, one still outside [0, rows) is dropped; on the
                   card a block max-scatters a chunk's slab of columns in
                   shared memory where one column's rows fit
                   staged_words(), else each element goes to the output by
                   a global atomic (scatter_route; SCATTER_ROUTES counts
                   the launches of each); scatter_slabs gives the slabs'
                   width and block, scatter_blocks the blocks' slabs, and
                   slab_scatter_plain replays the slab route on the host;
  shift_screen(x, steps)
                   the signed max over s in [1, steps] of
                   roll(x, s) ^ x on the flattened array, and 0 (k_roll's
                   16 shifts by one of the row-major array, element 0
                   receiving the last); on the card steps up to
                   SHIFT_WINDOW run from registers, more from shared
                   memory (shift_route; SHIFT_ROUTES counts the launches
                   of each); shift_split and card_shift_plain replay the
                   register route's split of a chunk and its lanes.

scatter_max and shift_screen take a leading batch dimension: a 3-D input
is that many independent chunks.  On a CUDA tensor each wrapper launches
its kernel and counts it in _build.LAUNCHES; on a CPU tensor it runs the
plain version beside it.  take_along and flat_gather test a card call's
inputs in one pass (each tensor's dtype, dimensions, contiguity and
device index, no torch.device object), so that a call costs little more
than aten's; only inputs on the CPU, or ones that the test refuses, go
through the full checks (check_arrays), which raise on the latter.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

INT32_MIN = -(1 << 31)
MAX_STEPS = 4096  # shift_screen's steps (its staged route's shared memory tile)
SHIFT_WINDOW = 16  # shift_screen's steps at most on its register route (kShiftWindow in
# csrc/gather_probe.cu, whose entry point refuses that route past it)
SHIFT_DESIGNS = ("regs", "staged")  # shift_screen's routes, by the code the kernel takes
SHIFT_ROUTES = {design: 0 for design in SHIFT_DESIGNS}  # shift_screen's launches by route
LOOP_DESIGNS = ("ldg", "staged")  # take_along_loop's designs, by the code the kernel takes
LOOP_ROUTES = {design: 0 for design in LOOP_DESIGNS}  # take_along_loop's launches by design
SCATTER_DESIGNS = ("smem", "global")  # scatter_max's routes, by the code the kernel takes
SCATTER_ROUTES = {design: 0 for design in SCATTER_DESIGNS}  # scatter_max's launches by route
SCATTER_THREADS = 512  # its largest block (kStagedThreads in csrc/gather_probe.cu)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 with the two's-complement wrap."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def check_arrays(name: str, *tensors: torch.Tensor, dims=(2,)) -> int:
    """Raise unless every tensor is an int32, contiguous tensor of one of
    `dims` dimensions, on the first tensor's device, a CPU or a CUDA one;
    returns that device's CUDA index, or -1 for the CPU.  One pass over
    each tensor's dtype, dimensions, contiguity and device index."""
    first = tensors[0]
    if not first.is_cuda and not first.is_cpu:
        raise ValueError("%s: no kernel for tensors on %s" % (name, first.device))
    device = first.get_device()
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError("%s: expected int32 tensors, got %s" % (name, t.dtype))
        if t.dim() not in dims or not t.is_contiguous():
            raise ValueError("%s: expected contiguous tensors of %s dimensions, got shape %s"
                             % (name, " or ".join(map(str, dims)), tuple(t.shape)))
        if t.get_device() != device or (device < 0 and not t.is_cpu):
            raise ValueError("%s: tensors must share one device (%s vs %s)"
                             % (name, t.device, first.device))
    return device


def _check_take(x: torch.Tensor, idx: torch.Tensor, axis: int) -> tuple:
    """(device index, xr, xc, ir, ic), or raises."""
    device = check_arrays("take_along", x, idx)
    if axis != 0 and axis != 1:
        raise ValueError("take_along: axis must be 0 or 1, got %r" % (axis,))
    xr, xc = x.shape
    ir, ic = idx.shape
    if (xc != ic or xr == 0) if axis == 0 else (xr != ir or xc == 0):
        raise ValueError("take_along: x %s, not empty along axis %d, and idx %s of its other "
                         "extent" % (tuple(x.shape), axis, tuple(idx.shape)))
    return device, xr, xc, ir, ic


def _take_along_plain(x, idx, axis, fill):
    n = x.shape[axis]
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    ok = (i >= 0) & (i < n)
    return torch.where(ok, torch.gather(x, axis, i.clamp(0, n - 1)), fill)


def take_along_plain(x: torch.Tensor, idx: torch.Tensor, axis: int,
                     fill: int = INT32_MIN) -> torch.Tensor:
    _check_take(x, idx, axis)
    return _take_along_plain(x, idx, axis, fill)


def take_along(x: torch.Tensor, idx: torch.Tensor, axis: int,
               fill: int = INT32_MIN) -> torch.Tensor:
    """int32 of idx's shape: x (r, c) gathered along `axis` at idx (the
    other axis of idx as long as x's).  On the card, an axis-1 gather
    stages x's row in shared memory where it is at most staged_words()
    wide."""
    # a card call's checks, in one pass: what _check_take requires
    device = x.get_device()
    if (x.is_cuda and idx.get_device() == device and x.dtype is torch.int32
            and idx.dtype is torch.int32 and x.dim() == 2 and idx.dim() == 2
            and x.is_contiguous() and idx.is_contiguous()):
        xr, xc = x.shape
        ir, ic = idx.shape
        if (axis == 0 and xc == ic and xr) or (axis == 1 and xr == ir and xc):
            out = torch.empty_like(idx)
            if ir and ic:
                _build.launch("take_along", "tz_take_along", device, x.data_ptr(), xr, xc,
                              idx.data_ptr(), ir, ic, axis, fill, out.data_ptr())
            return out
    # the CPU, or inputs the card call refuses: _check_take raises on those
    if _check_take(x, idx, axis)[0] >= 0:
        raise ValueError("take_along: no kernel for these inputs")
    return _take_along_plain(x, idx, axis, fill)


def staged_words(device=None) -> int:
    """The widest source, in int32 words, that take_along (an axis-1 row
    of x), flat_gather (the table) and take_along_loop (a line along its
    axis) stage in shared memory on `device` (a CUDA index or
    torch.device; the current one by default): the card's shared memory a
    block may opt in to, over 4.  A wider one is gathered through the
    read-only cache."""
    return _staged_words(_build.device_index(torch.device("cuda") if device is None else device))


@functools.lru_cache(maxsize=None)
def _staged_words(index: int) -> int:
    _build.lib()
    with torch.cuda.device(index):
        words = _build.lib.fns["tz_gather_staged_words"]()
    if words < 0:
        raise RuntimeError("staged_words: %s"
                           % _build.lib.fns["tz_error_string"](-words).decode())
    return words


def _check_loop(x: torch.Tensor, idx: torch.Tensor, axis: int, iters: int) -> None:
    check_arrays("take_along_loop", x, idx)
    if axis not in (0, 1):
        raise ValueError("take_along_loop: axis must be 0 or 1, got %r" % (axis,))
    if x.shape != idx.shape or x.numel() == 0:
        raise ValueError("take_along_loop: x and idx of one non-empty shape, got %s and %s"
                         % (tuple(x.shape), tuple(idx.shape)))
    if not 0 <= iters < 1 << 31:
        raise ValueError("take_along_loop: iters must be in [0, 2^31), got %r" % (iters,))


def take_along_loop_plain(x: torch.Tensor, idx: torch.Tensor, axis: int,
                          iters: int) -> torch.Tensor:
    _check_loop(x, idx, axis, iters)
    n = x.shape[axis]
    acc = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    i = idx.long()
    for t in range(iters):
        acc += torch.gather(x, axis, wrap32(i + t).long() % n)
    return wrap32(acc)


def loop_steps(idx: torch.Tensor, n: int, iters: int) -> torch.Tensor:
    """int64 (*idx.shape, iters): the index of each of take_along_loop's
    steps as the card's kernels step it: the floor mod of idx once, then
    one up with a reset to 0 at n, and at the one step t = 2^31 - idx
    where idx + t wraps as int32 (if t < iters), floor_mod(INT32_MIN, n)
    afresh."""
    i0 = idx.long()
    j, wrap = i0 % n, (1 << 31) - i0
    steps = []
    for t in range(iters):
        j = torch.where(wrap == t, INT32_MIN % n, j)
        steps.append(j)
        j = torch.where(j + 1 == n, 0, j + 1)
    return torch.stack(steps, -1) if steps else i0.new_zeros((*idx.shape, 0))


def take_along_loop_stepped(x: torch.Tensor, idx: torch.Tensor, axis: int,
                            iters: int) -> torch.Tensor:
    """take_along_loop with its indices from loop_steps: the card kernels'
    arithmetic on the host."""
    _check_loop(x, idx, axis, iters)
    steps = loop_steps(idx, x.shape[axis], iters)
    acc = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for t in range(iters):
        acc += torch.gather(x, axis, steps[..., t])
    return wrap32(acc)


def loop_design(x: torch.Tensor, axis: int, staged: int = None) -> str:
    """take_along_loop's design on the card for x (r, c) along `axis`:
    "staged" where x's extent on the axis is at most `staged` words
    (staged_words() of x's card by default), its lines then gathered from
    shared memory; else "ldg", through the read-only cache."""
    if staged is None:
        staged = staged_words(x.device)
    return "staged" if x.shape[axis] <= staged else "ldg"


def take_along_loop(x: torch.Tensor, idx: torch.Tensor, axis: int, iters: int = 64) -> torch.Tensor:
    """int32 of x's shape: the sum over t < iters of take_along(x, (idx +
    t) mod n, axis), n = x.shape[axis] (idx + t wraps as int32; the mod is
    a floor mod, so every index is in range); on the card by the design
    loop_design gives."""
    if _build.on_cpu(x):
        return take_along_loop_plain(x, idx, axis, iters)
    _check_loop(x, idx, axis, iters)
    design = loop_design(x, axis)
    out = torch.empty_like(x)
    _build.launch("take_along_loop", "tz_take_along_loop", x.device, x.data_ptr(), x.shape[0],
                  x.shape[1], idx.data_ptr(), axis, iters, LOOP_DESIGNS.index(design),
                  out.data_ptr())
    LOOP_ROUTES[design] += 1
    return out


def _check_flat(table: torch.Tensor, idx: torch.Tensor) -> tuple:
    """(device index, T), or raises."""
    device = check_arrays("flat_gather", table, idx, dims=(1, 2, 3))
    T = table.numel()
    if T == 0:
        raise ValueError("flat_gather: the table is empty")
    return device, T


def _flat_gather_plain(table, idx, T):
    i = idx.long()
    return table.reshape(-1)[torch.where(i < 0, i + T, i).clamp(0, T - 1)]


def flat_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _, T = _check_flat(table, idx)
    return _flat_gather_plain(table, idx, T)


def flat_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int32 of idx's shape: table.reshape(-1)[idx], an index below 0
    counted from the end and then clamped to the table.  On the card, a
    table of at most staged_words() is staged in shared memory."""
    # a card call's checks, in one pass: what _check_flat requires
    device = table.get_device()
    if (table.is_cuda and idx.get_device() == device and table.dtype is torch.int32
            and idx.dtype is torch.int32 and 0 < table.dim() < 4 and 0 < idx.dim() < 4
            and table.is_contiguous() and idx.is_contiguous()):
        T = table.numel()
        if T:
            out = torch.empty_like(idx)
            n = idx.numel()
            if n:
                _build.launch("flat_gather", "tz_flat_gather", device, table.data_ptr(), T,
                              idx.data_ptr(), n, out.data_ptr())
            return out
    # the CPU, or inputs the card call refuses: _check_flat raises on those
    device, T = _check_flat(table, idx)
    if device >= 0:
        raise ValueError("flat_gather: no kernel for these inputs")
    return _flat_gather_plain(table, idx, T)


def _chunks(x: torch.Tensor) -> torch.Tensor:
    """A 2-D array as one chunk, a 3-D one as its chunks."""
    return x.unsqueeze(0) if x.dim() == 2 else x


def _check_scatter(idx: torch.Tensor, vals: torch.Tensor, rows: int) -> None:
    check_arrays("scatter_max", idx, vals, dims=(2, 3))
    if idx.shape != vals.shape or idx.numel() == 0:
        raise ValueError("scatter_max: idx and vals of one non-empty shape, got %s and %s"
                         % (tuple(idx.shape), tuple(vals.shape)))
    if not 0 < rows < 1 << 31:
        raise ValueError("scatter_max: rows must be in [1, 2^31), got %r" % (rows,))


def scatter_max_plain(idx: torch.Tensor, vals: torch.Tensor, rows: int) -> torch.Tensor:
    _check_scatter(idx, vals, rows)
    i, v = _chunks(idx).long(), _chunks(vals)
    i = torch.where(i < 0, i + rows, i)
    i = torch.where((i >= 0) & (i < rows), i, rows)  # row `rows` takes what is dropped
    out = torch.zeros(i.shape[0], rows + 1, i.shape[2], dtype=torch.int32, device=idx.device)
    out.scatter_reduce_(1, i, v, "amax")
    out = out[:, :rows]
    return out[0] if idx.dim() == 2 else out


def _scatter_design(rows: int, staged: int) -> str:
    """scatter_max's route for `rows` output rows: "smem" where one
    column's rows fit `staged` words of shared memory, else "global"."""
    return "smem" if rows <= staged else "global"


def scatter_route(idx: torch.Tensor, rows: int, staged: int = None) -> str:
    """The route of scatter_max(idx, ..., rows) on the card: "smem" (a
    chunk's slab of columns max-scattered in shared memory) where rows is
    at most `staged` words (staged_words() of idx's card by default), else
    "global" (a global atomic an element into zeros).  Raises where
    scatter_max would."""
    _check_scatter(idx, idx, rows)
    if staged is None:
        staged = staged_words(idx.device)
    return _scatter_design(rows, staged)


def scatter_slabs(b: int, r: int, w: int, rows: int, sms: int, staged: int) -> tuple:
    """(cols, threads): the slab width and the block size of scatter_max's
    smem route for b chunks of (r, w) into (rows, w), on a card of `sms`
    SMs whose blocks may stage `staged` words.  cols is 8 (a 32-byte
    sector of each row of idx and vals, the fewest L2 requests), or 4 (a
    16-byte load) where slabs of 8 would leave more than half the SMs
    without a block, and at most the widest power of two whose slab (rows
    * cols words) fits `staged`; threads by scatter_threads."""
    if not 1 <= rows <= staged:
        raise ValueError("scatter_slabs: rows must be in [1, %d], got %r" % (staged, rows))
    cols = 8 if 2 * b * -(-w // 8) >= sms else 4
    while rows * cols > staged:
        cols //= 2
    return cols, scatter_threads(r, w, rows, cols)


def scatter_threads(r: int, w: int, rows: int, cols: int) -> int:
    """The smem route's block for slabs of `cols` columns: a multiple of 32
    up to SCATTER_THREADS that gives each of max(r, rows) rows' units a
    thread (a unit: 4 columns where w and cols are multiples of 4, else 1)."""
    units = cols // 4 if w % 4 == 0 and cols % 4 == 0 else cols
    return min(SCATTER_THREADS, max(32, -(-max(r, rows) * units // 32) * 32))


def scatter_blocks(b: int, w: int, cols: int) -> list:
    """The (chunk, first column, columns) of each block of the smem route,
    in blockIdx order: chunk k's slabs of `cols` columns, the last one
    narrower where cols does not divide w."""
    return [(k, c0, min(cols, w - c0)) for k in range(b) for c0 in range(0, w, cols)]


def slab_scatter_plain(idx: torch.Tensor, vals: torch.Tensor, rows: int,
                       cols: int) -> torch.Tensor:
    """scatter_max by its smem route on the card, on the host: for each
    block of scatter_blocks, a zeroed column-major slab (column j's row i
    at j * rows + i), the block's elements max-scattered into it (those of
    value 0 or less skipped), then written out."""
    _check_scatter(idx, vals, rows)
    i, v = _chunks(idx).numpy().astype(np.int64), _chunks(vals).numpy()
    b, _, w = i.shape
    i = np.where(i < 0, i + rows, i)
    out = np.empty((b, rows, w), np.int32)
    for k, c0, nc in scatter_blocks(b, w, cols):
        slab = np.zeros(rows * nc, np.int32)
        ii, vv = i[k, :, c0:c0 + nc], v[k, :, c0:c0 + nc]
        ok = (ii >= 0) & (ii < rows) & (vv > 0)
        at = np.arange(nc) * rows + ii
        np.maximum.at(slab, at[ok], vv[ok])
        out[k, :, c0:c0 + nc] = slab.reshape(nc, rows).T
    out = torch.from_numpy(out)
    return out[0] if idx.dim() == 2 else out


@functools.lru_cache(maxsize=None)
def _scatter_plan(index: int, b: int, r: int, w: int, rows: int) -> tuple:
    """(route, cols, threads) of scatter_max on card `index`."""
    staged = _staged_words(index)
    route = _scatter_design(rows, staged)
    if route == "global":
        return route, 0, 0
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return (route, *scatter_slabs(b, r, w, rows, sms, staged))


def scatter_max(idx: torch.Tensor, vals: torch.Tensor, rows: int) -> torch.Tensor:
    """int32 (rows, w), or (b, rows, w) for b chunks: zeros with vals
    max-scattered along the rows, out[idx[i, c], c] = max(out[...],
    vals[i, c]); idx and vals (r, w) or (b, r, w).  On the card by the
    route scatter_route gives: "smem" writes every output word itself,
    "global" atomics into zeros."""
    # a card call's checks, in one pass: what _check_scatter requires
    dims, index = idx.dim(), idx.get_device()
    if (idx.is_cuda and vals.get_device() == index and idx.dtype is torch.int32
            and vals.dtype is torch.int32 and (dims == 2 or dims == 3) and idx.shape == vals.shape
            and idx.is_contiguous() and vals.is_contiguous() and 0 < rows < 1 << 31):
        *lead, r, w = idx.shape
        b = lead[0] if lead else 1
        if b and r and w:
            route, cols, threads = _scatter_plan(index, b, r, w, rows)
            out = (torch.empty((*lead, rows, w), dtype=torch.int32, device=idx.device) if cols
                   else torch.zeros((*lead, rows, w), dtype=torch.int32, device=idx.device))
            _build.launch("scatter_max", "tz_scatter_max", index, idx.data_ptr(),
                          vals.data_ptr(), b, r, w, rows, cols, threads, out.data_ptr())
            SCATTER_ROUTES[route] += 1
            return out
    # the CPU, or inputs the card call refuses: _check_scatter raises on those
    _check_scatter(idx, vals, rows)
    if idx.get_device() >= 0:
        raise ValueError("scatter_max: no kernel for these inputs")
    return scatter_max_plain(idx, vals, rows)


def _check_shift(x: torch.Tensor, steps: int) -> int:
    """x's CUDA index, or -1 for the CPU; raises on inputs shift_screen
    refuses."""
    device = check_arrays("shift_screen", x, dims=(2, 3))
    if x.numel() == 0 or (x.dim() == 3 and x.shape[0] > 65535):
        raise ValueError("shift_screen: 1 to 65,535 non-empty chunks, got shape %s"
                         % (tuple(x.shape),))
    if not 0 <= steps <= MAX_STEPS:
        raise ValueError("shift_screen: steps must be in [0, %d], got %r" % (MAX_STEPS, steps))
    return device


def shift_screen_plain(x: torch.Tensor, steps: int = 16) -> torch.Tensor:
    _check_shift(x, steps)
    flat = _chunks(x).flatten(1)
    acc = torch.zeros_like(flat)
    for s in range(1, steps + 1):
        acc = torch.maximum(acc, torch.roll(flat, s, 1) ^ flat)
    return acc.reshape(x.shape)


def _shift_design(steps: int) -> str:
    """shift_screen's route for `steps`: "regs" up to SHIFT_WINDOW steps (a
    lane's predecessors in registers), else "staged" (a block's words and
    theirs in shared memory)."""
    return "regs" if steps <= SHIFT_WINDOW else "staged"


def shift_route(x: torch.Tensor, steps: int) -> str:
    """The route of shift_screen(x, steps) on the card (_shift_design).
    Raises where shift_screen would."""
    _check_shift(x, steps)
    return _shift_design(steps)


def shift_split(n: int, offset: int) -> tuple:
    """(v0, n4): the register route's body of a chunk of n words whose first
    word lies `offset` words past a 16-byte boundary: n4 int4s from word
    v0, the first on a boundary at or past word SHIFT_WINDOW (so no word
    of the body wraps).  The words before v0 and from v0 + 4 n4 on go one
    at a time."""
    v0 = SHIFT_WINDOW + (4 - offset % 4) % 4
    return v0, max(0, (n - v0) // 4)


def _screen_word(flat, p: int, steps: int) -> int:
    n, acc = flat.size, 0
    for s in range(1, steps + 1):
        acc = max(acc, int(flat[(p - s) % n] ^ flat[p]))
    return acc


def card_shift_plain(x: torch.Tensor, steps: int = 16, offset: int = 0) -> torch.Tensor:
    """shift_screen by its register route on the card, for x's first word
    `offset` words past a 16-byte boundary: each chunk split by shift_split,
    the words outside the body one at a time, the body in warp tiles of 32
    int4s, lane l's 4 words against the int4s of lanes l - 1 .. l - 4, those
    before the tile sent by lanes 28-31 (the int4 32 before their own) for
    the shuffles that wrap."""
    _check_shift(x, steps)
    if steps > SHIFT_WINDOW:
        raise ValueError("card_shift_plain: the register route takes at most %d steps"
                         % SHIFT_WINDOW)
    chunks = _chunks(x).flatten(1).numpy()
    out = np.zeros_like(chunks)
    n = chunks.shape[1]
    lane = np.arange(32)
    for c, flat in enumerate(chunks):
        v0, n4 = shift_split(n, offset + c * n)
        v1 = v0 + 4 * n4
        for p in [*range(min(v0, n)), *range(v1, n)]:
            out[c, p] = _screen_word(flat, p, steps)
        tiles = -(-n4 // 32)
        if not tiles:
            continue
        body = np.zeros((tiles * 32 + 1, 4), flat.dtype)  # a row of zeros past the body
        body[:n4] = flat[v0:v1].reshape(-1, 4)
        cur = body[np.minimum(np.arange(tiles * 32), n4).reshape(tiles, 32)]
        before = flat[v0 - 16 + 128 * np.arange(tiles)[:, None] + np.arange(16)]
        hd = before.reshape(tiles, 4, 4)  # the tile's 16 words before it, for lanes 28-31
        w = np.zeros((tiles, 32, 20), flat.dtype)
        w[:, :, 16:] = cur
        for d in range(1, 5):
            src = (lane - d) % 32
            sent = np.where((src >= 32 - d)[None, :, None], hd[:, np.maximum(src - 28, 0)],
                            cur[:, src])
            w[:, :, 16 - 4 * d:20 - 4 * d] = sent
        got = np.zeros((tiles, 32, 4), flat.dtype)
        for k in range(4):
            for s in range(1, steps + 1):
                got[:, :, k] = np.maximum(got[:, :, k], w[:, :, 16 + k - s] ^ w[:, :, 16 + k])
        out[c, v0:v1] = got.reshape(-1, 4)[:n4].reshape(-1)
    return torch.from_numpy(out).reshape(x.shape)


def shift_screen(x: torch.Tensor, steps: int = 16) -> torch.Tensor:
    """int32 of x's shape: the signed max of 0 and x[p - s] ^ x[p] over s
    in [1, steps], p and p - s flat row-major positions of x (r, w),
    wrapping, or of each chunk of x (b, r, w).  On the card the output lies
    as far past a 16-byte boundary as x (the register route stores 16
    bytes at once where it loads them)."""
    # a card call's checks, in one pass: what _check_shift requires
    dims = x.dim()
    if (x.is_cuda and x.dtype is torch.int32 and (dims == 2 or dims == 3) and x.is_contiguous()
            and 0 <= steps <= MAX_STEPS):
        b, n = x.shape[0] if dims == 3 else 1, x.numel()
        if n and b <= 65535:
            ptr = x.data_ptr()
            offset = ptr % 16 // 4
            out = (torch.empty(n + offset, dtype=torch.int32, device=x.device)[offset:].view(x.shape)
                   if offset else torch.empty_like(x))
            route = _shift_design(steps)
            _build.launch("shift_screen", "tz_shift_screen", x.get_device(), ptr, b, n // b, steps,
                          SHIFT_DESIGNS.index(route), out.data_ptr())
            SHIFT_ROUTES[route] += 1
            return out
    # the CPU, or inputs the card call refuses: _check_shift raises on those
    if _check_shift(x, steps) >= 0:
        raise ValueError("shift_screen: no kernel for these inputs")
    return shift_screen_plain(x, steps)
