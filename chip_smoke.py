"""Drive tpuzlib_torch's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero at once without
a card, and on any failed check.  It builds the kernels from
tpuzlib_torch/kernels/csrc, then:

  A  holds each kernel against its plain torch version (exact equality)
     at the main path's shapes: the encoder's four at level 6, 256 KiB
     chunks, batch 8 (the near screen on the batch's bytes; the far
     screen's two hash probes updating the near screen's keys in place,
     every call from the near keys, the copy that restores them timed
     alone and taken off; the segment parse on the batch's own step tape,
     whose walks the "A parse tape" line measures; pack_words, the token
     fields and the bit pack into words, from the batch's compacted
     tokens, tables and header);
     the checksums' five (CRC-32 per-block forms, CRC-32 span forms, the
     whole CRC-32 finished on the card in the same launch (crc32_scalar,
     tpuzlib's crc32_device_jit), Adler-32 block sums, the whole Adler-32
     in one launch (adler32_scalar, tpuzlib's adler32_device_jit)) on
     256 MiB, the size from which tpuzlib's checksums take the device;
  B  runs one full-shape make_encode_batch_v3 batch on the card and on
     the CPU (plain versions) and requires equal words, bits and ok;
  C  compresses 32 MiB of mixed corpus at level 6 in the zlib and the gzip
     container, and 8 MiB at levels 1 and 9 (zlib), with
     tpuzlib_torch.deflate and decodes each with python's zlib; the
     launch counts of the encoder's kernels and of the two trailers'
     checksum kernels (adler32_scalar; crc32_spans, the span mode the
     gzip trailer's crc32_scalar launch folds in) are taken over C;
     adler32 (row 7's block kernel) is off the public path since the
     scalar took its place, and is exempt from the launch check (OFF_PATH);
  D  streams 16 MiB through DeviceDeflater in uneven appends;
  E  holds tpuzlib_torch.crc32 / adler32 to zlib: 256 MiB as a host array
     and as a card tensor, ragged sizes with seeds, a chain of seven
     pieces and the combines; then times the warm public crc32 and
     adler32 of a 200 KiB, an 8 MiB and the 256 MiB card tensor (host
     clock, median of 10 after 3 warm-ups; "E latency" lines), each call
     one crc32_scalar or adler32_scalar launch and no call of the host
     tree or the torch combine (crc32._combine_blocks,
     adler32_cuda.adler32_totals, counted);
     the launch counts of crc32_scalar and of crc32_forms (the block mode
     its launches on inputs below one span fold in) are taken over E;
  F  runs tpuzlib_torch.entry's forward step on the card and on the CPU
     and requires equal outputs;
  G  decompresses on the card: G1 holds the decode's two kernels to their
     plain versions (exact: the lookup tables, and all six outputs of the
     decode) at the shapes of the 32 MiB corpus compressed by python zlib
     at level 6, times the decode at 32, 64 and 128 threads a block, and
     counts the tape's symbols whose codes the lookup tables miss; G1 scan
     holds the plan's header scan (header_filter and header_parse, one
     tz_header_scan call) on that stream's words as its plan uploads them:
     the filter's survivors and the parse's positions exactly the plain
     version's, each kernel's time (the call's, split by the kernels'
     device times in torch.profiler) and its own bound
     (header_scan.bounds_ms: operations at INT32_RATE, and for the parse
     also the longest header's chain of dependent operations); G2 runs
     tpuzlib_torch.inflate on zlib levels 6 (32 MiB), 1 and 9 (8 MiB),
     C's 32 MiB gzip, fixed blocks, sync-flush markers and 8 MiB of text,
     whose splice must validate with no repair, then inflate_device_v2
     with device or host expansion, and a forced splice repair of the text
     stream, and requires every output to equal its input, and every
     inflate() output to come from the device route with no fallback to
     the host engine, but for a raw stream and a zlib stream under 256
     KiB (512 KiB of the text), which inflate()'s route rule keeps on the
     host route: their device counters must not move (the raw stream's
     device decode is held by the v2 rows) (the launch counts of the
     decode's two kernels and of the header scan's two are taken over
     G2); the census
     lines say, per stream, whether its splice validates under the port's
     rule (any kept flagged EOB declines), under tpuzlib's (only each
     cursor's first flag) and with no flag at all; G3 times the level-6
     decode's pieces apart, both expansions included, its plan with the
     card's header scan;
  H  holds the CRC probe kernels (the read floor crc_rowsum, the bit
     unpack crc_unpack in u8, i32 and bf16, the GF(2) product gf2_bits_mm
     on 8 MiB of bits unpacked beforehand (a wgmma kernel fed by TMA, K
     split over a cluster), also on the same bits 3 elements off a
     16-byte boundary (gf2_bits_mm_ldg, route "ldg", off the probes'
     path; "H bits" gives both device times beside the library calls,
     ldg_library_ms the bf16 product of those offset bits),
     the tensor-core forms
     crc_forms_mm in bf16 and int8) to their plain versions on 256 MiB,
     requires both forms to give zlib's CRC through the host combine and
     to equal the table fold's, holds both forms on the same 256 MiB at
     byte offset 3 (the route whose consumers load the rows themselves;
     "H unaligned") to the plain version, times each kernel at every (B,
     tile) the tools run beside the table fold (each "H time" line names
     the route of the rows), then runs the three probes of
     tpuzlib_torch/tools at 8 MiB; their launches are taken over those
     runs, gf2_bits_mm's rows' by their route (crc32_probe.BITS_ROUTES);
  I  holds the gather and primitive probe kernels (gather_probe.cu,
     inflate_prims.cu) to their plain versions: take_along on (64, 4352)
     along axis 1 (x's row staged in shared memory) and on (64, 65536)
     (take_along_axis1_wide: rows past the staged limit, gathered
     through the read-only cache), and on (4352, 128) and the encoder
     batch's (8 x 2304, 128) along axis 0, take_along_loop x 64 at the
     tools' three shapes ((4352, 128) and (1024, 128) on axis 0, (1024,
     128) on axis 1: x's lines staged in shared memory) and on (staged
     limit + 1, 32) along axis 0 (take_along_loop_wide: through the
     read-only cache, a design the tools' shapes never take, so off the
     main path), each row naming its design and, for the staged rows,
     beside the byte bound the shared-memory request floor of their
     gathers; each loop row's launches are those of its design
     (gather_probe.LOOP_ROUTES) over the probes' runs; flat_gather (from the tools' 128 KiB table, staged, and from a
     256 KiB one, flat_gather_large, through the cache), shift_screen
     (steps 16, its register route; shift_screen_staged, steps 40, off
     the probes' path; each row's launches its route's,
     gather_probe.SHIFT_ROUTES, and an "I shift" line its device time
     also with the L2 evicted and its dirty lines written back by a 64 MiB
     read before each launch, events around the launch alone,
     flushed_device_ms) and
     scatter_max on 8 chunks of (2304, 128)
     (the positions of one chunk, 32 KiB of context and 256 KiB, as
     tools/probe_primitives.py:48 sizes them, in the main path's batch of
     8; route smem, a chunk's slab of columns max-scattered in shared
     memory) and on one chunk into staged_words() + 1 rows
     (scatter_max_global: route global, off the probes' path), each row
     naming its route (`design`), its launches its route's
     (gather_probe.SCATTER_ROUTES, launches_by_route), the inflate
     primitives at 8,192 lanes (G1's cursor count)
     (fetch_rows', gather_store_loop's and tree_decode's byte bounds count
     the words they read: the rows' distinct words in range, and
     tree_decode's table rows 1-15), every row with
     over_floor_device_ms, its device time less the "I launch floor"
     line's (timed first, floor_device_ms),
     vec_cond_while also at the shared-memory limit (vec_cond_while_smem)
     and one lane past it (vec_cond_while_global), each row naming its
     route (`design`; the probes' 128 and 8,192 lanes take "regs", so the
     other two are off the main path) and its loop's steps, its launches
     those of its route (vec_cond_while_<route>); an
     "I device" line a row gives its device time (and its library call's)
     of bare launches queued behind a sleep kernel, since these wrapper
     calls are held by their host time, and for the gathers their design,
     their ms over library_ms and the 32-byte sectors their cache gathers
     read; a row with a library call also times it and its kernel's
     wrapper over 200 calls after 20, in turns (steady_ms,
     library_steady_ms: these host-held calls vary too much over 10); the "I launch floor" line gives take_along on a (1, 1) input
     timed both ways and over torch.gather's; the "I launch probe" line
     gives the host µs of each piece of a call (probes/launch_breakdown.py:
     the earlier path re-created, this one's, torch.gather); then runs the four probes of tpuzlib_torch/tools
     (probe_gather, probe_primitives, probe_inflate_prims,
     probe_inflate_prims2), over which their launches are counted;
  J  runs the host engine at full size: J1 inflate()s python zlib's
     level-1 stream of the corpus seven times (224 MiB, more than 2^29
     bits), which the device route declines before any upload (one
     counted device_fallback, no decode launch) and the host route
     decodes (its MB/s): on a host of 8 cores or more by the speculative
     decode (its bytes counted as `speculative`), else by the Inflater; J2 streams G's 32 MiB zlib stream through an
     Inflater in 64 KiB appends and C's 32 MiB gzip in ragged ones (1 B,
     7 B, 4 KiB, 1 MiB), each verdict a success with its checksum (and
     ISIZE) matched and its totals right; J3 requires tpuzlib's verdicts
     of those streams cut short, with a flipped Adler-32 or CRC-32 and a
     flipped ISIZE, each from the device route first and one counted
     fallback; J4 decodes a zlib stream written against a 32 KiB preset
     dictionary through inflate(dictionary=) and the Inflater, requires
     tpuzlib's messages without it and with a wrong one, and decodes a
     raw stream with that dictionary on the host engine and by the
     device decode;
  K  runs the host deflate engine at full size, after every launch count
     of the kernels line has been read: K1 compresses the 32 MiB corpus
     with the Deflater (zlib container, one append) at levels 1, 6 and 9
     and, in the same run, with deflate() on the card, and prints each
     one's warm MB/s (host clock, median of 3 after a warm-up), its bytes
     and its ratio to zlib's at the level, and the engine's core count
     (its bytes depend on it); zlib must decode both; K2 inflate()s the
     Deflater's level-6 zlib and gzip streams on the card, every byte
     from the device route (the inflate.device counter grown by the
     output, no fallback counted, decode launches); K3 decodes 8 MiB from ragged
     appends (1 B, 7 B, 4 KiB, 1 MiB) on the device route, and 8 MiB
     after a 32 KiB preset dictionary from deflate(dictionary=) on the
     host engine, both also with zlib; K4 compresses the corpus into
     4 MiB gzip members and decompresses them with their index, the
     combined CRC-32 equal to zlib's and verified on the card by one
     crc32_scalar launch;
  L  runs the speculative host inflate: L1 inflate()s J1's stream, the
     device route declining it at its plan and the host route's
     speculative decode giving its bytes (its trailer one adler32_scalar
     launch), and prints its warm MB/s (host clock, median of 3 after a
     warm-up) beside the sequential Inflater's on the same stream; L2
     runs inflate_parallel_container on G's zlib and C's gzip stream and
     on copies with a flipped Adler-32 or CRC-32 (tpuzlib's verdict), each
     one checksum launch;
  M  runs the mesh on one card: a world-size-1 NCCL group on a free
     localhost port, destroyed at the end; dryrun_multichip(1) (one
     sharded-deflate step at 256 KiB a rank, its stream round-tripped
     through zlib and sharded_inflate); sharded_deflate of 8 MiB of the
     corpus in one shard at levels 1 and 6 (zlib decodes it, its Adler-32
     and CRC-32 are zlib's; warm MB/s, the step's ok flags); and
     sharded_inflate of G's raw level-6 stream on the mesh (the corpus,
     no fallback).  The launches of the encoder's four kernels, the two
     checksum scalars and the decode's two kernels are counted over M
     ("M launches"), each required.  L and M run after every launch count
     of the kernels line has been read;
  N  profiles the two main paths with utils/trace.py, after M: N1 times a
     warm level-6 zlib deflate() of the 32 MiB corpus with the telemetry
     off and on, in turns (median of 7; the ratio is the cost of its
     spans; reported, not gated); N2 runs one warm deflate() of it and
     one warm inflate() of G's zlib stream, each inside trace.profile()
     (a temporary directory, removed afterwards), and prints, per call,
     the host wall ms, the card's busy ms (the union of its kernel, copy
     and memset intervals), its idle share, the 8 device operations of
     most time, each stage's host ms, the idle ms under each innermost
     stage, and the 8 longest idle gaps with the stage open on the host
     at their middle; then the stage telemetry and the counters, gated:
     deflate.device and inflate.device equal to the bytes in and out, no
     fallback; N3 runs one warm make_encode_batch_v3 batch with the
     telemetry on under torch.cuda.set_sync_debug_mode("error"): its
     overflow counter and the encoder upload and read back nothing;
  O  runs the host codec with its native library switched off
     (testing.no_native, after N; bindings.lib() must raise inside and
     the library be back on after): O1 the numpy Deflater (zlib, one
     append) on 8 MiB of the corpus at levels 1, 6 and 9, each stream
     decoded by zlib, with its MB/s, its size over zlib.compress's at the
     level and the host's core count; O2 deflate() of the 8 MiB on the
     card, decoded by zlib, the encoder's four kernels launched and one
     checksum scalar; O3 inflate() on the card of zlib's level-6 stream
     of it, equal bytes, inflate_decode and the header scan's filter
     launched (the card scans without the native library), every byte from the
     device route with no fallback (a splice repair bridges with the
     vectorized decoder), the counters and each stage's host seconds
     (the telemetry on for this call) printed; O4 crc32_host and
     adler32_host of the 8 MiB, each equal to zlib's.  O2's and O3's
     launches, each counted from 0 just before its call, are given on
     the kernels line as launches_o, apart from the main path's
     launches, which alone the check of the launches reads;
  P  decodes a 32 MiB BGZF slice of BAM records (zbench/entries/bgzf.py's
     generator; 515 members and the EOF member) with inflate_members() on
     the card: equal to zlib's member-by-member decode, every member from
     the device route, one inflate_decode launch; then the segmented
     CRC-32 kernel (crc32_segments, the members' check) against its plain
     version on the decoded slice's 516 member bounds, its ms and device ms
     (behind a sleep kernel; both with the call's 4 KiB upload of its
     bounds), the kernel alone by torch.profiler's device events
     (kernel_ms), and its bound (the bytes read once and 4 bytes a member
     written); the call's host seconds by stage (the
     telemetry on for one call).  `python3 chip_smoke.py P` runs the
     build and this phase alone.

Each phase prints one JSON line; then the per-kernel table
{"kernels": [...]} and, last, {"ok": true, "device": {...}}.  A kernel's
row gives its bound: the larger of the bytes it must move (each input
read once, each output written once) over the card's memory rate, and a
floor on its operations (one for each elementary step: a window
compared, a byte folded, a symbol decoded; the screens count the window
compares their exits leave on the batch) over the card's float32 rate
outside the tensor cores (its table has no integer rate; a higher rate
only lowers the bound), or, for the tensor-core products of H, the
published dense bf16 or int8 rate (`op_rate` in the row).  library_ms is
one PyTorch call computing the same function: the row sums for
crc_rowsum, the bf16 torch.mm(bits, m, out_dtype=torch.float32) for
gf2_bits_mm and gf2_bits_mm_ldg (on the offset bits), the same function
but for the parity (a float32 torch.mm
where the card's torch refuses out_dtype: library_call says which; its row
adds the float32 product as library_f32_ms and torch._int_mm as
library_int8_ms), torch.gather for take_along (on in-range indices,
int64 beforehand), torch.take for flat_gather, scatter_reduce_ "amax" for
scatter_max; no single call computes any other kernel's function (the
loop, the shift screen's 16 rolls under a max, the inflate primitives'
loops and lane arithmetic are each several calls), and theirs is null.
"""

from __future__ import annotations

import collections
import functools
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

LEVEL, CHUNK, BATCH = 6, 1 << 18, 8
DEVICE = "cuda"
# NVIDIA H100 SXM, published: HBM3 bytes/s, float32 operations/s without
# the tensor cores; the tensor cores' dense bf16 FLOP/s and int8 OP/s
MEM_RATE, OP_RATE = 3.35e12, 67e12
BF16_RATE, INT8_RATE = 989.4e12, 1978.9e12
# cycles a second that size torch.cuda._sleep: the H100's top SM clock
SLEEP_HZ = 1.98e9
SMS = 132  # the H100 SXM's streaming multiprocessors
INT32_RATE = SMS * 64 * SLEEP_HZ  # integer operations/s: 64 INT32 lanes an SM
# the (B, tile) pairs the CRC probes run (tools/probe_crc.py, probe_crc3.py)
FORM_PAIRS = ((1024, 256), (4096, 256), (4096, 512), (1024, 1024))
# kernels held to their plain versions that no main path launches, and why
OFF_PATH = {"adler32": "the public Adler-32 runs adler32_scalar's kernel, which takes the "
                       "same block sums (block_sums in csrc/adler32.cu) in its own launch",
            "take_along_loop_wide": "take_along_loop's ldg design runs only on lines past "
                                    "staged_words(); the tools' shapes all fit it",
            "vec_cond_while_smem": "vec_cond_while keeps the probes' 128 and 8,192 lanes in "
                                   "registers; shared memory takes 8,193 to staged_words()",
            "vec_cond_while_global": "vec_cond_while runs through device memory only past "
                                     "staged_words() lanes",
            "gf2_bits_mm_ldg": "the probe's bits start on a 16-byte boundary (route tma); "
                               "bits off one take the ldg route",
            "shift_screen_staged": "the probe screens 16 steps, which the register route "
                                   "takes; more than 16 take the staged route",
            "scatter_max_global": "the probe scatters into 256 rows, which the smem route "
                                  "takes; more than staged_words() rows take the global route"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 10) -> float:
    """Device time of fn() in ms, mean over `reps` after 3 warm-ups, with
    the calls queued behind a sleep kernel while the host launches them,
    so that a call's host time does not stretch it (a call's own host
    time, card idle, sizes the sleep)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * reps * host_s + 1e-3) * SLEEP_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flushed_ms(fn, reps: int = 20) -> float:
    """Device time of fn() in ms with a cold, clean L2: before each of
    `reps` calls a read of 64 MiB (more than the H100's 50 MB L2) evicts
    what the L2 holds and writes its dirty lines back; CUDA events around
    each call alone time it; all queued behind a sleep kernel (sized as
    device_ms sizes it) after 3 warm-ups; the mean of the calls."""
    evict = torch.ones(16 << 20, dtype=torch.int32, device=DEVICE)
    total = torch.empty((), dtype=torch.int64, device=DEVICE)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2 * reps)]

    def call(i):
        torch.sum(evict, 0, out=total)
        marks[2 * i].record()
        fn()
        marks[2 * i + 1].record()

    for i in range(3):
        call(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        call(i)
        torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / reps
    torch.cuda._sleep(int((2 * reps * host_s + 1e-3) * SLEEP_HZ))
    for i in range(reps):
        call(i)
    torch.cuda.synchronize()
    return sum(marks[2 * i].elapsed_time(marks[2 * i + 1]) for i in range(reps)) / reps


def nbytes(x) -> int:
    """Bytes of the tensors in x (a tensor, or nested tuples and lists)."""
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    return sum(nbytes(y) for y in x) if isinstance(x, (tuple, list)) else 0


def rows_read(rows, nw: int) -> int:
    """Bytes of the distinct int32 words of a (nw, lanes) array read at
    rows (int64 (steps, lanes)): each lane's distinct rows in [0, nw)."""
    r = torch.where((rows >= 0) & (rows < nw), rows, -1).sort(0).values
    return 4 * int((r[0] >= 0).sum() + ((r[1:] != r[:-1]) & (r[1:] >= 0)).sum())


def max_abs_err(a, b) -> int:
    a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0 for x, y in zip(a, b))


def after(reset, fn):
    """fn, run after reset()."""
    return lambda: (reset(), fn())[1]


def first_batch(data: np.ndarray, dev):
    """The first batch of `data` as deflate_device_v3 lays it out."""
    from tpuzlib_torch.kernels.deflate_device3 import batch_arrays

    return tuple(torch.from_numpy(a).to(dev) for a in batch_arrays(data, range(BATCH), CHUNK, BATCH))


def phase_a(args) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from tpuzlib_torch.kernels import deflate_device3 as d3
    from tpuzlib_torch.kernels import parse, screen
    from tpuzlib_torch.kernels.deflate_device import CTX, SEG, segment_parse_xla

    bufs, cv, nv, _ = args
    p = d3.LEVELS_V3[LEVEL]
    data = bufs.reshape(-1)
    lim16, _, mincand, chid = d3.batch_layout(BATCH, CTX, CHUNK, cv, nv)
    # a window compare is four word compares; each screen's count is what
    # its exits leave on this batch
    cases = {
        "near_screen": (
            lambda: screen.near_screen(data, mincand, lim16, p["nd"]),
            lambda: screen.near_screen_plain(data, mincand, lim16, p["nd"]),
            "tpuzlib_torch/kernels/csrc/screen.cu",
            "tpuzlib/kernels/screen_pallas.py:142",
            (data, mincand, lim16), 4 * int(screen.near_trips(data, mincand, lim16, p["nd"]).sum()),
        ),
    }
    # both probes update one position-domain key array in place; every
    # call starts from the near screen's keys, as on the main path.  Each
    # probe reads and writes the keys once, and a position takes 4 bytes
    # (the kernel keeps the low word of torch.sort's int64 permutation)
    ws = d3.window_words(data)
    probes = [(*d3.probe_rows(ws, mincand, chid, nb, bits), p["k%d" % nb]) for nb, bits in d3.PROBES]
    near = screen.near_screen(data, mincand, lim16, p["nd"])
    best, best_plain = near.clone(), near.clone()
    cases["far_screen"] = (
        lambda: [screen.far_screen(sh, sp, data, best, k) for sh, sp, k in probes],
        lambda: [screen.far_screen_plain(sh, sp, data, best_plain, k) for sh, sp, k in probes],
        "tpuzlib_torch/kernels/csrc/screen.cu",
        "tpuzlib/kernels/screen_pallas.py:222",
        [(sh, sp.to(torch.int32), data, best) for sh, sp, _ in probes],
        sum(4 * int(screen.far_trips(sh, sp, data, k).sum()) for sh, sp, k in probes),
    )
    fresh = {"far_screen": (lambda: best.copy_(near), lambda: best_plain.copy_(near))}
    # the path's own step tape for this batch: the parse's input in the encoder
    _, step, _ = d3.parse_tape(BATCH, CTX, CHUNK, bufs, cv, nv, LEVEL)
    step = step.reshape(-1)
    n = step.numel()
    walks = segment_parse_xla(step, n).reshape(-1, SEG).sum(1)  # chain steps a segment
    emit({"phase": "A parse tape", "segments": walks.numel(), "mean_walk": float(walks.float().mean()),
          "longest_walk": int(walks.max()), "walks_of_1000_or_more": int((walks >= 1000).sum())})
    cases["segment_parse"] = (
        lambda: parse.segment_parse(step, n),
        lambda: segment_parse_xla(step, n),
        "tpuzlib_torch/kernels/csrc/parse.cu",
        "tpuzlib/kernels/parse_pallas.py:44",
        (step,), n,
    )
    # the fields and the bit pack from the first batch's compacted tokens:
    # the bound counts 4 B a token up to each row's EOB, the tables, the
    # header, and the words and total_bits as the encoder returns them
    ow = d3.out_words_for(CHUNK)
    enc = functools.partial(d3.make_encode_batch_v3, LEVEL, CHUNK, BATCH, ow)
    tok, M, _ = enc(stage="compact")(*args)
    ll, dl, lcodes, dcodes = enc(stage="trees")(*args)
    hdr_vals, hdr_bits, _ = enc(stage="header")(*args)
    eob_at = torch.clamp(M.long(), max=tok.shape[1] - 1)
    rest = (lcodes.int(), ll, dcodes.int().contiguous(), dl.contiguous(), eob_at, hdr_vals,
            hdr_bits, args[3])
    tokens = int((eob_at + 1).sum())
    cases["pack_words"] = (
        lambda: d3.pack_words(tok, *rest, ow),
        lambda: d3.pack_words_plain(tok, *rest, ow),
        "tpuzlib_torch/kernels/csrc/pack_fields.cu",
        "tpuzlib/kernels/deflate_device3.py:338",
        lambda got: 4 * tokens + nbytes(rest) + nbytes(got), 2 * tokens,  # two table lookups a token
    )
    rows = check_kernels(cases, fresh=fresh)
    rows["pack_words"]["also_replaces"] = ("tpuzlib/kernels/deflate_device3.py:670-700, the bit"
                                           " pack that tpuzlib runs in XLA")
    rows["pack_words"]["tokens"] = tokens
    return rows


def phase_a_checksums(big) -> dict:
    """The checksum kernels against their plain versions on `big` (a card
    tensor of whole spans)."""
    from tpuzlib_torch.kernels import adler32_cuda, crc32_cuda

    crc_src, adler_src = "tpuzlib_torch/kernels/csrc/crc32.cu", "tpuzlib_torch/kernels/csrc/adler32.cu"
    return check_kernels({
        "crc32_forms": (
            lambda: crc32_cuda.crc32_forms(big, 0, 1),
            lambda: crc32_cuda.crc32_forms_plain(big, 0, 1),
            crc_src, "tpuzlib/kernels/crc32_pallas.py:24", (big,), big.numel(),
        ),
        "crc32_spans": (
            lambda: crc32_cuda.crc32_forms(big, 0, 256),
            lambda: crc32_cuda.crc32_forms_plain(big, 0, 256),
            crc_src, "tpuzlib/kernels/crc32_pallas.py:99", (big,), big.numel(),
        ),
        "crc32_scalar": (
            lambda: crc32_cuda.crc32_device_scalar(big),
            lambda: crc32_cuda.crc32_device_scalar_plain(big),
            crc_src, "tpuzlib/kernels/crc32_pallas.py:188", (big,), big.numel(),
        ),
        "adler32": (
            lambda: adler32_cuda.adler32_blocks(big, 0),
            lambda: adler32_cuda.adler32_blocks_plain(big, 0),
            adler_src, "tpuzlib/kernels/adler32_pallas.py:42", (big,), 2 * big.numel(),
        ),
        "adler32_scalar": (
            lambda: adler32_cuda.adler32_device_scalar(big),
            lambda: adler32_cuda.adler32_device_scalar_plain(big),
            adler_src, "tpuzlib/kernels/adler32_pallas.py:119", (big,), 2 * big.numel(),
        ),
    })


def check_kernels(cases, phase="A", fresh=None, rates=None, library=None) -> dict:
    """One row per kernel: its error against its plain version, both
    times and its bound; exits when a kernel differs.  A case is (kernel,
    plain version, source, TPU kernel replaced, the kernel's inputs, or a
    function of its outputs that gives the bytes it must move, its
    operations: a number, or a function of its outputs), and may end with
    the number of timed runs of its plain version (default 10 after 3
    warm-ups; a plain version run fewer times is timed with no warm-up,
    after the comparison's run).  `fresh` maps the name of a kernel that
    updates its inputs in place to two functions that restore them, one
    run before every call of the kernel, one before every call of its
    plain version; the first's own time (`fresh_ms`) is taken off both
    times.  `rates` maps a kernel's name to the operations rate of its
    bound where it is not OP_RATE (the tensor cores'), `library` to one
    PyTorch call computing the same function, timed as library_ms.  The
    phase line adds the card memory the plain version takes at its peak."""
    rows = {}
    for name, (kern, plain, src, replaces, inputs, ops, *plain_reps) in cases.items():
        op_rate = (rates or {}).get(name, OP_RATE)
        resets = (fresh or {}).get(name)
        fresh_ms = cuda_ms(resets[0]) if resets else 0.0
        if resets:
            kern, plain = after(resets[0], kern), after(resets[1], plain)
        got = kern()
        torch.cuda.synchronize()
        moved = inputs(got) if callable(inputs) else nbytes(inputs) + nbytes(got)
        ops = ops(got) if callable(ops) else ops
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        want = plain()
        plain_peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        err = max_abs_err(got, want)
        del got, want
        bytes_ms, ops_ms = moved / MEM_RATE * 1e3, ops / op_rate * 1e3
        ms = cuda_ms(kern) - fresh_ms
        lib = (library or {}).get(name)
        rows[name] = dict(name=name, route="cuda", source=src, replaces=replaces, launches=None,
                          max_abs_err=err, ms=ms,
                          plain_ms=(cuda_ms(plain, *plain_reps, 0) if plain_reps
                                    else cuda_ms(plain)) - fresh_ms,
                          bound_ms=max(bytes_ms, ops_ms),
                          bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                          library_ms=cuda_ms(lib) if lib else None, bytes=moved, ops=ops,
                          pct_of_bound=100 * max(bytes_ms, ops_ms) / ms)
        if plain_reps:
            rows[name]["plain_reps"] = plain_reps[0]
        if op_rate != OP_RATE:
            rows[name]["op_rate"] = op_rate
        if resets:
            rows[name]["fresh_ms"] = fresh_ms
        emit({"phase": phase, **rows[name], "plain_peak_MiB": plain_peak_mib})
        if err != 0:
            raise SystemExit("phase %s: %s differs from its plain version" % (phase, name))
    return rows


def phase_b(args) -> None:
    """One full-shape batch on the card against the same call on the CPU."""
    from tpuzlib_torch.kernels import deflate_device3 as d3

    enc = d3.make_encode_batch_v3(LEVEL, CHUNK, BATCH, d3.out_words_for(CHUNK))
    t0 = time.perf_counter()
    gw, gb, gok = (t.cpu() for t in enc(*args))
    t1 = time.perf_counter()
    cw, cb, cok = enc(*(a.cpu() for a in args))
    t2 = time.perf_counter()
    okm = cok.bool()
    same = (torch.equal(gb, cb) and torch.equal(gok, cok)
            and torch.equal(gw[okm], cw[okm]))
    emit({"phase": "B", "equal": same, "ok": cok.tolist(), "total_bits": cb.tolist(),
          "cuda_s": t1 - t0, "cpu_s": t2 - t1})
    if not same:
        raise SystemExit("phase B: the CUDA batch differs from the CPU batch")


def phase_c(corpus) -> np.ndarray:
    """tpuzlib_torch.deflate round trips through zlib; warm MB/s.  Returns
    the 32 MiB gzip member."""
    import tpuzlib_torch

    for level, size, fmt in ((6, 32 << 20, "deflate"), (6, 32 << 20, "gzip"),
                             (1, 8 << 20, "deflate"), (9, 8 << 20, "deflate")):
        data = corpus[:size]
        runs = []
        for _ in range(2):  # the second run is the warm one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tpuzlib_torch.deflate(data, level=level, format=fmt, device=DEVICE,
                                        fileName="mixed.bin" if fmt == "gzip" else None)
            runs.append(time.perf_counter() - t0)
        # wbits 15: a zlib stream; 31: a gzip member
        ok = zlib.decompress(out.tobytes(), 31 if fmt == "gzip" else 15) == data.tobytes()
        emit({"phase": "C", "level": level, "format": fmt, "bytes_in": size,
              "bytes_out": len(out), "zlib_bytes_out": len(zlib.compress(data.tobytes(), level)),
              "roundtrip": ok, "cold_s": runs[0], "warm_s": runs[1],
              "warm_MBps": size / runs[1] / 1e6})
        if not ok:
            raise SystemExit("phase C: level %d %s output does not decode to the input"
                             % (level, fmt))
        if fmt == "gzip":
            gzip32 = out
    return gzip32


def phase_d(corpus) -> None:
    """DeviceDeflater over 16 MiB in uneven appends."""
    import tpuzlib_torch

    data = corpus[: 16 << 20]
    d = tpuzlib_torch.DeviceDeflater(level=LEVEL, device=DEVICE)
    rng = np.random.default_rng(4)
    outs, off = [], 0
    t0 = time.perf_counter()
    while off < len(data):
        step = int(rng.integers(1, 3 << 20))
        outs.append(d.append(data[off : off + step]))
        off += step
    on_card = d._ctx.device.type == torch.device(DEVICE).type
    outs.append(d.finish())
    dt = time.perf_counter() - t0
    wire = b"".join(o.tobytes() for o in outs)
    ok = zlib.decompress(wire, -15) == data.tobytes()
    emit({"phase": "D", "bytes_in": len(data), "bytes_out": len(wire), "appends": len(outs) - 1,
          "window_on_cuda": on_card, "roundtrip": ok, "s": dt})
    if not (ok and on_card):
        raise SystemExit("phase D: stream does not decode, or the window left the card")


def timed(fn):
    """(fn(), host ms) with the card idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_e(big_host, big) -> None:
    """The public checksums against zlib: 256 MiB from the host and on the
    card, ragged sizes with seeds, a chain and the combines."""
    import tpuzlib_torch
    from tpuzlib_torch.kernels.adler32 import adler32_combine
    from tpuzlib_torch.kernels.crc32 import crc32_combine

    crc32 = functools.partial(tpuzlib_torch.crc32, device=DEVICE)
    adler32 = functools.partial(tpuzlib_torch.adler32, device=DEVICE)

    _, h2d_ms = timed(lambda: torch.from_numpy(big_host).to(DEVICE))
    bad = []
    for name, fn, ref in (("crc32", crc32, zlib.crc32),
                          ("adler32", adler32, zlib.adler32)):
        want = ref(big_host)
        for source, x in (("host", big_host), ("cuda", big)):
            (first, first_ms), (warm, warm_ms) = timed(lambda: fn(x)), timed(lambda: fn(x))
            ok = first == warm == want
            emit({"phase": "E", "checksum": name, "source": source, "bytes": len(big_host),
                  "equal": ok, "first_ms": first_ms, "warm_ms": warm_ms, "h2d_ms": h2d_ms})
            bad += [] if ok else ["%s of 256 MiB from %s" % (name, source)]

    rng = np.random.default_rng(5)
    span = 1 << 18
    for n in (0, 1, 1023, 1025, 2047, 2049, span - 1, span + 1, 3 * span + 12345):
        lo = 2 * int(rng.integers(0, 1 << 20)) + 1  # an odd offset into the card tensor
        data = big_host[lo : lo + n]
        for seed in (0, 1, 0xDEADBEEF):
            for name, fn, ref in (("crc32", crc32, zlib.crc32),
                                  ("adler32", adler32, zlib.adler32)):
                if not fn(data, seed) == fn(big[lo : lo + n], seed) == ref(data, seed):
                    bad.append("%s n=%d seed=%#x" % (name, n, seed))
    cuts = np.sort(rng.integers(0, 3 * span, 6))
    pieces = np.split(big_host[: 3 * span], cuts)
    crc, adl = 0, 1
    for p in pieces:
        crc, adl = crc32(p, crc), adler32(p, adl)
    whole = big_host[: 3 * span]
    a, b = whole[:span + 777], whole[span + 777:]
    checks = {
        "chain of 7": (crc, adl) == (zlib.crc32(whole), zlib.adler32(whole)),
        "crc32_combine": crc32_combine(crc32(a), crc32(b), len(b))
        == zlib.crc32(whole),
        "adler32_combine": adler32_combine(adler32(a), adler32(b),
                                           len(b)) == zlib.adler32(whole),
    }
    bad += [k for k, v in checks.items() if not v]
    emit({"phase": "E", "ragged_and_chains_equal": not bad, "failed": bad[:10]})
    if bad:
        raise SystemExit("phase E: checksums differ from zlib: %s" % ", ".join(bad[:10]))


def phase_e_latency(big_host, big) -> None:
    """Warm host ms of the public crc32 and adler32 of card tensors of
    200 KiB, 8 MiB and 256 MiB (median of 10 after 3 warm-ups); every call
    must equal zlib, launch its scalar kernel (crc32_scalar, adler32_scalar)
    once and never reach the host tree or the torch combine."""
    import statistics

    import tpuzlib_torch
    from tpuzlib_torch.kernels import _build, adler32_cuda, crc32 as crc_host

    host_calls = []
    tree, totals = crc_host._combine_blocks, adler32_cuda.adler32_totals
    crc_host._combine_blocks = lambda *args: host_calls.append(1) or tree(*args)
    adler32_cuda.adler32_totals = lambda *args: host_calls.append(1) or totals(*args)
    bad = []
    try:
        for name, fn, ref, kernel in (("crc32", tpuzlib_torch.crc32, zlib.crc32, "crc32_scalar"),
                                      ("adler32", tpuzlib_torch.adler32, zlib.adler32,
                                       "adler32_scalar")):
            for n in (200 << 10, 8 << 20, big.numel()):
                x, want = big[:n], ref(big_host[:n])
                for _ in range(3):
                    fn(x)
                launched = _build.LAUNCHES[kernel]
                ms, got = [], set()
                for _ in range(10):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got.add(fn(x))
                    ms.append((time.perf_counter() - t0) * 1e3)
                launched = _build.LAUNCHES[kernel] - launched
                emit({"phase": "E latency", "checksum": name, "bytes": n,
                      "warm_ms_median": statistics.median(ms), "warm_ms": ms,
                      "equal": got == {want}, kernel + "_launches": launched,
                      "host_combine_calls": len(host_calls)})
                if got != {want} or launched != 10 or host_calls:
                    bad.append("%s of %d bytes" % (name, n))
    finally:
        crc_host._combine_blocks, adler32_cuda.adler32_totals = tree, totals
    if bad:
        raise SystemExit("phase E: the warm %s differs from zlib, or did not take one scalar"
                         " launch a call and no host combine" % ", ".join(bad))


def phase_f() -> None:
    """tpuzlib_torch.entry's forward step on the card against the CPU."""
    from tpuzlib_torch import entry

    fn, args = entry.entry(device=DEVICE)
    got = [t.cpu() for t in fn(*args)]
    want = fn(*(a.cpu() for a in args))
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    emit({"phase": "F", "equal": same, "ok": want[2].tolist(), "total_bits": want[1].tolist()})
    if not same:
        raise SystemExit("phase F: entry()'s step on the card differs from the CPU")


def phase_g1(raw6: np.ndarray) -> dict:
    """The decode's two kernels against their plain versions at the shapes
    of the level-6 32 MiB stream's payload: the lookup tables, then the
    decode from them; the decode's time at other block sizes, the length
    of its cursors' chains, and how often the tables miss."""
    from tpuzlib_torch.kernels import inflate_cuda as ic, inflate_device2 as d2

    lay = d2.plan_cursors(raw6, device=DEVICE)
    args = lay.decode_args(raw6, DEVICE)
    emit({"phase": "G1", "compressed_bytes": len(raw6), "K": lay.K, "Kpad": lay.Kpad,
          "cap": lay.cap, "nwp": args.nwp, "stride_bits": lay.stride_bits,
          "blocks": len(lay.plan), "lut_bits": [ic.LUT_BITS, ic.DLUT_BITS],
          "threads": ic.DECODE_THREADS})
    src, replaces = "tpuzlib_torch/kernels/csrc/inflate_decode.cu", "tpuzlib/kernels/inflate_pallas.py:155"
    tables = (args.tabs, args.lents, args.dents)
    luts = ic.decode_luts(args)
    rows = check_kernels({
        # each row counts the lengths up to the table's bits
        "inflate_lut": (lambda: ic.decode_luts(args), lambda: ic.decode_luts_plain(*tables),
                        src, replaces, tables,
                        len(lay.plan) * ((1 << ic.LUT_BITS) * ic.LUT_BITS
                                         + (1 << ic.DLUT_BITS) * ic.DLUT_BITS)),
        # one table lookup a symbol decoded
        "inflate_decode": (lambda: ic.cursor_decode(args, luts), lambda: ic.cursor_tokenize_plain(args),
                           src, replaces, (args, luts), lambda got: int(got[2].long().sum()), 2),
    }, phase="G1")
    ref = ic.cursor_decode(args, luts)
    for threads in (32, 64, 128):
        got = ic.cursor_decode(args, luts, threads)
        emit({"phase": "G1 block size", "threads": threads,
              "equal": all(torch.equal(g, r) for g, r in zip(got, ref)),
              "ms": cuda_ms(lambda: ic.cursor_decode(args, luts, threads))})
    cnt = ref[2][: lay.K].long()
    longest = int(cnt.max())
    emit({"phase": "G1 chains", "symbols": int(cnt.sum()), "longest": longest,
          "mean": float(cnt.float().mean()),
          "ns_per_symbol_of_longest": rows["inflate_decode"]["ms"] * 1e6 / longest,
          **lut_misses(args, luts, ref)})
    return rows


def phase_g1_scan(raw6: np.ndarray) -> dict:
    """The header scan's two kernels (one tz_header_scan call) on the
    stream words of G2's main-path stream (the level-6 32 MiB stream's
    payload) as its plan uploads them: the filter's survivors (all pass
    the plain filter, and as many) and the parse's positions equal the
    plain version's on the same tensors; the call's time by CUDA events
    and queued behind a sleep, split between the kernels by their device
    times in torch.profiler; each kernel's bound (header_scan.bounds_ms of
    the plain version's counts, at MEM_RATE and INT32_RATE)."""
    from tpuzlib_torch.kernels import _build, header_scan as hs, inflate_device2 as d2

    lay = d2.plan_cursors(raw6, device=DEVICE)
    words, nbits = lay.words, 8 * len(raw6)
    from_bit = (lay.plan[0].data_start >> 3) * 8
    work = hs.work_plain(words, nbits, from_bit)
    cap = work["survivors"]
    cand = torch.empty(cap, dtype=torch.int32, device=DEVICE)
    res = torch.empty(2 + cap, dtype=torch.int32, device=DEVICE)

    def call():
        _build.launch(("header_filter", "header_parse"), "tz_header_scan", words.device,
                      words.data_ptr(), words.numel(), nbits, from_bit, 1, cand.data_ptr(), cap,
                      res.data_ptr())

    call()
    torch.cuda.synchronize()
    n_filter, n_parse = int(res[0]), int(res[1])
    filtered = cand[: min(n_filter, cap)].long().sort().values
    passed = np.sort(res[2: 2 + n_parse].cpu().numpy().astype(np.int64))
    plain_t0 = time.perf_counter()
    want = hs.candidates_plain(words, nbits, from_bit)
    plain_ms = (time.perf_counter() - plain_t0) * 1e3
    errs = {"header_filter": abs(n_filter - cap) + len(filtered) - len(
                hs._filter_plain(hs._windows(words), filtered, True)),
            "header_parse": int(len(passed) != len(want) or not np.array_equal(passed, want))}
    errs["header_parse"] |= int(not np.array_equal(hs.candidates(words, nbits, from_bit), want))
    call_ms, call_device_ms = cuda_ms(call), device_ms(call)
    kernel_ms = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        for name in errs:
            if name + "_kernel" in ev.key:
                t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
                kernel_ms[name] = t / 1e3 / max(1, ev.count)
    if set(kernel_ms) != set(errs) or not all(kernel_ms.values()):
        raise SystemExit("phase G1 scan: torch.profiler timed no %s kernel"
                         % ", ".join(sorted(set(errs) - set(kernel_ms))))
    bounds = hs.bounds_ms(work, MEM_RATE, INT32_RATE, SLEEP_HZ)
    src = "tpuzlib_torch/kernels/csrc/header_scan.cu"
    rows = {}
    for name, err in errs.items():
        share = kernel_ms[name] / sum(kernel_ms.values())
        bound_ms, bound_by = bounds[name]
        ms, dev_ms = share * call_ms, share * call_device_ms
        rows[name] = dict(name=name, route="cuda", source=src, replaces=None, launches=None,
                          max_abs_err=err, ms=ms, device_ms=dev_ms, profiler_ms=kernel_ms[name],
                          plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None, pct_of_bound=100 * bound_ms / ms,
                          device_pct_of_bound=100 * bound_ms / dev_ms)
        emit({"phase": "G1 scan", **rows[name]})
    emit({"phase": "G1 scan", "stream_bytes": len(raw6), "from_bit": from_bit, "work": work,
          "call_ms": call_ms, "call_device_ms": call_device_ms, "headers": len(want)})
    if any(errs.values()):
        raise SystemExit("phase G1 scan: %s differs from its plain version"
                         % ", ".join(k for k, v in errs.items() if v))
    return rows


def lut_misses(args, luts, toks) -> dict:
    """Shares of the tape's symbols whose code a primary table of W bits
    does not hold, for W = 9, 10 (lit/len) and 6, 7, 8 (distance, after a
    length whose code the lit/len table holds), and for W = 10 and 8 the
    share of warp steps (32 neighbouring cursors, one row each) in which
    some lane misses, which the whole warp then waits for."""
    from tpuzlib_torch.kernels import inflate_cuda as ic

    K, cap = args.cur.shape[1], args.cap
    tok, bp = toks[0].view(K, cap).long(), toks[1].view(K, cap).long()
    valid = torch.arange(cap, device=bp.device)[None, :] < toks[2].long()[:, None]
    sw = args.cur[ic.C_SWSTART].long()[:, None]
    rel = torch.where(valid, bp - (sw << 5), 0)
    words = args.words.long() & 0xFFFFFFFF
    j = sw + (rel >> 5)
    hi = words[(j + 1).clamp(max=words.numel() - 1)]
    win = ((words[j] | (hi << 32)) >> (rel & 31)) & 0xFFFFFFFF
    blk = args.cur[ic.C_BLOCK].long()[:, None]
    lit = luts[blk, win & ((1 << ic.LUT_BITS) - 1), 1].long()
    llen = lit & 0xFF
    after = (win >> (lit >> 8)) & ((1 << ic.DLUT_BITS) - 1)  # past the code and its extra bits
    dlen = luts[blk, (1 << ic.LUT_BITS) + after, 1].long() & 0xFF
    has_dist = valid & ((tok >> 25) & 1).bool() & (llen > 0)
    out = {}
    for W in (9, 10):
        miss = valid & ((llen == 0) | (llen > W))
        out["lit_miss_share_W%d" % W] = float(miss.sum() / valid.sum())
    for Wd in (6, 7, 8):
        miss = has_dist & ((dlen == 0) | (dlen > Wd))
        out["dist_miss_share_Wd%d" % Wd] = float(miss.sum() / has_dist.sum())
    miss = (valid & (llen == 0)) | (has_dist & (dlen == 0))
    warps = lambda m: m[: K // 32 * 32].view(-1, 32, cap).any(1)  # noqa: E731
    out["warp_steps_with_a_miss"] = float(warps(miss).sum() / warps(valid).sum())
    return out


def flag_census(raw: np.ndarray, device=DEVICE) -> dict:
    """Why a raw stream's splice validates or declines: its ok under the
    port's rule (any kept flagged EOB declines), under tpuzlib's (only
    each cursor's first flag, eob_idx, counts: the same splice on a tape
    with every later flag cleared) and with every flag cleared (what else
    declines: an unlinked boundary, a bad status), and how many cursors
    keep their first flag, or any flag."""
    from tpuzlib_torch.kernels import inflate_cuda, inflate_device2 as d2

    lay = d2.plan_cursors(raw, device=device)
    toks = inflate_cuda.cursor_decode(lay.decode_args(raw, device))
    vecs = (lay.stops, lay.bstart, lay.first, lay.last, lay.expect_eob, lay.active)
    tok2 = toks[0].view(lay.Kpad, lay.cap)
    flag = ((tok2 >> 26) & 1).bool()
    col = torch.arange(lay.cap, device=tok2.device)[None, :]
    first_only = torch.where(flag & (col != toks[5][:, None]), 0, tok2).reshape(-1)
    no_flags = torch.where(flag, 0, tok2).reshape(-1)
    ok = {name: int(d2.splice_compact((t, *toks[1:]), *vecs)[0][0])
          for name, t in (("port", toks[0]), ("tpuzlib_first_flag", first_only),
                          ("no_flags", no_flags))}
    meta = d2.splice_compact(toks, *vecs)[0].cpu().numpy()
    jentry, kcnt, eob = (d2._meta_vec(meta, lay.Kpad, i)
                         for i in (d2.META_JENTRY, d2.META_KCNT, d2.META_EOB))
    # the kept rows [lo, lo + kcnt): from row 0 at a block's first cursor,
    # else from the row where the previous cursor's chain enters
    lo = np.where(lay.first, 0, np.concatenate([[0], jentry[:-1]]))
    first_kept = (eob >= 0) & (eob >= lo) & (eob < lo + kcnt)
    flagged = d2.flagged_rows(toks[0], lay.Kpad)
    any_kept = sum(bool(np.any((r >= lo[k]) & (r < lo[k] + kcnt[k]))) for k, r in flagged.items())
    return {"K": lay.K, "blocks": len(lay.plan), "splice_ok": ok,
            "flagged_cursors": len(flagged), "first_flag_kept": int(first_kept.sum()),
            "any_flag_kept": any_kept}


def phase_g2(corpus, z6: bytes, gzip32: np.ndarray) -> dict:
    """tpuzlib_torch.inflate on every container and block kind, then
    inflate_device_v2's pass-3 variants and the forced repair, each equal
    to its input; cold and warm times.  The text stream's splice must
    validate (no repair) unless the repair is forced.  Returns each
    stream's raw DEFLATE payload by name."""
    import tpuzlib_torch
    from tpuzlib_torch.api import inflate_api
    from tpuzlib_torch.kernels import inflate_device2 as d2
    from tpuzlib_torch.testing import corpus as make_corpus, counters_since, zlib_stream
    from tpuzlib_torch.utils import trace

    small = corpus[: 8 << 20]
    text = make_corpus("text", 8 << 20, seed=2)
    streams = {  # name -> (wire, its bytes)
        "zlib L6": (z6, corpus),
        "zlib L1": (zlib_stream(small, 1), small),
        "zlib L9": (zlib_stream(small, 9), small),
        "zlib Z_FIXED": (zlib_stream(small, 6, strategy=zlib.Z_FIXED), small),
        "zlib sync flush / 64 KiB": (zlib_stream(small, 6, flush_every=1 << 16), small),
        "raw L6": (zlib_stream(small, 6, wbits=-15), small),
        "zlib L6 text": (zlib_stream(text, 6), text),
        "zlib L6 text, 512 KiB": (zlib_stream(text[: 512 << 10], 6), text[: 512 << 10]),
    }
    if len(streams["zlib L6 text, 512 KiB"][0]) >= inflate_api.DEVICE_MIN_BYTES:
        raise SystemExit("phase G2: the small stream is not under inflate()'s device floor")
    # each stream's raw DEFLATE payload: a zlib stream's less its 2-byte
    # header and 4-byte trailer
    payload = {}
    for name, (wire, _) in streams.items():
        a = np.frombuffer(wire, np.uint8)
        payload[name] = a if name.startswith("raw") else a[2:-4]
    del payload["zlib L6 text, 512 KiB"]  # the host route's: no census

    inflate = tpuzlib_torch.inflate
    v2 = d2.inflate_device_v2
    w = lambda k: streams[k][0]  # noqa: E731
    raw6, text_raw = payload["zlib L6"], payload["zlib L6 text"]
    # (name, input, expected bytes, function, keywords, splice repairs
    # required per call: None where the stream decides)
    runs = [
        ("inflate zlib L6", w("zlib L6"), corpus, inflate, {}, None),
        ("inflate gzip (port's deflate, L6)", gzip32.tobytes(), corpus, inflate, {}, None),
        ("inflate zlib L1", w("zlib L1"), small, inflate, {}, None),
        ("inflate zlib L9", w("zlib L9"), small, inflate, {}, None),
        ("inflate zlib Z_FIXED", w("zlib Z_FIXED"), small, inflate, {}, None),
        ("inflate zlib sync flush / 64 KiB", w("zlib sync flush / 64 KiB"), small, inflate, {},
         None),
        ("inflate raw L6", w("raw L6"), small, inflate, {}, None),
        ("inflate zlib L6 text", w("zlib L6 text"), text, inflate, {}, 0),
        ("inflate zlib L6 text, 512 KiB", w("zlib L6 text, 512 KiB"), text[: 512 << 10], inflate,
         {}, None),
        ("v2 host expand", raw6, corpus, v2, {"device_expand": False}, None),
        ("v2 device expand", raw6, corpus, v2, {"device_expand": True}, None),
        ("v2 device expand, sync flush / 64 KiB", payload["zlib sync flush / 64 KiB"], small,
         v2, {"device_expand": True}, None),
        ("v2 host expand, text", text_raw, text, v2, {"device_expand": False}, 0),
        ("v2 device expand, text", text_raw, text, v2, {"device_expand": True}, 0),
        ("v2 forced repair, text", text_raw, text, v2, {"force_repair": True}, 1),
        ("v2 device expand, forced repair, text", text_raw, text, v2,
         {"device_expand": True, "force_repair": True}, 1),
    ]
    # inflate()'s route rule keeps a raw stream and one under its floor on
    # the host route: the device route's counters must not move for them
    # (the raw stream's device decode is held by the v2 rows)
    host_rows = {"inflate raw L6", "inflate zlib L6 text, 512 KiB"}
    bad = []
    for name, wire, want, fn, kw, repairs in runs:
        before = trace.get_counters()
        times, out, declined = [], None, False
        for _ in range(2):  # the second run is the warm one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(wire, device=DEVICE, **kw)
            except tpuzlib_torch.DeviceDeclined as e:
                declined = str(e)
            if torch.is_tensor(out):
                out = out.cpu().numpy()
            times.append(time.perf_counter() - t0)
            if out is None:
                declined = declined or "returned None"
        equal = not declined and out.tobytes() == want.tobytes()
        counts = counters_since(before)
        emit({"phase": "G2", "run": name, "bytes_in": len(wire), "bytes_out": len(want),
              "equal": equal, "declined": declined, "cold_s": times[0], "warm_s": times[1],
              "warm_MBps": len(want) / times[1] / 1e6, "counts": counts})
        route = tuple(counts.get(k, 0) for k in ("inflate.device_fallback",
                                                  "inflate.device_mismatch_fallback",
                                                  "inflate.device"))
        if not equal:
            bad.append(name)
        elif name in host_rows:
            if route != (0, 0, 0):
                bad.append("%s (fallbacks %d + %d, %d bytes from the device route, want the "
                           "host route: 0 + 0, 0)" % (name, *route))
        elif fn is inflate and route != (0, 0, 2 * len(want)):
            # both calls' bytes must come from the device route: the host
            # engine behind it would hide a wrong decode
            bad.append("%s (fallbacks %d + %d, %d bytes from the device route, want 0 + 0, %d)"
                       % (name, *route, 2 * len(want)))
        elif repairs is not None and counts.get("inflate.splice_repair", 0) != 2 * repairs:
            bad.append("%s (%d splice repairs in two calls, want %d)"
                       % (name, counts.get("inflate.splice_repair", 0), 2 * repairs))
    if bad:
        raise SystemExit("phase G2: %s" % ", ".join(bad))
    return payload


def phase_g3(corpus, raw6: np.ndarray, reps: int = 3) -> None:
    """The level-6 32 MiB decode's pieces, in the order decode() runs them
    (the splice repair where the splice declines), timed apart on the host
    clock with the card idle between them; medians over `reps` runs."""
    from tpuzlib_torch import adler32
    from tpuzlib_torch.codec.expand import expand_host
    from tpuzlib_torch.kernels import inflate_cuda, inflate_device2 as d2

    want = zlib.adler32(corpus)
    pieces: dict = {}
    repaired = []

    def piece(name, fn):
        out, ms = timed(fn)
        pieces.setdefault(name, []).append(ms)
        return out

    for _ in range(reps):
        lay = piece("plan (words H2D, card header scan + block loop)",
                    lambda: d2.plan_cursors(raw6, device=DEVICE))
        args = piece("tables + H2D", lambda: lay.decode_args(raw6, DEVICE))
        toks = piece("decode kernel", lambda: inflate_cuda.cursor_decode(args))
        meta, comp, _ = piece("splice", lambda: d2.splice_compact(
            toks, lay.stops, lay.bstart, lay.first, lay.last, lay.expect_eob, lay.active))
        meta_np = piece("meta pull", lambda: meta.cpu().numpy())
        M = int(meta_np[1])
        kcnt = d2._meta_vec(meta_np, lay.Kpad, d2.META_KCNT)[: lay.K]
        bridges = None
        repaired.append(int(meta_np[0]) != 1)
        if repaired[-1]:
            flagged = piece("repair: flagged-row pull", lambda: d2.flagged_rows(toks[0], lay.Kpad))
            keep_lo, keep_hi, bridges, ends = piece(
                "repair: walk and bridges",
                lambda: d2._repair_splice(raw6, lay, meta_np, toks[1], flagged))
            M_r, comp, kcnt_t = piece("repair: compaction", lambda: d2.compact_bounds(
                toks[0], torch.from_numpy(keep_lo).to(DEVICE),
                torch.from_numpy(keep_hi).to(DEVICE)))
            M, kcnt = int(M_r), kcnt_t.cpu().numpy()[: lay.K]
        else:
            ends = d2.fast_block_ends(lay, meta_np)
        ins, tail, _ = piece("gap walk", lambda: d2.walk_blocks(raw6, lay, ends))
        parts = d2.token_pieces(lay, M, kcnt, ins, tail, bridges)
        comph = piece("compacted-tape pull", lambda: comp[:M].cpu().numpy().view(np.uint32))
        host = piece("host expansion (token assembly + native expand)",
                     lambda: expand_host(*d2.host_tokens(comph, parts), np.empty(0, np.uint8)))
        win = torch.zeros(d2.WINDOW, dtype=torch.uint8, device=DEVICE)
        dev_out = piece("device expansion (tape assembly + pointer doubling)",
                        lambda: d2.device_expand_all(*d2.device_tape(comp, M, parts), win,
                                                     8 * len(raw6) + (1 << 16)))
        ok = piece("checksum (host output: H2D + adler32)",
                   lambda: adler32(host, device=DEVICE)) == want
        ok &= piece("checksum (device output: adler32)",
                    lambda: adler32(dev_out, device=DEVICE)) == want
        if not (ok and host.tobytes() == corpus.tobytes()
                and dev_out.cpu().numpy().tobytes() == corpus.tobytes()):
            raise SystemExit("phase G3: the timed pieces do not give the input")
        del toks, comp, dev_out
    emit({"phase": "G3", "bytes_in": len(raw6), "bytes_out": len(corpus), "reps": reps,
          "repaired": repaired, "median_ms": {k: float(np.median(v)) for k, v in pieces.items()},
          "ms": pieces})


def phase_h(big_host: np.ndarray, big) -> tuple:
    """The CRC probe kernels against their plain versions on `big` (the
    product alone on its first 8 MiB, unpacked to bf16 bits beforehand),
    the CRC of both tensor-core forms against zlib and the table fold,
    each kernel's time at every (B, tile) the tools run, beside the table
    fold; then the three probes at 8 MiB, over which the kernels' launches
    are counted.  Returns (rows, launches)."""
    from tpuzlib_torch import tools
    from tpuzlib_torch.kernels import _build, crc32_cuda, crc32_probe as cp
    from tpuzlib_torch.tools import probe_crc, probe_crc2, probe_crc3

    src, n, dev = "tpuzlib_torch/kernels/csrc/crc32_probe.cu", big.numel(), big.device
    rows = big.view(-1, 1024)
    small = rows[: (8 << 20) // 1024]
    bits = cp.plane_bits(small)
    # the same bits 3 elements past a 16-byte boundary: no tensor map takes
    # them, the kernel's consumers load them (route "ldg", off the probes' path)
    bits_ldg = torch.empty(bits.numel() + 8, dtype=torch.bfloat16, device=dev)[3:]
    bits_ldg = bits_ldg[: bits.numel()].view(bits.shape)
    bits_ldg.copy_(bits)
    m = cp.form_matrix(1024, torch.bfloat16, dev)
    # the library calls: the bf16 product into float32 (the same function on
    # the same input, but for the parity), else a float32 product of 0/1
    # values, exact, with TF32 off so that it is the float32 product; and
    # the int8 product
    torch.backends.cuda.matmul.allow_tf32 = False
    bits_f32, m_f32 = bits.float(), m.float()
    bits_i8, m_i8 = bits.to(torch.int8), m.to(torch.int8)
    try:
        torch.mm(bits[:1], m, out_dtype=torch.float32)
        bits_library, ldg_library, bits_library_note = (
            lambda: torch.mm(bits, m, out_dtype=torch.float32),
            lambda: torch.mm(bits_ldg, m, out_dtype=torch.float32),
            "torch.mm(bits, m, out_dtype=torch.float32), bf16")
    except (TypeError, RuntimeError) as e:
        bits_library = ldg_library = lambda: torch.mm(bits_f32, m_f32)
        bits_library_note = "float32 torch.mm: this torch refuses out_dtype (%s)" % e
    # operations: an add a byte; a shift-and-mask and an add a bit; the
    # products' multiply-adds (8 bits x 32 columns x 2 a byte of the forms)
    cases = {"crc_rowsum": (lambda: cp.crc_rowsum(rows), lambda: cp.crc_rowsum_plain(rows), src,
                            "tools/probe_crc2.py:89", (rows,), n)}
    for mode in cp.MODES:
        cases["crc_unpack_" + mode] = (
            lambda mode=mode: cp.crc_unpack(rows, mode),
            lambda mode=mode: cp.crc_unpack_plain(rows, mode),
            src, "tools/probe_crc2.py:122", (rows,), 16 * n)
    cases["gf2_bits_mm"] = (lambda: cp.gf2_bits_mm(bits, m), lambda: cp.gf2_bits_mm_plain(bits, m),
                            src, "tools/probe_crc2.py:179", (bits, m), 2 * bits.numel() * 32)
    cases["gf2_bits_mm_ldg"] = (lambda: cp.gf2_bits_mm(bits_ldg, m),
                                lambda: cp.gf2_bits_mm_plain(bits_ldg, m), src,
                                "tools/probe_crc2.py:179", (bits_ldg, m), 2 * bits.numel() * 32)
    for dt, (torch_dtype, _) in cp.DTYPES.items():
        cases["crc_forms_mm_" + dt] = (
            lambda dt=dt: cp.crc_forms_mm(rows, dt), lambda dt=dt: cp.crc_forms_mm_plain(rows, dt),
            src, "tools/probe_crc.py:70", (rows, cp.form_matrix(1024, torch_dtype, dev)), 512 * n)
    rates = {"gf2_bits_mm": BF16_RATE, "gf2_bits_mm_ldg": BF16_RATE,
             "crc_forms_mm_bf16": BF16_RATE, "crc_forms_mm_i8": INT8_RATE}
    out = check_kernels(cases, phase="H", rates=rates, library={
        "crc_rowsum": lambda: rows.sum(1, dtype=torch.int32), "gf2_bits_mm": bits_library,
        "gf2_bits_mm_ldg": ldg_library})
    for dt in cp.DTYPES:
        out["crc_forms_mm_" + dt]["also_replaces"] = "tools/probe_crc3.py:63 (the bf16 kernel)"
    gf2 = out["gf2_bits_mm"]
    gf2["library_call"] = bits_library_note
    gf2["library_f32_ms"] = cuda_ms(lambda: torch.mm(bits_f32, m_f32))
    gf2["library_int8_ms"] = cuda_ms(lambda: torch._int_mm(bits_i8, m_i8))
    for name, x in (("gf2_bits_mm", bits), ("gf2_bits_mm_ldg", bits_ldg)):
        out[name].update(kernel="gf2_bits_mm", rows_route=cp.bits_mm_route(x),
                         device_ms=device_ms(cases[name][0]))
        out[name]["device_pct_of_bound"] = 100 * out[name]["bound_ms"] / out[name]["device_ms"]
    if (gf2["rows_route"], out["gf2_bits_mm_ldg"]["rows_route"]) != ("tma", "ldg"):
        raise SystemExit("phase H: gf2_bits_mm's rows do not cover both routes")
    emit({"phase": "H bits", **{k: gf2[k] for k in ("ms", "device_ms", "bound_ms",
                                                     "device_pct_of_bound", "library_ms",
                                                     "library_call", "library_f32_ms",
                                                     "library_int8_ms")},
          "ldg_ms": out["gf2_bits_mm_ldg"]["ms"],
          "ldg_device_ms": out["gf2_bits_mm_ldg"]["device_ms"],
          "ldg_library_ms": out["gf2_bits_mm_ldg"]["library_ms"]})
    del bits_f32, bits_i8, bits_ldg

    want = zlib.crc32(big_host)
    fold = crc32_cuda.crc32_forms(big, 0, 1)
    bad = []
    for dt in cp.DTYPES:
        for B in cp.FORM_BLOCKS:
            cols = cp.crc_forms_mm(big.view(-1, B), dt)
            if tools.forms_crc(cols, B, n) != want:
                bad.append("%s B%d: the CRC differs from zlib" % (dt, B))
            if B == 1024 and not torch.equal(cp.pack_forms(cols), fold):
                bad.append("%s: the forms differ from the table fold" % dt)
    emit({"phase": "H crc", "bytes": n, "zlib": want, "equal": not bad, "failed": bad})
    if bad:
        raise SystemExit("phase H: %s" % ", ".join(bad))
    # the same bytes at offset 3: no tensor map takes them, the kernel's
    # consumers load their rows' words themselves
    shifted = torch.empty(n + 3, dtype=torch.uint8, device=dev)[3:]
    shifted.copy_(big)
    srows = shifted.view(-1, 1024)
    swant = cp.crc_forms_mm_plain(srows)
    unaligned = {}
    for dt in cp.DTYPES:
        got = cp.crc_forms_mm(srows, dt)
        unaligned[dt] = {"route": cp.forms_route(srows), "equal": torch.equal(got, swant),
                         "ms": cuda_ms(lambda: cp.crc_forms_mm(srows, dt)),
                         "aligned_ms": out["crc_forms_mm_" + dt]["ms"]}
    emit({"phase": "H unaligned", "offset": 3, "bytes": n, "B": 1024, "tile": cp.TILES[0],
          **unaligned})
    del shifted, srows, swant, got
    if not all(u["equal"] for u in unaligned.values()) or any(
            u["route"] != "ldg" for u in unaligned.values()):
        raise SystemExit("phase H: the forms at offset 3 differ from the plain version")
    for dt in cp.DTYPES:  # the route of the kernel's rows ("route" is the kernel's language)
        out["crc_forms_mm_" + dt]["rows_route"] = cp.forms_route(rows)

    def time_line(kernel, mode, B, tile, data_bytes, row, route=None):
        emit({"phase": "H time", "kernel": kernel, "mode": mode, "B": B, "tile": tile,
              "route": route, "ms": row["ms"], "GBps": data_bytes / row["ms"] / 1e6,
              **{k: row[k] for k in ("bound_ms", "bound_by", "pct_of_bound")}})

    # the rows above at their own shapes; the forms' other (B, tile) pairs
    # timed here
    time_line("crc_rowsum", None, 1024, None, n, out["crc_rowsum"])
    for mode in cp.MODES:
        time_line("crc_unpack", mode, 1024, None, n, out["crc_unpack_" + mode])
    for name in ("gf2_bits_mm", "gf2_bits_mm_ldg"):
        time_line("gf2_bits_mm", "bf16", 1024, None, small.numel(), out[name],
                  out[name]["rows_route"])
    for dt, (torch_dtype, _) in cp.DTYPES.items():
        for B, tile in FORM_PAIRS:
            if (B, tile) == (1024, cp.TILES[0]):
                row = out["crc_forms_mm_" + dt]
            else:
                blocks = big.view(-1, B)
                ms = cuda_ms(lambda: cp.crc_forms_mm(blocks, dt, tile))
                bytes_ms = (n + nbytes(cp.form_matrix(B, torch_dtype, dev))
                            + 128 * blocks.shape[0]) / MEM_RATE * 1e3
                ops_ms = 512 * n / rates["crc_forms_mm_" + dt] * 1e3
                row = dict(ms=ms, bound_ms=max(bytes_ms, ops_ms),
                           bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                           pct_of_bound=100 * max(bytes_ms, ops_ms) / ms)
            time_line("crc_forms_mm", dt, B, tile, n, row, cp.forms_route(big.view(-1, B)))
    fold_ms = cuda_ms(lambda: crc32_cuda.crc32_forms(big, 0, 1))
    bf16_ms, i8_ms = out["crc_forms_mm_bf16"]["ms"], out["crc_forms_mm_i8"]["ms"]
    emit({"phase": "H compare", "bytes": n, "table_fold_ms": fold_ms, "forms_bf16_ms": bf16_ms,
          "forms_i8_ms": i8_ms, "rowsum_ms": out["crc_rowsum"]["ms"],
          "read_GBps": n / out["crc_rowsum"]["ms"] / 1e6, "bf16_over_fold": bf16_ms / fold_ms,
          "i8_over_fold": i8_ms / fold_ms})

    _build.reset_launches()
    for route in cp.BITS_ROUTES:
        cp.BITS_ROUTES[route] = 0
    for probe in (probe_crc, probe_crc2, probe_crc3):
        probe.main(["--mib", "8"])
    torch.cuda.synchronize()
    if sum(cp.BITS_ROUTES.values()) != _build.LAUNCHES["gf2_bits_mm"]:
        raise SystemExit("phase H: gf2_bits_mm's launches by route %s do not add up to %d"
                         % (cp.BITS_ROUTES, _build.LAUNCHES["gf2_bits_mm"]))
    launches = {k: _build.LAUNCHES[k] for k in out if k in _build.LAUNCHES}
    # each gf2_bits_mm row's launches: its route's
    for name in ("gf2_bits_mm", "gf2_bits_mm_ldg"):
        launches[name] = cp.BITS_ROUTES[out[name]["rows_route"]]
        out[name]["launches_by_route"] = dict(cp.BITS_ROUTES)
    return out, launches


def phase_i(smi: str) -> tuple:
    """The gather and primitive probe kernels against their plain versions
    (exact) at the shapes named in the module docstring, the launch floor,
    then the four probes, over which the kernels' launches are counted.
    Returns (rows, launches); a take_along row names its kernel."""
    from tpuzlib_torch.codec.tables import FIXED_LITLEN_LENGTHS
    from tpuzlib_torch.kernels import _build, gather_probe as gp, inflate_cuda, inflate_prims as ip
    from tpuzlib_torch.tools import (probe_gather, probe_inflate_prims, probe_inflate_prims2,
                                     probe_primitives)
    from probes import launch_breakdown

    rng = np.random.default_rng(9)

    def ints(shape, lo=-(1 << 31), hi=(1 << 31) - 1):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int32)).to(DEVICE)

    gsrc, isrc = ("tpuzlib_torch/kernels/csrc/%s.cu" % n for n in ("gather_probe", "inflate_prims"))
    chunks, lanes = (BATCH, 2304, 128), 8192
    cases, library, kernel_of = {}, {}, {}
    # take_along: one element gathered a lane; the axis-1 rows up to
    # staged_words() wide are staged in shared memory, wider ones (the
    # _wide row, 256 KiB) gathered through the read-only cache, as are the
    # sublane (axis 0) gathers; x_sector_bytes: a 32-byte sector read a
    # gather through the cache
    staged = gp.staged_words()
    design = {}
    for name, xshape, ishape, axis, replaces in (
        ("take_along_axis1", (64, 4352), (64, 4352), 1, "tools/probe_gather.py:54"),
        ("take_along_axis1_wide", (64, 65536), (64, 65536), 1, "tools/probe_gather.py:54"),
        ("take_along_axis0", (4352, 128), (4352, 128), 0, "tools/probe_gather.py:75"),
        ("take_along_axis0_batch8", (BATCH * 2304, 128), (BATCH * 2304, 128), 0,
         "tools/probe_gather.py:75"),
    ):
        x, idx = ints(xshape), ints(ishape, 0, xshape[axis])
        idx64 = idx.long()
        cases[name] = (lambda x=x, idx=idx, axis=axis: gp.take_along(x, idx, axis),
                       lambda x=x, idx=idx, axis=axis: gp.take_along_plain(x, idx, axis),
                       gsrc, replaces, (x, idx), idx.numel())
        library[name] = lambda x=x, idx64=idx64, axis=axis: torch.gather(x, axis, idx64)
        kernel_of[name] = "take_along"
        design[name] = "staged" if axis == 1 and xshape[1] <= staged else "ldg"
    # take_along_loop at the tools' three shapes, staged, and past the
    # staged limit through the read-only cache; 64 gathers an element
    loop_designs = {}
    for name, shape, axis in (("take_along_loop", (4352, 128), 0),
                              ("take_along_loop_axis0_1024", (1024, 128), 0),
                              ("take_along_loop_axis1_1024", (1024, 128), 1),
                              ("take_along_loop_wide", (staged + 1, 32), 0)):
        x, idx = ints(shape), ints(shape, 0, shape[axis])
        cases[name] = (lambda x=x, idx=idx, axis=axis: gp.take_along_loop(x, idx, axis, 64),
                       lambda x=x, idx=idx, axis=axis: gp.take_along_loop_plain(x, idx, axis, 64),
                       gsrc, "tools/probe_gather.py:96", (x, idx), 64 * x.numel())
        kernel_of[name] = "take_along_loop"
        loop_designs[name] = gp.loop_design(x, axis)
    if sorted(loop_designs.values()) != ["ldg"] + ["staged"] * 3:
        raise SystemExit("phase I: the loop rows do not cover both designs: %s" % loop_designs)
    # flat_gather: the tools' 128 KiB table staged in shared memory; a 256
    # KiB one (_large) past the staged limit, gathered through the cache
    for name, tshape in (("flat_gather", (256, 128)), ("flat_gather_large", (512, 128))):
        table = ints(tshape)
        fidx = ints(chunks, 0, table.numel())
        fidx64 = fidx.long()
        cases[name] = (lambda table=table, fidx=fidx: gp.flat_gather(table, fidx),
                       lambda table=table, fidx=fidx: gp.flat_gather_plain(table, fidx), gsrc,
                       "tools/probe_primitives.py:176", (table, fidx), fidx.numel())
        library[name] = lambda table=table, fidx64=fidx64: torch.take(table, fidx64)
        kernel_of[name] = "flat_gather"
        design[name] = "staged" if table.numel() <= staged else "ldg"
    if sorted(design.values()) != ["ldg"] * 4 + ["staged"] * 2:
        raise SystemExit("phase I: the gather rows do not cover both designs: %s" % design)
    # shift_screen at the tool's 16 steps (the register route) and at 40,
    # past its window (the staged route, off the probes' path)
    sx = ints(chunks)
    shift_routes = {}
    for name, steps in (("shift_screen", 16), ("shift_screen_staged", 40)):
        cases[name] = (lambda steps=steps: gp.shift_screen(sx, steps),
                       lambda steps=steps: gp.shift_screen_plain(sx, steps), gsrc,
                       "tools/probe_primitives.py:208", (sx,), steps * sx.numel())
        shift_routes[name] = gp.shift_route(sx, steps)
        kernel_of[name] = "shift_screen"
    if sorted(shift_routes.values()) != sorted(gp.SHIFT_DESIGNS):
        raise SystemExit("phase I: the shift rows do not cover every route: %s" % shift_routes)
    # scatter_max into the batch's 2,304 rows (route smem: a chunk's slab of
    # columns in shared memory) and into staged_words() + 1 rows (route
    # global, off the probes' path: an atomic an element into zeros)
    scatter_routes = {}
    for name, shape, rows in (("scatter_max", chunks, chunks[1]),
                              ("scatter_max_global", (1, *chunks[1:]), staged + 1)):
        sidx, svals = ints(shape, 0, rows), ints(shape, 0, (1 << 31) - 1)
        sidx64 = sidx.long()
        sout = torch.zeros(shape[0], rows, shape[2], dtype=torch.int32, device=DEVICE)
        cases[name] = (lambda sidx=sidx, svals=svals, rows=rows: gp.scatter_max(sidx, svals, rows),
                       lambda sidx=sidx, svals=svals, rows=rows: gp.scatter_max_plain(sidx, svals,
                                                                                      rows),
                       gsrc, "tools/probe_primitives.py:196", (sidx, svals), sidx.numel())
        library[name] = (lambda sout=sout, sidx64=sidx64, svals=svals:
                         sout.scatter_reduce_(1, sidx64, svals, "amax"))
        scatter_routes[name] = gp.scatter_route(sidx, rows)
        kernel_of[name] = "scatter_max"
    if sorted(scatter_routes.values()) != sorted(gp.SCATTER_DESIGNS):
        raise SystemExit("phase I: the scatter rows do not cover every route: %s" % scatter_routes)

    # the inflate primitives at 8,192 lanes; operations: one a lane and step.
    # vec_cond_while keeps 8,192 lanes in registers; its rows _smem (at the
    # shared-memory limit) and _global (past it) take its other two routes
    while_route, while_steps = {}, {}
    for name, n in (("vec_cond_while", lanes), ("vec_cond_while_smem", staged),
                    ("vec_cond_while_global", staged + 1)):
        x0 = ints((1, n), 0, 100)
        steps = min(64, max(0, 100 - int(x0.min())))  # the loop's steps on this input
        cases[name] = (lambda x0=x0: ip.vec_cond_while(x0),
                       lambda x0=x0: ip.vec_cond_while_plain(x0),
                       isrc, "tools/probe_inflate_prims.py:81", (x0,), steps * n)
        while_route[name], while_steps[name] = ip.while_route(n, staged), steps
        kernel_of[name] = "vec_cond_while_" + while_route[name]
    if sorted(while_route.values()) != sorted(ip.WHILE_ROUTES):
        raise SystemExit("phase I: the loop rows do not cover every route: %s" % while_route)
    # the row kernels' bytes: j, each distinct word of words they read, out
    words, j = ints((40, lanes)), ints((1, lanes), 0, 37)
    fetched = rows_read(j.long() + torch.arange(3, device=DEVICE)[:, None], 40)
    cases["fetch_rows"] = (lambda: ip.fetch_rows(words, j, 3),
                           lambda: ip.fetch_rows_plain(words, j, 3), isrc,
                           "tools/probe_inflate_prims.py:105",
                           lambda got: nbytes(j) + fetched + nbytes(got), 3 * lanes)
    cases["row_store_loop"] = (lambda: ip.row_store_loop(24, lanes, DEVICE),
                               lambda: ip.row_store_loop_plain(24, lanes, DEVICE), isrc,
                               "tools/probe_inflate_prims.py:58", (), 24 * lanes)
    stored = rows_read(ip.store_loop_steps(j, 40, 16), 40)
    cases["gather_store_loop"] = (lambda: ip.gather_store_loop(words, j, 16),
                                  lambda: ip.gather_store_loop_plain(words, j, 16), isrc,
                                  "tools/probe_inflate_prims.py:131",
                                  lambda got: nbytes(j) + stored + nbytes(got), 16 * lanes)
    cx = ints((16, lanes), 0, 1000)
    cases["col_min_sum"] = (lambda: ip.col_min_sum(cx), lambda: ip.col_min_sum_plain(cx), isrc,
                            "tools/probe_inflate_prims2.py:46", (cx,), 2 * cx.numel())
    rv, eb = ints((1, lanes), 0, 1 << 16), ints((1, lanes), 0, 14)
    cases["var_shifts"] = (lambda: ip.var_shifts(rv, eb), lambda: ip.var_shifts_plain(rv, eb), isrc,
                           "tools/probe_inflate_prims2.py:58", (rv, eb), 17 * lanes)
    _, *cols = inflate_cuda.canon_tables(FIXED_LITLEN_LENGTHS, "litlen")
    tabs = [torch.from_numpy(np.tile(c[:, None], (1, lanes))).to(DEVICE) for c in cols]
    w = ints((1, lanes))
    # tree_decode's bytes: w, rows 1-15 of its tables (row 0 is never read), out
    cases["tree_decode"] = (lambda: ip.tree_decode(w, *tabs), lambda: ip.tree_decode_plain(w, *tabs),
                            isrc, "tools/probe_inflate_prims2.py:82",
                            lambda got: nbytes(w) + nbytes([t[1:] for t in tabs]) + nbytes(got),
                            16 * lanes)
    win = (*(ints((1, lanes)) for _ in range(3)), ints((1, lanes), 0, 32), ints((1, lanes), 0, 21))
    cases["window64"] = (lambda: ip.window64(*win), lambda: ip.window64_plain(*win), isrc,
                         "tools/probe_inflate_prims2.py:139", win, 3 * lanes)

    rows = check_kernels(cases, phase="I", library=library)
    for name, d in loop_designs.items():
        rows[name]["design"] = d
        if d != "staged":
            continue
        # beside the byte bound, the shared memory's: a warp request of 32
        # gathers a cycle an SM, free of bank conflicts; random banks cost
        # ~3.53 times that (the mean busiest of 32 banks for 32 lanes)
        requests = rows[name]["ops"] / 32
        rows[name]["smem_requests"] = requests
        rows[name]["smem_floor_ms"] = requests / (SMS * SLEEP_HZ) * 1e3
        rows[name]["smem_floor_random_ms"] = 3.53 * rows[name]["smem_floor_ms"]
    # the launch floor: take_along on (1, 1), timed both ways, first, so
    # that the rows below can give their device time's excess over it
    one = torch.zeros(1, 1, dtype=torch.int32, device=DEVICE)
    one64 = one.long()
    floor, lib_floor = lambda: gp.take_along(one, one, 1), lambda: torch.gather(one, 1, one64)
    floor_ms, lib_floor_ms = cuda_ms(floor), cuda_ms(lib_floor)
    floor_device_ms = device_ms(floor)
    emit({"phase": "I launch floor", "kernel": "take_along", "shape": [1, 1],
          "ms": floor_ms, "device_ms": floor_device_ms, "library_ms": lib_floor_ms,
          "library_device_ms": device_ms(lib_floor), "over_library": floor_ms / lib_floor_ms})
    for name, route in scatter_routes.items():
        rows[name]["design"] = route
    # device time of bare launches: the wrappers' host time holds these rows
    for name, row in rows.items():
        row["device_ms"] = device_ms(cases[name][0])
        row["device_pct_of_bound"] = 100 * row["bound_ms"] / row["device_ms"]
        row["over_floor_device_ms"] = row["device_ms"] - floor_device_ms
        row["floor_device_ms"] = floor_device_ms
        if name in library:
            row["library_device_ms"] = device_ms(library[name])
            # ms and library_ms are 10 calls each, and these calls are
            # held by their host time, ~0.01 ms: 200 calls in turns
            # resolve the two
            kern, lib = cases[name][0], library[name]
            steady = [cuda_ms(f, 200, 20) for f in (kern, lib, kern, lib)]
            row["steady_ms"], row["library_steady_ms"] = steady[0::2], steady[1::2]
            row["steady_over_library"] = sum(steady[0::2]) / sum(steady[1::2])
        if "smem_floor_ms" in row:
            row["smem_floor_pct"] = 100 * row["smem_floor_ms"] / row["device_ms"]
        if name in design:
            row["design"] = design[name]
            row["over_library"] = row["ms"] / row["library_ms"]
            if design[name] == "ldg":
                row["x_sector_bytes"] = 32 * cases[name][4][1].numel()
        emit({"phase": "I device", **{k: row[k] for k in ("name", "ms", "device_ms", "bound_ms",
                                                           "device_pct_of_bound", "library_ms")},
              "library_device_ms": row.get("library_device_ms"),
              **{k: row[k] for k in ("over_floor_device_ms", "design", "over_library",
                                     "x_sector_bytes", "steady_ms",
                                     "library_steady_ms", "steady_over_library", "smem_floor_ms",
                                     "smem_floor_random_ms", "smem_floor_pct") if k in row}})
    axis0 = ("tools/probe_primitives.py:188 k_tala0, tools/probe_inflate_prims.py:50 k_a, "
             "tools/probe_inflate_prims2.py:115 k_i (table_lookup)")
    rows["take_along_axis1"]["also_replaces"] = "tools/probe_primitives.py:167 k_tala"
    rows["take_along_axis1_wide"]["also_replaces"] = "tools/probe_primitives.py:167 k_tala"
    rows["take_along_axis0"]["also_replaces"] = axis0
    rows["take_along_axis0_batch8"]["also_replaces"] = axis0
    for name, kernel in kernel_of.items():
        rows[name]["kernel"] = kernel
    for name, route in while_route.items():  # each row's launches: its route's
        rows[name].update(kernel="vec_cond_while", design=route, steps=while_steps[name])
    # the shift screen's 18.9 MB fit the 50 MB L2: its device time again
    # with the L2 evicted before each launch
    for name, route in shift_routes.items():
        rows[name]["design"] = route
        rows[name]["flushed_device_ms"] = flushed_ms(cases[name][0])
        rows[name]["flushed_pct_of_bound"] = 100 * rows[name]["bound_ms"] / rows[name][
            "flushed_device_ms"]
        emit({"phase": "I shift", **{k: rows[name][k] for k in (
            "name", "design", "ms", "device_ms", "flushed_device_ms", "bound_ms",
            "device_pct_of_bound", "flushed_pct_of_bound")}})
    # the host µs of each piece of a call, the earlier path beside this one's
    rows_us = launch_breakdown.breakdown()
    emit({"phase": "I launch probe", "nvidia_smi": smi, **launch_breakdown.summary(rows_us),
          "us": {k: round(v["us"], 3) for k, v in rows_us.items()},
          "us_range": {k: [round(v["us_min"], 3), round(v["us_max"], 3)]
                       for k, v in rows_us.items()}})

    _build.reset_launches()
    for counts in (gp.LOOP_ROUTES, gp.SHIFT_ROUTES, gp.SCATTER_ROUTES):
        for d in counts:
            counts[d] = 0
    for probe in (probe_gather, probe_primitives, probe_inflate_prims, probe_inflate_prims2):
        probe.main([])
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES[kernel_of.get(k, k)] for k in rows}
    for kernel, counts in (("take_along_loop", gp.LOOP_ROUTES), ("shift_screen", gp.SHIFT_ROUTES),
                           ("scatter_max", gp.SCATTER_ROUTES)):
        if sum(counts.values()) != _build.LAUNCHES[kernel]:
            raise SystemExit("phase I: %s's launches by design %s do not add up to %d"
                             % (kernel, counts, _build.LAUNCHES[kernel]))
    for name, d in loop_designs.items():  # a loop row's launches: its design's
        launches[name] = gp.LOOP_ROUTES[d]
    for name, d in shift_routes.items():  # a shift row's launches: its route's
        launches[name] = gp.SHIFT_ROUTES[d]
    for name, d in scatter_routes.items():  # a scatter row's launches: its route's
        launches[name] = gp.SCATTER_ROUTES[d]
        rows[name]["launches_by_route"] = dict(gp.SCATTER_ROUTES)
    return rows, launches


def phase_j(corpus, z6: bytes, gzip32: np.ndarray) -> bytes:
    """The host engine at full size: a stream past the device decode's
    2^29 bits through inflate()'s counted fallback (J1), the streaming
    Inflater (J2), the verdicts of corrupt 32 MiB streams, each from the
    device route first (J3), and preset dictionaries (J4).  Returns J1's
    stream, which phase L decodes again."""
    import tpuzlib_torch
    from tpuzlib_torch.api import inflate_api
    from tpuzlib_torch.codec.engine import RawInflateEngine
    from tpuzlib_torch.kernels import _build
    from tpuzlib_torch.kernels import inflate_device2 as d2
    from tpuzlib_torch.testing import counters_since
    from tpuzlib_torch.utils import trace

    def counted(fn):
        """fn()'s result (or its ValueError's message), the counters it
        moved, the decode's launches and its host seconds."""
        before = trace.get_counters()
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            out = fn()
        except ValueError as e:
            out = str(e)
        dt = time.perf_counter() - t0
        return out, counters_since(before), _build.LAUNCHES["inflate_decode"], dt

    bad = []
    # J1: seven copies of the corpus at level 1: 224 MiB, a stream of more
    # than 2^29 bits, which the device route declines before any upload
    big = np.tile(corpus, 7)
    t0 = time.perf_counter()
    wire1 = zlib.compress(big.tobytes(), 1)
    zlib_s = time.perf_counter() - t0
    if len(wire1) * 8 < 1 << 29:
        raise SystemExit("phase J1: the stream has %d bits, fewer than 2^29" % (len(wire1) * 8))
    out, moved, decodes, dt = counted(lambda: tpuzlib_torch.inflate(wire1, device=DEVICE))
    # the host route: the speculative decode where the dispatch applies
    # (phase L times it beside the Inflater), else the Inflater
    want = {"inflate.device_fallback": 1}
    if inflate_api.speculative_applies(len(wire1)):
        want["inflate.speculative"] = len(big)
    ok = (not isinstance(out, str) and out.tobytes() == big.tobytes()
          and moved == want and decodes == 0)
    emit({"phase": "J1", "bytes_in": len(wire1), "bits": len(wire1) * 8, "bytes_out": len(big),
          "equal": ok, "counts": moved, "decode_launches": decodes, "zlib_compress_s": zlib_s,
          "inflate_s": dt, "host_MBps": len(big) / dt / 1e6})
    bad += [] if ok else ["J1"]
    del big, out

    # J2: the streaming Inflater over G's zlib stream in 64 KiB appends and
    # over C's gzip in ragged ones
    sizes = (1, 7, 4 << 10, 1 << 20)
    for name, wire, steps, gzip_ in (("zlib L6, 64 KiB appends", z6, [64 << 10], False),
                                     ("gzip (port's deflate), ragged appends",
                                      gzip32.tobytes(), sizes, True)):
        inf = tpuzlib_torch.Inflater()
        t0 = time.perf_counter()
        parts, off, k = [], 0, 0
        while off < len(wire):
            step = steps[k % len(steps)]
            parts += inf.append(wire[off : off + step])
            off, k = off + step, k + 1
        res = inf.finish()
        dt = time.perf_counter() - t0
        out = np.concatenate(parts) if parts else np.empty(0, np.uint8)
        ok = (out.tobytes() == corpus.tobytes() and res.success and res.checksum == "match"
              and res.fileSize == ("match" if gzip_ else "unchecked")
              and (inf.total_in, inf.total_out) == (len(wire), len(corpus)))
        emit({"phase": "J2", "run": name, "appends": k, "bytes_in": len(wire),
              "bytes_out": len(out), "equal": ok, "success": res.success,
              "checksum": res.checksum, "fileSize": res.fileSize, "total_in": inf.total_in,
              "total_out": inf.total_out, "s": dt, "MBps": len(corpus) / dt / 1e6})
        bad += [] if ok else ["J2 " + name]

    # J3: verdicts of corrupt 32 MiB streams, from the device route first
    flip = lambda w, i: w[:i] + bytes([w[i] ^ 1]) + w[i + 1 :]  # noqa: E731
    gz = gzip32.tobytes()
    for name, wire, verdict, counter in (
            ("zlib cut short", z6[: len(z6) // 2], "Unexpected EOF during decompression",
             "inflate.device_fallback"),
            ("gzip cut short", gz[: len(gz) - 100], "Unexpected EOF during decompression",
             "inflate.device_fallback"),
            ("zlib Adler-32 flipped", flip(z6, len(z6) - 1), "Data integrity check failed",
             "inflate.device_mismatch_fallback"),
            ("gzip CRC-32 flipped", flip(gz, len(gz) - 5), "Data integrity check failed",
             "inflate.device_mismatch_fallback"),
            ("gzip ISIZE flipped", flip(gz, len(gz) - 1), "Data size check failed",
             "inflate.device_mismatch_fallback")):
        out, moved, decodes, dt = counted(lambda: tpuzlib_torch.inflate(wire, device=DEVICE))
        fallbacks = {k: moved.get(k, 0) for k in ("inflate.device_fallback",
                                                  "inflate.device_mismatch_fallback")}
        ok = out == verdict and fallbacks == {k: int(k == counter) for k in fallbacks}
        emit({"phase": "J3", "run": name, "bytes_in": len(wire), "verdict": out, "want": verdict,
              "counts": moved, "decode_launches": decodes, "s": dt, "ok": ok})
        bad += [] if ok else ["J3 " + name]

    # J4: preset dictionaries: the first 32 KiB of the corpus before 8 MiB
    zdict, data = corpus[: 32 << 10].tobytes(), corpus[: 8 << 20]
    c = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=zdict)
    fdict = c.compress(data.tobytes()) + c.flush()
    c = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=zdict)
    raw = np.frombuffer(c.compress(data.tobytes()) + c.flush(), np.uint8)

    def inflater(wire, dictionary):
        inf = tpuzlib_torch.Inflater(dictionary=dictionary)
        parts = [b for i in range(0, len(wire), 1 << 20) for b in inf.append(wire[i : i + (1 << 20)])]
        return np.concatenate(parts) if inf.finish().success else None

    runs = [
        ("inflate(dictionary=)", lambda: tpuzlib_torch.inflate(fdict, zdict, device=DEVICE), None),
        ("Inflater(dictionary=)", lambda: inflater(fdict, zdict), None),
        ("no dictionary", lambda: tpuzlib_torch.inflate(fdict, device=DEVICE),
         "Custom dictionary required for this data"),
        ("wrong dictionary", lambda: tpuzlib_torch.inflate(fdict, zdict[1:], device=DEVICE),
         "Custom dictionary is not valid for this data"),
        ("raw, host engine", lambda: RawInflateEngine(np.frombuffer(zdict, np.uint8)).push(raw),
         None),
        ("raw, device decode", lambda: d2.decode(raw, np.frombuffer(zdict, np.uint8),
                                                 device=DEVICE), None),
    ]
    for name, fn, verdict in runs:
        out, moved, decodes, dt = counted(fn)
        ok = (out == verdict if verdict else
              not isinstance(out, str) and out is not None and out.tobytes() == data.tobytes())
        emit({"phase": "J4", "run": name, "ok": ok, "verdict": out if isinstance(out, str) else None,
              "counts": moved, "decode_launches": decodes, "s": dt})
        bad += [] if ok else ["J4 " + name]
    if bad:
        raise SystemExit("phase J: %s" % ", ".join(bad))
    return wire1


def phase_k(corpus, smi: str) -> None:
    """The host deflate engine at full size: the Deflater beside the
    device route's deflate() (K1), its streams through inflate()'s device
    route (K2), ragged appends and a preset dictionary (K3), and the gzip
    members with their verify on the card (K4)."""
    import tpuzlib_torch
    from tpuzlib_torch.codec import deflate_engine
    from tpuzlib_torch.kernels import _build
    from tpuzlib_torch.parallel import members
    from tpuzlib_torch.testing import counters_since
    from tpuzlib_torch.utils import trace

    def deflater(data, steps=None, **options) -> bytes:
        """The Deflater's stream of `data`, appended in `steps` in turn
        (one append without)."""
        d = tpuzlib_torch.Deflater(**options)
        parts, off, k = [], 0, 0
        steps = steps or [len(data)]
        while off < len(data):
            step = steps[k % len(steps)]
            parts += d.append(data[off : off + step])
            off, k = off + step, k + 1
        return np.concatenate(parts + d.finish()).tobytes()

    def on_card(wire, want, dictionary=None):
        """inflate() on the card: equal bytes, the counters it moved and
        the decode's launches."""
        before = trace.get_counters()
        launches = _build.LAUNCHES["inflate_decode"]
        t0 = time.perf_counter()
        out = tpuzlib_torch.inflate(wire, dictionary, device=DEVICE)
        dt = time.perf_counter() - t0
        return (out.tobytes() == want, counters_since(before),
                _build.LAUNCHES["inflate_decode"] - launches, dt)

    bad = []
    data = corpus.tobytes()
    # K1: the Deflater (host engine, zlib container) and the device route's
    # deflate() on the same 32 MiB, warm, in one run
    host6 = None
    for level in (1, 6, 9):
        wire, host_s, host_runs = warm_s(lambda: deflater(corpus, level=level))
        dev_out, dev_s, dev_runs = warm_s(lambda: tpuzlib_torch.deflate(corpus, level=level,
                                                                      device=DEVICE).tobytes())
        zlen = len(zlib.compress(data, level))
        ok = zlib.decompress(wire) == data and zlib.decompress(dev_out) == data
        emit({"phase": "K1", "card": smi, "level": level, "bytes_in": len(data),
              "ncores": deflate_engine._ncores(), "host_bytes_out": len(wire),
              "host_ratio_to_zlib": len(wire) / zlen, "host_warm_s": host_runs,
              "host_MBps": len(data) / host_s / 1e6, "device_bytes_out": len(dev_out),
              "device_ratio_to_zlib": len(dev_out) / zlen, "device_warm_s": dev_runs,
              "device_MBps": len(data) / dev_s / 1e6, "zlib_bytes_out": zlen, "roundtrip": ok})
        bad += [] if ok else ["K1 level %d" % level]
        host6 = wire if level == 6 else host6

    # K2: the Deflater's zlib (K1's level 6) and gzip streams through
    # inflate()'s device route: every byte from the device, no fallback
    gz6 = deflater(corpus, level=6, format="gzip", fileName="mixed.bin")
    for name, wire in (("zlib L6", host6), ("gzip L6", gz6)):
        ok, moved, decodes, dt = on_card(wire, data)
        ok = (ok and moved.get("inflate.device") == len(data) and decodes > 0
              and not any(moved.get(k) for k in ("inflate.device_fallback",
                                                 "inflate.device_mismatch_fallback")))
        emit({"phase": "K2", "run": name, "bytes_in": len(wire), "bytes_out": len(data),
              "equal_and_device_route": ok, "counts": moved, "decode_launches": decodes,
              "s": dt, "MBps": len(data) / dt / 1e6})
        bad += [] if ok else ["K2 " + name]

    # K3: ragged appends over 8 MiB, and 8 MiB after a 32 KiB preset
    # dictionary through deflate(dictionary=)
    zdict, part = corpus[: 32 << 10].tobytes(), corpus[: 8 << 20]
    t0 = time.perf_counter()
    ragged = deflater(part, [1, 7, 4 << 10, 1 << 20], level=6)
    ragged_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fdict = tpuzlib_torch.deflate(part, level=6, dictionary=zdict, device=DEVICE).tobytes()
    fdict_s = time.perf_counter() - t0
    for name, wire, dictionary, s_ in (("ragged appends", ragged, None, ragged_s),
                                       ("deflate(dictionary=)", fdict, zdict, fdict_s)):
        do = zlib.decompressobj(zdict=dictionary) if dictionary else zlib.decompressobj()
        zok = do.decompress(wire) == part.tobytes() and do.eof
        ok, moved, decodes, dt = on_card(wire, part.tobytes(), dictionary)
        # an FDICT stream is the host engine's, the other the device route's
        ok = ok and zok and not any(moved.get(k) for k in ("inflate.device_fallback",
                                                             "inflate.device_mismatch_fallback"))
        ok = ok and moved.get("inflate.device", 0) == (0 if dictionary else len(part))
        emit({"phase": "K3", "run": name, "bytes_in": len(part), "bytes_out": len(wire),
              "deflate_s": s_, "zlib_decodes": zok, "inflate_ok": ok, "counts": moved,
              "decode_launches": decodes, "inflate_s": dt})
        bad += [] if ok else ["K3 " + name]

    # K4: gzip members of 4 MiB, decompressed with the index, verified on
    # the card by one crc32_scalar launch
    t0 = time.perf_counter()
    wire, index = members.compress_members(corpus, level=6, member_size=4 << 20)
    comp_s = time.perf_counter() - t0
    scalar = _build.LAUNCHES["crc32_scalar"]
    t0 = time.perf_counter()
    out, crc = members.decompress_members(wire, index, verify=True, device=DEVICE)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    launched = _build.LAUNCHES["crc32_scalar"] - scalar
    ok = out.tobytes() == data and crc == zlib.crc32(data) and launched == 1
    emit({"phase": "K4", "members": len(index), "bytes_in": len(data), "bytes_out": len(wire),
          "compress_s": comp_s, "compress_MBps": len(data) / comp_s / 1e6,
          "decompress_s": dec_s, "decompress_MBps": len(data) / dec_s / 1e6,
          "crc32_scalar_launches": launched, "ok": ok})
    bad += [] if ok else ["K4"]
    if bad:
        raise SystemExit("phase K: %s" % ", ".join(bad))


def warm_s(fn, reps: int = 3, warmup: bool = True):
    """fn()'s result, the median host seconds of `reps` calls after one
    warm-up (none where the caller warmed up already), and every call's
    seconds (each call ends in a synchronize)."""
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times)), times


def phase_l(corpus, wire1: bytes, z6: bytes, gzip32: np.ndarray, smi: str) -> None:
    """The speculative host inflate: J1's 224 MiB stream through inflate()
    (declined by the device route at its plan, then the speculative decode
    of the host route, its trailer checked by one adler32_scalar launch)
    beside the sequential Inflater on the same stream, warm; then
    inflate_parallel_container on G's zlib and C's gzip stream, and a
    flipped trailer's verdict."""
    import tpuzlib_torch
    from tpuzlib_torch.api import inflate_api
    from tpuzlib_torch.kernels import _build
    from tpuzlib_torch.parallel.speculative import inflate_parallel_container
    from tpuzlib_torch.testing import counters_since
    from tpuzlib_torch.utils import trace

    bad = []
    big = np.tile(corpus, 7).tobytes()
    cores = inflate_api._ncores()
    if not inflate_api.speculative_applies(len(wire1)):
        raise SystemExit("phase L: the host has %d cores; the speculative dispatch needs %d"
                         % (cores, inflate_api.SPECULATIVE_MIN_CORES))

    def routed():
        """inflate() of the stream, with the counters it moved and the
        launches it made."""
        before = trace.get_counters()
        _build.reset_launches()
        out = tpuzlib_torch.inflate(wire1, device=DEVICE)
        torch.cuda.synchronize()
        return out, counters_since(before), {k: v for k, v in _build.LAUNCHES.items() if v}

    def sequential():
        inf = tpuzlib_torch.Inflater()
        parts = inf.append(wire1)
        return np.concatenate(parts) if inf.finish().success else None

    (out, moved, launched), spec_s, spec_runs = warm_s(routed)
    ok = (out.tobytes() == big
          and moved == {"inflate.device_fallback": 1, "inflate.speculative": len(big)}
          and launched == {"adler32_scalar": 1})
    del out
    seq, seq_s, seq_runs = warm_s(sequential)
    ok = ok and seq is not None and seq.tobytes() == big
    del seq
    emit({"phase": "L1", "card": smi, "bytes_in": len(wire1), "bytes_out": len(big),
          "cores": cores, "counts": moved, "launches": launched, "equal": ok,
          "speculative_s": spec_s, "speculative_runs_s": spec_runs,
          "speculative_MBps": len(big) / spec_s / 1e6, "inflater_s": seq_s,
          "inflater_runs_s": seq_runs, "inflater_MBps": len(big) / seq_s / 1e6,
          "speedup": seq_s / spec_s})
    bad += [] if ok else ["L1"]
    del big

    want = corpus.tobytes()
    flip = lambda w, i: w[:i] + bytes([w[i] ^ 1]) + w[i + 1 :]  # noqa: E731
    gz = gzip32.tobytes()
    for name, wire, verdict, scalar in (
            ("zlib L6", z6, None, "adler32_scalar"), ("gzip (port's deflate)", gz, None,
                                                      "crc32_scalar"),
            ("zlib Adler-32 flipped", flip(z6, len(z6) - 1), "Data integrity check failed",
             "adler32_scalar"),
            ("gzip CRC-32 flipped", flip(gz, len(gz) - 5), "Data integrity check failed",
             "crc32_scalar")):
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            got = inflate_parallel_container(wire, device=DEVICE)
        except ValueError as e:
            got = str(e)
        dt = time.perf_counter() - t0
        launches = _build.LAUNCHES[scalar]
        ok = (got == verdict if verdict else
              not isinstance(got, str) and got.tobytes() == want)
        ok = ok and launches == 1
        emit({"phase": "L2", "run": name, "bytes_in": len(wire), "verdict": got if verdict else None,
              "equal": ok, scalar + "_launches": launches, "s": dt})
        bad += [] if ok else ["L2 " + name]
    if bad:
        raise SystemExit("phase L: %s" % ", ".join(bad))


MESH_KERNELS = ("near_screen", "far_screen", "segment_parse", "pack_words", "crc32_scalar",
                "adler32_scalar", "inflate_lut", "inflate_decode")


def phase_m(corpus, raw6: np.ndarray, smi: str) -> None:
    """The mesh on one card: a world-size-1 NCCL group (a free localhost
    port, destroyed at the end), dryrun_multichip(1) at its 256 KiB shard,
    sharded_deflate of 8 MiB of the corpus at levels 1 and 6 in one shard
    (zlib decodes it; its Adler-32 and CRC-32 are zlib's; warm MB/s and the
    step's ok flags), and sharded_inflate of G's raw level-6 stream on the
    mesh (the input's bytes, no fallback).  The launches of the encoder's
    four kernels, the checksum scalars and the decode's two kernels are
    counted over the phase, every one required."""
    import socket

    import torch.distributed as dist

    from tpuzlib_torch.entry import dryrun_multichip
    from tpuzlib_torch.kernels import _build
    from tpuzlib_torch.parallel import make_mesh, sharded_deflate, sharded_inflate
    from tpuzlib_torch.parallel.pipeline import deflate_shards

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:%d" % port, rank=0,
                            world_size=1)
    try:
        bad = []
        mesh = make_mesh(1, "cuda")
        _build.reset_launches()
        t0 = time.perf_counter()
        dryrun_multichip(1)
        torch.cuda.synchronize()
        emit({"phase": "M dryrun", "card": smi, "shard_len": 1 << 18, "ok": True,
              "s": time.perf_counter() - t0})

        data = corpus[: 8 << 20]
        for level in (1, 6):
            # the warm-up is deflate_shards, sharded_deflate's step and join
            # without the zlib container, for the step's ok flags; the
            # timed calls are sharded_deflate's, on the same built step
            ok_flags = deflate_shards(data, mesh, level)[3].tolist()
            (wire, adler, crc), sec, runs = warm_s(lambda: sharded_deflate(data, mesh, level),
                                                   warmup=False)
            # an ok flag of 0 (a cap overflowed: stored blocks) is printed,
            # not required: it is the data's, as in tpuzlib's step
            ok = (zlib.decompress(wire.tobytes()) == data.tobytes()
                  and (adler, crc) == (zlib.adler32(data.tobytes()), zlib.crc32(data.tobytes())))
            emit({"phase": "M deflate", "card": smi, "level": level, "bytes_in": len(data),
                  "bytes_out": len(wire), "ratio_to_zlib": len(wire) / len(zlib.compress(
                      data.tobytes(), level)), "ok_flags": ok_flags, "checksums_equal": ok,
                  "s": sec, "runs_s": runs, "MBps": len(data) / sec / 1e6})
            bad += [] if ok else ["M deflate level %d" % level]

        t0 = time.perf_counter()
        out = sharded_inflate(raw6, mesh)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ok = out is not None and out.tobytes() == corpus.tobytes()
        emit({"phase": "M inflate", "card": smi, "bytes_in": len(raw6), "fell_back": out is None,
              "equal": ok, "s": dt, "MBps": len(corpus) / dt / 1e6})
        bad += [] if ok else ["M inflate"]
        torch.cuda.synchronize()
        launched = {k: _build.LAUNCHES[k] for k in MESH_KERNELS}
        emit({"phase": "M launches", **launched})
        bad += ["M launched no %s" % k for k, v in launched.items() if not v]
    finally:
        dist.destroy_process_group()
    if bad:
        raise SystemExit("phase M: %s" % ", ".join(bad))


def _op_name(name: str) -> str:
    """A device operation's name up to its argument list, without its
    namespaces, at most 120 characters (template arguments kept); a copy
    or a memset by its whole name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    for ns in ("void ", "(anonymous namespace)::", "at::native::", "at_cuda_detail::",
               "cub::", "std::"):
        name = name.replace(ns, "")
    depth = 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name.strip()[:120]


def trace_split(logdir: str, window: str) -> dict:
    """The split of the call under the record_function span `window` in
    logdir's Chrome trace (ts and dur in µs): its wall ms; the card's busy
    ms, the union of its kernel, copy and memset intervals inside the
    window, and idle share; the 8 device operations of most time; each
    stage span's host ms; the idle ms under each innermost stage span; and
    the 8 longest idle gaps, each with the innermost stage span open on
    the host at its middle."""
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    (win,) = [e for e in spans if e["name"] == window]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    stages = [e for e in spans if e is not win and w0 <= e["ts"] <= w1]
    ops = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = []
    for a, b in sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in ops):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def open_at(t):
        inner = [e for e in stages if e["ts"] <= t <= e["ts"] + e["dur"]]
        return max(inner, key=lambda e: e["ts"])["name"] if inner else "(no stage)"

    busy_us = sum(b - a for a, b in busy)
    by_op, n_op = collections.Counter(), collections.Counter()
    for e in ops:
        by_op[_op_name(e["name"])] += e["dur"]
        n_op[_op_name(e["name"])] += 1
    stage_ms, idle_ms = collections.Counter(), collections.Counter()
    for e in stages:
        stage_ms[e["name"]] += e["dur"] / 1e3
    for a, b in gaps:
        idle_ms[open_at((a + b) / 2)] += (b - a) / 1e3
    return {
        "wall_ms": (w1 - w0) / 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": 1 - busy_us / (w1 - w0), "device_ops": len(ops),
        "top_ops": [{"op": k, "ms": v / 1e3, "count": n_op[k]} for k, v in by_op.most_common(8)],
        "stage_ms": dict(stage_ms.most_common()), "idle_ms_by_stage": dict(idle_ms.most_common()),
        "longest_gaps": [{"ms": (b - a) / 1e3, "at_ms": (a - w0) / 1e3, "stage": open_at((a + b) / 2)}
                         for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:8]],
    }


def phase_n(corpus, z6: bytes, smi: str) -> None:
    """The main paths profiled through utils/trace.py: the telemetry's cost
    (N1), the split of a warm deflate() and inflate() from a
    trace.profile() capture with the counters gated (N2), and one encoder
    batch under set_sync_debug_mode("error") with the telemetry on (N3)."""
    import tpuzlib_torch
    from tpuzlib_torch.kernels import deflate_device3 as d3
    from tpuzlib_torch.utils import trace

    bad = []
    data = corpus.tobytes()

    def deflate():
        return tpuzlib_torch.deflate(corpus, level=LEVEL, device=DEVICE)

    # N1: telemetry off and on, in turns, after a warm-up of each; the
    # stages' host ms a call, from the telemetry of the calls with it on
    trace.reset()
    secs, reps = {False: [], True: []}, 8
    for rep in range(reps):
        for on in (False, True):
            trace.enable(on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            deflate()
            torch.cuda.synchronize()
            if rep:
                secs[on].append(time.perf_counter() - t0)
    trace.enable(False)
    mbps = {on: len(data) / float(np.median(v)) / 1e6 for on, v in secs.items()}
    emit({"phase": "N1", "card": smi, "bytes_in": len(data), "level": LEVEL,
          "off_MBps": mbps[False], "on_MBps": mbps[True], "on_over_off": mbps[True] / mbps[False],
          "off_s": secs[False], "on_s": secs[True],
          "stage_ms_per_call": {k: v["seconds"] * 1e3 / reps
                                for k, v in trace.get_telemetry().items()}})

    # N2: one warm call of each main path inside trace.profile()
    trace.reset()
    trace.reset_counters()
    tmp = tempfile.mkdtemp(prefix="tpuzlib_torch_profile_")
    try:
        for name, fn in (("deflate", deflate),
                         ("inflate", lambda: tpuzlib_torch.inflate(z6, device=DEVICE))):
            logdir = os.path.join(tmp, name)
            torch.cuda.synchronize()
            with trace.profile(logdir, device=DEVICE):
                with torch.profiler.record_function("smoke." + name):
                    out = fn()
                    torch.cuda.synchronize()
            ok = (zlib.decompress(out.tobytes()) if name == "deflate" else out.tobytes()) == data
            emit({"phase": "N2", "call": name, "card": smi, "equal": ok,
                  **trace_split(logdir, "smoke." + name)})
            bad += [] if ok else ["N2 %s output" % name]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counters = trace.get_counters()
    emit({"phase": "N2 telemetry", "stages": trace.get_telemetry(), "counters": counters})
    want = {"deflate.device": len(data), "inflate.device": len(data)}
    got = {k: counters.get(k, 0) for k in want}
    fallbacks = {k: v for k, v in counters.items() if "fallback" in k and v}
    if got != want or fallbacks:
        bad.append("N2 counters %s, fallbacks %s; want %s and none" % (got, fallbacks, want))

    # N3: one encoder batch, telemetry on, under set_sync_debug_mode("error")
    enc = d3.make_encode_batch_v3(LEVEL, CHUNK, BATCH, d3.out_words_for(CHUNK))
    args = first_batch(corpus, DEVICE)
    want = [t.cpu() for t in enc(*args)]  # telemetry off, and a warm-up
    trace.enable(True)
    try:
        enc(*args)
        torch.cuda.synchronize()
        trace.reset_counters()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = enc(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        overflow = trace.get_counters().get("deflate.ext_cap_overflow")
    finally:
        trace.enable(False)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    emit({"phase": "N3", "sync_debug_mode": "error", "passed": True, "same_as_off": same,
          "ext_cap_overflow": overflow})
    bad += [] if same and overflow is not None else ["N3"]
    if bad:
        raise SystemExit("phase N: %s" % ", ".join(bad))


def phase_o(corpus, smi: str) -> dict:
    """The host codec with its native library switched off
    (testing.no_native), around the card's kernels: the numpy Deflater
    at levels 1, 6 and 9 (O1), deflate() on the card (O2), inflate() of
    zlib's stream on the card (O3), and the numpy checksums (O4), on 8 MiB
    of the corpus.  Returns the launches of O2 and O3, each counted from
    0 just before its call."""
    import tpuzlib_torch
    from tpuzlib_torch import testing
    from tpuzlib_torch.codec import deflate_engine
    from tpuzlib_torch.kernels import _build
    from tpuzlib_torch.kernels.adler32 import adler32_host
    from tpuzlib_torch.kernels.crc32 import crc32_host
    from tpuzlib_torch.native import bindings
    from tpuzlib_torch.utils import trace

    data = corpus[: 8 << 20]
    raw = data.tobytes()
    ncores = deflate_engine._ncores()
    bad, launches = [], collections.Counter()
    with testing.no_native():
        try:
            bindings.lib()
            bad.append("the native library answers while switched off")
        except RuntimeError:
            pass
        # O1: the Deflater (zlib container, one append) on the numpy route
        for level in (1, 6, 9):
            t0 = time.perf_counter()
            d = tpuzlib_torch.Deflater(level=level)
            wire = np.concatenate(d.append(data) + d.finish()).tobytes()
            dt = time.perf_counter() - t0
            zlen = len(zlib.compress(raw, level))
            ok = zlib.decompress(wire) == raw
            emit({"phase": "O1", "card": smi, "ncores": ncores, "level": level,
                  "bytes_in": len(raw), "bytes_out": len(wire), "zlib_bytes_out": zlen,
                  "ratio_to_zlib": len(wire) / zlen, "s": dt, "MBps": len(raw) / dt / 1e6,
                  "zlib_decodes": ok})
            bad += [] if ok else ["O1 level %d" % level]

        # O2: deflate() on the card: the encoder's kernels and the trailer's
        # Adler-32 in one adler32_scalar launch
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        wire = tpuzlib_torch.deflate(data, device=DEVICE).tobytes()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        o2 = {k: v for k, v in _build.LAUNCHES.items() if v}
        launches.update(o2)
        enc = ("near_screen", "far_screen", "segment_parse", "pack_words")
        ok = (zlib.decompress(wire) == raw and all(o2.get(k, 0) > 0 for k in enc)
              and o2.get("adler32_scalar", 0) + o2.get("crc32_scalar", 0) == 1)
        emit({"phase": "O2", "card": smi, "ncores": ncores, "bytes_in": len(raw),
              "bytes_out": len(wire), "s": dt, "MBps": len(raw) / dt / 1e6, "launches": o2,
              "ok": ok})
        bad += [] if ok else ["O2"]

        # O3: inflate() on the card of zlib's level-6 stream: the decode's
        # two kernels, the numpy header scan and expansion around them
        z = zlib.compress(raw, 6)
        torch.cuda.synchronize()
        _build.reset_launches()
        before = trace.get_counters()
        was = trace.telemetry_enabled()
        trace.enable()
        trace.reset()
        t0 = time.perf_counter()
        try:
            out = tpuzlib_torch.inflate(z, device=DEVICE)
            torch.cuda.synchronize()
        finally:
            dt = time.perf_counter() - t0
            stages = {k: v["seconds"] for k, v in trace.get_telemetry().items()}
            trace.enable(was)
            trace.reset()
        moved = testing.counters_since(before)
        o3 = {k: v for k, v in _build.LAUNCHES.items() if v}
        launches.update(o3)
        fallbacks = {k: moved.get(k, 0) for k in ("inflate.device_fallback",
                                                  "inflate.device_mismatch_fallback")}
        # the device route gave every byte (a splice repair bridges with
        # the vectorized decoder): no fallback to the host route
        routed = moved.get("inflate.device", 0) == len(raw) and not any(fallbacks.values())
        ok = (out.tobytes() == raw and o3.get("inflate_decode", 0) > 0
              and o3.get("header_filter", 0) > 0 and routed)
        emit({"phase": "O3", "card": smi, "ncores": ncores, "bytes_in": len(z),
              "bytes_out": len(raw), "s": dt, "MBps": len(raw) / dt / 1e6, "counts": moved,
              "fallbacks": fallbacks, "launches": o3, "stage_s": stages, "ok": ok})
        bad += [] if ok else ["O3"]

        # O4: the numpy checksums of the host engine
        for name, fn, want in (("crc32_host", crc32_host, zlib.crc32(raw)),
                               ("adler32_host", adler32_host, zlib.adler32(raw))):
            t0 = time.perf_counter()
            got = fn(data)
            dt = time.perf_counter() - t0
            emit({"phase": "O4", "card": smi, "ncores": ncores, "run": name,
                  "bytes_in": len(raw), "s": dt, "MBps": len(raw) / dt / 1e6,
                  "equal_to_zlib": got == want})
            bad += [] if got == want else ["O4 " + name]
    if not bindings.native_available():
        bad.append("the native library stays off after the phase")
    if bad:
        raise SystemExit("phase O: %s" % ", ".join(bad))
    return dict(launches)


def phase_p() -> tuple:
    """inflate_members() of a 32 MiB BGZF slice on the card, and the
    segmented CRC-32 kernel against its plain version on its members.
    Returns the kernel's row and the launches of the one timed call."""
    import tpuzlib_torch
    from tpuzlib_torch import testing
    from tpuzlib_torch.api.inflate_api import member_index
    from tpuzlib_torch.kernels import _build
    from tpuzlib_torch.kernels import crc32_segments as cs
    from tpuzlib_torch.utils import trace

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zbench.entries import bgzf
    from zbench.reference import bgzf_ref

    config = {"level": 6, "window_bits": 15, "mem_level": 8, "member_input_bytes": 65280}
    data = bgzf.records(32 << 20, [3000000041, 0])
    wire = np.frombuffer(b"".join(bgzf_ref.member(p, config) for p in bgzf_ref.pieces(data, config))
                         + bgzf_ref.EOF_MEMBER, np.uint8)
    members = member_index(wire)
    tpuzlib_torch.inflate_members(wire)  # warm
    _build.reset_launches()
    before = trace.get_counters()
    trace.enable(True)
    trace.reset()
    t0 = time.perf_counter()
    out = tpuzlib_torch.inflate_members(wire)
    s = time.perf_counter() - t0
    trace.enable(False)
    moved = testing.counters_since(before)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    equal = bytes(out) == bgzf_ref.read(wire)
    emit({"phase": "P", "members": len(members), "compressed_bytes": len(wire),
          "out_bytes": len(out), "equal": equal, "s": s, "MBps": len(out) / s / 1e6,
          "members_card": moved.get("inflate.members_card", 0),
          "launches": launches,
          "stage_s": {k: v["seconds"] for k, v in trace.get_telemetry().items()}})
    if not equal or moved.get("inflate.members_card") != len(members):
        raise SystemExit("phase P: inflate_members differs or left members to the host")
    if launches.get("inflate_decode") != 1 or launches.get("crc32_segments") != 1:
        raise SystemExit("phase P: launches %s, not one decode and one check" % launches)
    dev = torch.from_numpy(out).to(DEVICE)
    bounds = np.concatenate([[0], np.cumsum([m.isize for m in members])])
    rows = check_kernels({
        # a byte folded an operation
        "crc32_segments": (lambda: cs.crc32_segments(dev, bounds),
                           lambda: cs.crc32_segments_plain(dev, bounds),
                           "tpuzlib_torch/kernels/csrc/crc32_segments.cu", "none (the port's own)",
                           lambda got: len(out) + 4 * (len(bounds) - 1), len(out), 2),
    }, phase="P")
    rows["crc32_segments"]["device_ms"] = device_ms(lambda: cs.crc32_segments(dev, bounds))

    def kernel_ms(fn):
        """crc32_segments_kernel's mean device ms over fn's launches, from
        the profiler's device events."""
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernel = [e for e in prof.key_averages() if "crc32_segments_kernel" in e.key]
        total = (getattr(kernel[0], "device_time_total", None)
                 or getattr(kernel[0], "cuda_time_total", 0)) if kernel else 0
        return total / kernel[0].count / 1e3 if total else None

    # the kernel alone on data the calls above left in L2 (they also copy
    # their bounds to the card)
    rows["crc32_segments"]["kernel_ms"] = warm_ms = kernel_ms(
        lambda: [cs.crc32_segments(dev, bounds) for _ in range(20)])
    # the check's CUDA events (crc32.segments_device_ns) against the
    # kernel's device time in the same inflate_members() call: equal where
    # the events bracket the kernel alone
    before = trace.get_counters()
    trace.enable(True)
    in_call_ms = kernel_ms(lambda: tpuzlib_torch.inflate_members(wire))
    trace.enable(False)
    in_call_events_ms = testing.counters_since(before).get("crc32.segments_device_ns", 0) / 1e6
    events_ms = moved.get("crc32.segments_device_ns", 0) / 1e6
    emit({"phase": "P crc32_segments", "device_ms": rows["crc32_segments"]["device_ms"],
          "kernel_ms": warm_ms, "events_ms": events_ms, "in_call_kernel_ms": in_call_ms,
          "in_call_events_ms": in_call_events_ms,
          "bound_ms": rows["crc32_segments"]["bound_ms"],
          "kernel_pct_of_bound": 100 * rows["crc32_segments"]["bound_ms"] / warm_ms
          if warm_ms else None,
          "in_call_pct_of_bound": 100 * rows["crc32_segments"]["bound_ms"] / in_call_ms
          if in_call_ms else None})
    return rows, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tpuzlib_torch import testing
    from tpuzlib_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    emit({"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    _build.lib()
    emit({"build_s": time.perf_counter() - t0})
    if sys.argv[1:] == ["P"]:
        phase_p()
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    corpus = testing.mixed(32 << 20, seed=1)
    # 256 MiB for the checksums: the corpus eight times (its 32 MiB period
    # is 128 spans, so no two spans of a period are alike)
    big_host = np.tile(corpus, 8)
    big, h2d_ms = timed(lambda: torch.from_numpy(big_host).to(DEVICE))
    emit({"big_bytes": len(big_host), "h2d_ms": h2d_ms})
    args = first_batch(corpus, DEVICE)
    rows = phase_a(args)
    rows.update(phase_a_checksums(big))
    phase_b(args)

    # each kernel's launches are read on the path that runs it: C for the
    # encoder and the trailers' checksums, E for the public crc32 (the
    # scalar, and its block mode below one span)
    _build.reset_launches()
    gzip32 = phase_c(corpus)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    phase_d(corpus)
    _build.reset_launches()
    phase_e(big_host, big)
    phase_e_latency(big_host, big)
    torch.cuda.synchronize()
    for k in ("crc32_forms", "crc32_scalar"):
        launches[k] = _build.LAUNCHES[k]
    phase_f()
    z6 = testing.zlib_stream(corpus, 6)
    raw6 = np.frombuffer(z6, np.uint8)[2:-4]
    rows.update(phase_g1(raw6))
    rows.update(phase_g1_scan(raw6))
    _build.reset_launches()
    payload = phase_g2(corpus, z6, gzip32)
    torch.cuda.synchronize()
    for k in ("inflate_lut", "inflate_decode", "header_filter", "header_parse"):
        launches[k] = _build.LAUNCHES[k]
    for name, raw in payload.items():
        emit({"phase": "G2 census", "stream": name, **flag_census(raw)})
    phase_g3(corpus, raw6)
    rows_h, launches_h = phase_h(big_host, big)
    rows.update(rows_h)
    launches.update(launches_h)
    t0 = time.perf_counter()
    rows_i, launches_i = phase_i(smi)
    emit({"phase": "I", "s": time.perf_counter() - t0})
    rows.update(rows_i)
    launches.update(launches_i)
    t0 = time.perf_counter()
    wire1 = phase_j(corpus, z6, gzip32)
    emit({"phase": "J", "s": time.perf_counter() - t0})
    # after every launch count of the kernels line has been read
    t0 = time.perf_counter()
    phase_k(corpus, smi)
    emit({"phase": "K", "s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    phase_l(corpus, wire1, z6, gzip32, smi)
    emit({"phase": "L", "s": time.perf_counter() - t0})
    del wire1
    t0 = time.perf_counter()
    phase_m(corpus, raw6, smi)
    emit({"phase": "M", "s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    phase_n(corpus, z6, smi)
    emit({"phase": "N", "s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    launches_o = phase_o(corpus, smi)
    emit({"phase": "O", "s": time.perf_counter() - t0})
    rows_p, launches_p = phase_p()
    rows.update(rows_p)
    launches["crc32_segments"] = launches_p.get("crc32_segments", 0)

    kernels = [{**rows[k], "launches": launches[k], "launches_o": launches_o.get(k, 0)}
               for k in rows]
    emit({"kernels": kernels})
    missing = [k for k in rows if launches[k] == 0 and k not in OFF_PATH]
    if missing:
        raise SystemExit("main path launched no %s kernel" % ", ".join(missing))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
