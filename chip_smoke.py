"""Drive tpuzlib_torch's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero at once without
a card, and on any failed check.  It builds the six kernels from
tpuzlib_torch/kernels/csrc, then:

  A  holds each kernel against its plain torch version (exact equality)
     at the main path's shapes: the encoder's four at level 6, 256 KiB
     chunks, batch 8; the checksums' three (CRC-32 per-block forms, CRC-32
     span forms, Adler-32 block sums) on 256 MiB, the size from which
     tpuzlib's checksums take the device;
  B  runs one full-shape make_encode_batch_v3 batch on the card and on
     the CPU (plain versions) and requires equal words, bits and ok;
  C  compresses 32 MiB of mixed corpus at level 6 in the zlib and the gzip
     container, and 8 MiB at levels 1 and 9 (zlib), with
     tpuzlib_torch.deflate and decodes each with python's zlib; the
     launch counts of the encoder's kernels and of the two trailers'
     checksum kernels (adler32, crc32_spans) are taken over C;
  D  streams 16 MiB through DeviceDeflater in uneven appends;
  E  holds tpuzlib_torch.crc32 / adler32 to zlib: 256 MiB as a host array
     and as a card tensor, ragged sizes with seeds, a chain of seven
     pieces and the combines; crc32_forms' launch count (inputs below one
     span) is taken over E;
  F  runs tpuzlib_torch.entry's forward step on the card and on the CPU
     and requires equal outputs.

Each phase prints one JSON line; then the per-kernel table
{"kernels": [...]} and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

LEVEL, CHUNK, BATCH = 6, 1 << 18, 8
DEVICE = "cuda"


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


def max_abs_err(a, b) -> int:
    a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0 for x, y in zip(a, b))


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
    ws = d3.window_words(bufs.reshape(-1))
    lim16, _, mincand, chid = d3.batch_layout(BATCH, CTX, CHUNK, cv, nv)
    cases = {
        "near_screen": (
            lambda: screen.near_screen(*ws, mincand, lim16, p["nd"]),
            lambda: screen.near_screen_plain(*ws, mincand, lim16, p["nd"]),
            "tpuzlib_torch/kernels/csrc/screen.cu",
            "tpuzlib/kernels/screen_pallas.py:142",
        ),
    }
    far = []
    for nbytes, bits in d3.PROBES:
        sh, perm, sws = d3.probe_rows(ws, mincand, chid, nbytes, bits)
        far.append((sh, perm.to(torch.int32), *sws, p["k%d" % nbytes]))
    cases["far_screen"] = (
        lambda: [screen.far_screen(*f) for f in far],
        lambda: [screen.far_screen_plain(*f) for f in far],
        "tpuzlib_torch/kernels/csrc/screen.cu",
        "tpuzlib/kernels/screen_pallas.py:222",
    )
    # a step tape of the parse's shape: mostly literals, some matches, no
    # step crossing a segment
    rng = np.random.default_rng(3)
    n = BATCH * CHUNK
    room = SEG - np.arange(n) % SEG
    step = np.where(rng.random(n) < 0.7, 1, rng.integers(3, 259, n))
    step = torch.from_numpy(np.minimum(step, room).astype(np.int32)).to(bufs.device)
    cases["segment_parse"] = (
        lambda: parse.segment_parse(step, n),
        lambda: segment_parse_xla(step, n),
        "tpuzlib_torch/kernels/csrc/parse.cu",
        "tpuzlib/kernels/parse_pallas.py:44",
    )
    ow = d3.out_words_for(CHUNK)
    tok, _, _ = d3.make_encode_batch_v3(LEVEL, CHUNK, BATCH, ow, stage="compact")(*args)
    ll, dl, lcodes, dcodes = d3.make_encode_batch_v3(LEVEL, CHUNK, BATCH, ow, stage="trees")(*args)
    tables = (lcodes.int(), ll, dcodes.int().contiguous(), dl.contiguous())
    cases["pack_fields"] = (
        lambda: d3.pack_fields(tok, *tables),
        lambda: d3.pack_fields_plain(tok, *tables),
        "tpuzlib_torch/kernels/csrc/pack_fields.cu",
        "tpuzlib/kernels/deflate_device3.py:338",
    )
    return check_kernels(cases)


def phase_a_checksums(big) -> dict:
    """The checksum kernels against their plain versions on `big` (a card
    tensor of whole spans)."""
    from tpuzlib_torch.kernels import adler32_cuda, crc32_cuda

    crc_src, adler_src = "tpuzlib_torch/kernels/csrc/crc32.cu", "tpuzlib_torch/kernels/csrc/adler32.cu"
    return check_kernels({
        "crc32_forms": (
            lambda: crc32_cuda.crc32_forms(big, 0, 1),
            lambda: crc32_cuda.crc32_forms_plain(big, 0, 1),
            crc_src, "tpuzlib/kernels/crc32_pallas.py:24",
        ),
        "crc32_spans": (
            lambda: crc32_cuda.crc32_forms(big, 0, 256),
            lambda: crc32_cuda.crc32_forms_plain(big, 0, 256),
            crc_src, "tpuzlib/kernels/crc32_pallas.py:99",
        ),
        "adler32": (
            lambda: adler32_cuda.adler32_blocks(big, 0),
            lambda: adler32_cuda.adler32_blocks_plain(big, 0),
            adler_src, "tpuzlib/kernels/adler32_pallas.py:42",
        ),
    })


def check_kernels(cases) -> dict:
    """One row per kernel: its error against its plain version and both
    times; exits when a kernel differs.  The phase line adds the card
    memory the plain version takes at its peak."""
    rows = {}
    for name, (kern, plain, src, replaces) in cases.items():
        got = kern()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        want = plain()
        plain_peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        err = max_abs_err(got, want)
        del got, want
        rows[name] = dict(name=name, route="cuda", source=src, replaces=replaces, launches=None,
                          max_abs_err=err, ms=cuda_ms(kern), plain_ms=cuda_ms(plain))
        emit({"phase": "A", **rows[name], "plain_peak_MiB": plain_peak_mib})
        if err != 0:
            raise SystemExit("phase A: %s differs from its plain version" % name)
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


def phase_c(corpus) -> None:
    """tpuzlib_torch.deflate round trips through zlib; warm MB/s."""
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
    # encoder and the trailers' checksums, E for the per-block CRC forms
    _build.reset_launches()
    phase_c(corpus)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    phase_d(corpus)
    _build.reset_launches()
    phase_e(big_host, big)
    torch.cuda.synchronize()
    launches["crc32_forms"] = _build.LAUNCHES["crc32_forms"]
    phase_f()

    kernels = [{**rows[k], "launches": launches[k]} for k in rows]
    emit({"kernels": kernels})
    missing = [k for k in rows if launches[k] == 0]
    if missing:
        raise SystemExit("main path launched no %s kernel" % ", ".join(missing))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
