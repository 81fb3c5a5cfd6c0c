"""tpuzlib_torch stands alone: it imports no JAX and nothing of tpuzlib,
and its host pieces and tables equal tpuzlib's."""

import importlib
import os
import re
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import tpuzlib_torch
from tpuzlib import containers as jcontainers
from tpuzlib.codec import bitsink as jbitsink
from tpuzlib.codec import huffman as jhuffman
from tpuzlib.codec import lz77 as jlz77
from tpuzlib.codec import tables as jtables
from tpuzlib.codec import tokenize as jtk
from tpuzlib.common import mergeBuffers as j_merge
from tpuzlib.common import u8_view as j_u8_view
from tpuzlib.containers import headers as jheaders
from tpuzlib.kernels import adler32 as jadler
from tpuzlib.kernels import deflate_device as jdd
from tpuzlib.kernels import deflate_device3 as jd3
from tpuzlib_torch import DeflaterOptions
from tpuzlib_torch.api import inflate_api
from tpuzlib_torch.codec import bitsink, engine, huffman, tables
from tpuzlib_torch.codec import tokenize as tk
from tpuzlib_torch.containers import headers, inflate_container
from tpuzlib_torch.kernels import _build, adler32, adler32_cuda, crc32_probe, deflate_device as tdd
from tpuzlib_torch.kernels import deflate_device3 as td3
from tpuzlib_torch.kernels import gather_probe, inflate_cuda, inflate_prims, parse, screen
from tpuzlib_torch.native import api as native_api
from tpuzlib_torch.native import bindings

# One intra-op thread: the suite runs in several worker processes at once,
# and their OpenMP threads, one per core each, spin against one another.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tpuzlib_torch")


def test_fresh_import_pulls_in_no_jax():
    code = (
        "import sys, tpuzlib_torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpuzlib'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_imports_jax_or_tpuzlib():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|tpuzlib)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    probes = ("probe_crc", "probe_crc2", "probe_crc3", "probe_gather", "probe_primitives",
              "probe_inflate_prims", "probe_inflate_prims2")
    assert {os.path.join(PKG, "tools", n + ".py") for n in probes} <= set(files)
    kernels = ("crc32_probe", "gather_probe", "inflate_prims")
    assert {os.path.join(PKG, "kernels", n + ".py") for n in kernels} <= set(files)
    hosts = ("parallel/mesh", "parallel/pipeline", "parallel/speculative", "utils/mem")
    assert {os.path.join(PKG, n + ".py") for n in hosts} <= set(files)
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_public_surface():
    assert sorted(tpuzlib_torch.__all__) == sorted(
        ["deflate", "Deflater", "DeflaterOptions", "DeviceDeflater", "inflate", "inflate_members",
         "Inflater", "InflaterOptions", "InflateResult", "DeviceDeclined", "adler32", "crc32", "mergeBuffers",
         "u8_view"])
    assert issubclass(tpuzlib_torch.DeviceDeclined, RuntimeError)
    assert (tpuzlib_torch.Inflater, tpuzlib_torch.InflaterOptions, tpuzlib_torch.InflateResult) == (
        inflate_api.Inflater, inflate_api.InflaterOptions, inflate_api.InflateResult)
    # the host engine's modules are the port's own copies
    assert engine.RawInflateEngine.__module__ == "tpuzlib_torch.codec.engine"
    assert inflate_container.ContainerInflater.__module__ == "tpuzlib_torch.containers.inflate_container"
    assert native_api.InflateStream.__module__ == "tpuzlib_torch.native.api"
    assert tpuzlib_torch.Deflater.__module__ == "tpuzlib_torch.api.deflate_api"
    # the subpackages' surfaces: tpuzlib's containers exports, docstrings
    # that name what each subpackage holds
    assert tpuzlib_torch.containers.__all__ == jcontainers.__all__
    assert tpuzlib_torch.containers.ContainerInflater is inflate_container.ContainerInflater
    assert all(getattr(tpuzlib_torch.containers, n) is getattr(headers, n)
               for n in tpuzlib_torch.containers.__all__ if n.startswith("make_"))
    docs = {pkg: importlib.import_module("tpuzlib_torch." + pkg).__doc__
            for pkg in ("api", "codec", "containers", "native")}
    for pkg, words in (("api", ("checksums", "deflate()", "inflate()")),
                       ("codec", ("deflate engine", "inflate engine")),
                       ("containers", ("ContainerInflater", "gzip")),
                       ("native", ("deflate", "inflate", "required"))):
        assert all(w in docs[pkg] for w in words), pkg
    data = np.arange(10, dtype=np.uint16)
    for x in (b"abc", bytearray(b"xy"), memoryview(b"q"), data, np.zeros((2, 3), np.int32)):
        assert np.array_equal(tpuzlib_torch.u8_view(x), j_u8_view(x))
    bufs = [b"ab", np.arange(3, dtype=np.uint8), bytearray(b"z")]
    assert np.array_equal(tpuzlib_torch.mergeBuffers(bufs), j_merge(bufs))
    assert len(tpuzlib_torch.mergeBuffers([])) == 0
    with pytest.raises(TypeError):
        tpuzlib_torch.u8_view(3.5)


def test_level_tables_match():
    assert td3.LEVELS_V3 == jd3.LEVELS_V3
    assert set(tables.LEVELS) == set(jlz77.LEVELS)
    for lvl, p in jlz77.LEVELS.items():
        assert (tables.LEVELS[lvl].lazy, tables.LEVELS[lvl].max_lazy) == (p.lazy, p.max_lazy)
    assert tables.TOO_FAR == jlz77.TOO_FAR
    assert (tables.MIN_MATCH, tables.MAX_MATCH, tables.WINDOW_SIZE) == (
        jtables.MIN_MATCH, jtables.MAX_MATCH, jtables.WINDOW_SIZE)
    assert np.array_equal(tables.CLC_ORDER, jtables.CLC_ORDER)
    for name in ("LENGTH_BASE", "LENGTH_EXTRA", "DIST_BASE", "DIST_EXTRA",
                 "FIXED_LITLEN_LENGTHS", "FIXED_DIST_LENGTHS"):
        assert np.array_equal(getattr(tables, name), getattr(jtables, name)), name
    assert (tdd.CTX, tdd.SEG) == (jdd.CTX, jdd.SEG)
    for chunk in (1 << 14, 1 << 16, 1 << 18):
        # tpuzlib's token cap and output window for the chunk
        assert td3.token_cap(chunk) == max(4096, (chunk // 2 // 4096) * 4096)
        assert td3.out_words_for(chunk) == min(chunk + 4, (chunk * 10) // 32 + 64)


def test_bitsink_matches():
    rng = np.random.default_rng(0)
    a, b = jbitsink.BitSink(5, 3), bitsink.BitSink(5, 3)
    for _ in range(20):
        nb = rng.integers(1, 33, 50)
        vals = rng.integers(0, 1 << 32, 50, dtype=np.uint64) & ((np.uint64(1) << nb.astype(np.uint64)) - np.uint64(1))
        for s in (a, b):
            s.push(vals, nb)
            s.push_scalar(1, 1)
            s.push_bytes(np.arange(7, dtype=np.uint8))
            s.align_byte()
            s.push_scalar(3, 2)
        ra, rb = a.flush(), b.flush()
        assert ra[0].tobytes() == rb[0].tobytes() and ra[1:] == rb[1:]
    assert a.flush(final=True)[0].tobytes() == b.flush(final=True)[0].tobytes()


def test_zlib_headers_and_adler_match():
    for level in range(1, 10):
        assert headers.make_zlib_header(level) == jheaders.make_zlib_header(level)
        for dict_id in (0, 1, 0xDEADBEEF):
            assert (headers.make_zlib_header(level, dict_id)
                    == jheaders.make_zlib_header(level, dict_id))
    assert headers.make_zlib_trailer(0x1FFFFFFFF) == jheaders.make_zlib_trailer(0x1FFFFFFFF)
    rng = np.random.default_rng(1)
    for n in (0, 1, 4095, (1 << 20) + 3, (3 << 20) - 1):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        for seed in (1, 0xDEADBEEF):
            want = zlib.adler32(data.tobytes(), seed)
            assert adler32.adler32_host(data, seed) == want
    assert adler32.adler32_host(np.zeros(0, np.uint8), 7) == jadler.adler32_host(np.zeros(0, np.uint8), 7)


def test_deflate_options_validation():
    data = b"hello hello hello"
    for kw, exc in (
        (dict(level=0), ValueError), (dict(level=10), ValueError), (dict(level=True), ValueError),
        (dict(level=6.0), ValueError), (dict(format="lz4"), ValueError),
        (dict(fileName=3), TypeError), (dict(format="raw", dictionary=b"ab"), TypeError),
        (dict(dictionary=3.5), TypeError), (dict(format="gzip", fileName=3), TypeError),
    ):
        with pytest.raises(exc):
            tpuzlib_torch.deflate(data, device="cpu", **kw)
    # a preset dictionary goes through the host engine: FDICT, its DICTID
    out = tpuzlib_torch.deflate(data, dictionary=b"abc", device="cpu").tobytes()
    assert out[1] & 0x20 and out[2:6] == zlib.adler32(b"abc").to_bytes(4, "big")
    assert zlib.decompressobj(zdict=b"abc").decompress(out) == data
    with pytest.raises(TypeError):
        tpuzlib_torch.deflate(1.5, device="cpu")
    with pytest.raises(TypeError):
        tpuzlib_torch.deflate(data, DeflaterOptions(), level=3, device="cpu")


@pytest.mark.parametrize("fmt", ["raw", "deflate"])
def test_deflate_small_roundtrip(fmt):
    data = b"tpuzlib_torch " * 300 + bytes(range(256))
    out = tpuzlib_torch.deflate(data, DeflaterOptions(format=fmt, level=4), device="cpu")
    assert (zlib.decompress(out.tobytes(), -15 if fmt == "raw" else 15)) == data
    empty = tpuzlib_torch.deflate(b"", format=fmt, device="cpu")
    assert zlib.decompress(empty.tobytes(), -15 if fmt == "raw" else 15) == b""


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; for any
    device it has no kernel for, it raises rather than falling back."""
    m = torch.zeros(16, dtype=torch.int32, device="meta")
    b = torch.zeros(16, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        screen.near_screen(b, m, m, 8)
    with pytest.raises(ValueError):
        screen.far_screen(m, m.long(), b, m, 8)
    with pytest.raises(ValueError):
        parse.segment_parse(m, 16)
    with pytest.raises(ValueError):
        adler32_cuda.adler32_device_scalar(b)
    with pytest.raises(ValueError):
        td3.pack_words(m.reshape(2, 8), m, m, m, m, m.long(), m.long(), m.long(), m, 8)
    meta = lambda *shape: torch.zeros(shape, dtype=torch.int32, device="meta")  # noqa: E731
    with pytest.raises(ValueError):
        inflate_cuda.cursor_decode(inflate_cuda.DecodeArgs(
            meta(64), meta(inflate_cuda.NCUR, 4), meta(1, inflate_cuda.TB),
            meta(1, inflate_cuda.LE), meta(1, inflate_cuda.DE), 8, 8))
    with pytest.raises(ValueError):
        inflate_cuda.decode_luts(inflate_cuda.DecodeArgs(
            meta(64), meta(inflate_cuda.NCUR, 4), meta(1, inflate_cuda.TB),
            meta(1, inflate_cuda.LE), meta(1, inflate_cuda.DE), 8, 8))
    rows = b.reshape(2, 8)
    with pytest.raises(ValueError):
        crc32_probe.crc_rowsum(rows)
    with pytest.raises(ValueError):
        crc32_probe.crc_unpack(rows, "u8")
    with pytest.raises(ValueError):
        crc32_probe.crc_forms_mm(torch.zeros(2, 1024, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError):
        crc32_probe.gf2_bits_mm(torch.zeros(2, 128, dtype=torch.bfloat16, device="meta"),
                                torch.zeros(128, 32, dtype=torch.bfloat16, device="meta"))
    m2 = meta(2, 8)
    row = meta(1, 8)
    for call in (lambda: gather_probe.take_along(m2, m2, 0),
                 lambda: gather_probe.take_along_loop(m2, m2, 1),
                 lambda: gather_probe.flat_gather(m2, m2),
                 lambda: gather_probe.scatter_max(m2, m2, 4),
                 lambda: gather_probe.shift_screen(m2),
                 lambda: inflate_prims.vec_cond_while(row),
                 lambda: inflate_prims.fetch_rows(m2, row),
                 lambda: inflate_prims.row_store_loop(2, 8, "meta"),
                 lambda: inflate_prims.gather_store_loop(m2, row),
                 lambda: inflate_prims.col_min_sum(m2),
                 lambda: inflate_prims.var_shifts(row, row),
                 lambda: inflate_prims.tree_decode(row, meta(16, 8), meta(16, 8), meta(16, 8)),
                 lambda: inflate_prims.table_lookup(m2, row),
                 lambda: inflate_prims.window64(row, row, row, row, row)):
        with pytest.raises(ValueError):
            call()
    assert set(_build.LAUNCHES) == {"near_screen", "far_screen", "segment_parse", "pack_words",
                                    "crc32_forms", "crc32_spans", "crc32_scalar",
                                    "crc32_segments", "adler32",
                                    "adler32_scalar", "inflate_lut", "inflate_decode",
                                    "header_filter", "header_parse", "crc_rowsum", "crc_unpack_u8", "crc_unpack_i32", "crc_unpack_bf16", "gf2_bits_mm",
                                    "crc_forms_mm_bf16", "crc_forms_mm_i8", "take_along",
                                    "take_along_loop", "flat_gather", "scatter_max",
                                    "shift_screen", "vec_cond_while", "vec_cond_while_regs",
                                    "vec_cond_while_smem", "vec_cond_while_global", "fetch_rows",
                                    "row_store_loop", "gather_store_loop", "col_min_sum",
                                    "var_shifts", "tree_decode", "window64"}
    assert set(_build._ARGTYPES) >= {"tz_" + k for k in ("take_along", "take_along_loop",
                                                         "flat_gather", "scatter_max",
                                                         "shift_screen", "vec_cond_while",
                                                         "fetch_rows", "row_store_loop",
                                                         "gather_store_loop", "col_min_sum",
                                                         "var_shifts", "tree_decode", "window64")}
    assert all(p.endswith((".cu", ".cuh")) for p in _build.sources()) and len(_build.sources()) >= 6


def test_huffman_and_tokenize_match():
    for name in ("MAX_BITS", "VAL_MASK", "NB_SHIFT", "EB_SHIFT", "NB_MASK", "F_LEN", "F_EOB",
                 "INVALID"):
        assert getattr(huffman, name) == getattr(jhuffman, name), name
    rng = np.random.default_rng(2)
    for kind, n in (("litlen", 288), ("dist", 32), ("codelen", 19)):
        fixed = tables.FIXED_LITLEN_LENGTHS if kind == "litlen" else tables.FIXED_DIST_LENGTHS
        sets = [fixed[:n], np.array([1, 1] + [0] * (n - 2)), np.array([1] + [0] * (n - 1)),
                np.array([1, 2, 2, 2] + [0] * (n - 4)), rng.integers(0, 8, n)]
        for lengths in sets:
            lengths = np.asarray(lengths, np.int32)
            try:
                want = jhuffman.build_lut(lengths, kind)
            except jhuffman.TreeError as e:
                with pytest.raises(huffman.TreeError, match=str(e)):
                    huffman.build_lut(lengths, kind)
                continue
            assert np.array_equal(huffman.build_lut(lengths, kind), want)
    # dynamic headers: the code lengths parsed from zlib streams, and the
    # errors of truncated headers
    data = np.frombuffer(b"tpuzlib_torch inflate " * 400 + bytes(range(256)), np.uint8)
    for level in (1, 6, 9):
        buf = np.frombuffer(zlib.compress(data.tobytes(), level)[2:-4], np.uint8)
        for cut in (len(buf), 40, 9):
            reader, jreader = tk.BitReader(buf[:cut], 3, cut * 8), jtk.BitReader(buf[:cut], 3, cut * 8)
            try:
                want = jtk.parse_dynamic_lengths(jreader)
            except (jtk.DataError, jtk.NeedMoreInput) as e:
                with pytest.raises((tk.DataError, tk.NeedMoreInput), match=str(e)):
                    tk.parse_dynamic_lengths(reader)
                continue
            got = tk.parse_dynamic_lengths(reader)
            assert all(np.array_equal(g, w) for g, w in zip(got, want)) and reader.pos == jreader.pos


def test_native_library_builds_and_loads():
    lib = bindings.lib()
    for name in ("tz_find_headers", "tz_confirm_headers", "tz_tokenize_midblock",
                 "tz_inflate_tokenize", "tz_expand_tokens", "tz_state_new", "tz_state_free", "tz_inflate_stream",
                 "tz_inflate_raw", "tz_adler32", "tz_crc32"):
        assert callable(getattr(lib, name))
    so = bindings.build()
    assert os.path.dirname(so) == os.path.join(PKG, "native", "_build") and os.path.exists(so)
    assert "-march=native" not in bindings.FLAGS and bindings.lib() is lib
    with pytest.raises(ValueError):
        bindings.ptr(np.zeros((4, 4), np.int32)[:, 1])


def test_reads_no_environment():
    """No environment switch: the reads are tpuzlib's allocator opt-out
    TPUZLIB_MALLOC_TUNE in utils/mem.py and its telemetry switch
    TPUZLIB_TRACE in utils/trace.py, which selects no route (the mesh's
    torchrun variables are read by torch.distributed's env://
    initialisation)."""
    reads = {os.path.join("utils", "mem.py"): "TPUZLIB_MALLOC_TUNE",
             os.path.join("utils", "trace.py"): "TPUZLIB_TRACE"}
    pat = re.compile(r"os\.environ|getenv")
    seen = set()
    for root, _, names in os.walk(PKG):
        for n in names:
            if n.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, n), PKG)
                seen.add(rel)
                with open(os.path.join(root, n)) as f:
                    text = f.read()
                if rel in reads:
                    assert re.findall(r"os\.environ\.get\(\"(\w+)\"", text) == [reads[rel]]
                    assert len(pat.findall(text)) == 1
                else:
                    assert not pat.search(text), n
    assert {"tools/__init__.py", "tools/probe_crc.py", "tools/probe_crc2.py",
            "tools/probe_crc3.py", "kernels/crc32_probe.py", "tools/probe_gather.py",
            "tools/probe_primitives.py", "tools/probe_inflate_prims.py",
            "tools/probe_inflate_prims2.py", "kernels/gather_probe.py",
            "kernels/inflate_prims.py"} <= seen


def test_importing_the_probes_runs_nothing():
    """Every probe does its work in main(): importing one prints nothing and
    builds and launches nothing (tools/probe_primitives.py runs at import)."""
    code = (
        "import tpuzlib_torch.tools.probe_primitives, tpuzlib_torch.tools.probe_gather\n"
        "import tpuzlib_torch.tools.probe_inflate_prims, tpuzlib_torch.tools.probe_inflate_prims2\n"
        "from tpuzlib_torch.kernels import _build\n"
        "assert _build.lib._handle is None and not any(_build.LAUNCHES.values())\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == ""
