"""The port's streaming Inflater against tpuzlib's, on the CPU.

Inflater, InflaterOptions and InflateResult (api/inflate_api.py) and
ContainerInflater (containers/inflate_container.py) are copies of
tpuzlib's.  The same raw, zlib and gzip streams (gzip with FEXTRA, FNAME,
FCOMMENT, FHCRC and an mtime; a preset dictionary; bytes after the
stream; cut and corrupted copies) go through both in pieces of every
size; each append must give the same bytes or the same error, and
finish() the same InflateResult, total_in and total_out.  The option
checks and the reuse errors must give the same messages.
ContainerInflater's header parsers, the port's only ones, must give
tpuzlib's sizes, fields and errors.  Every comparison is exact.
"""

import dataclasses
import gzip
import struct
import zlib

import numpy as np
import pytest
import torch

import tpuzlib
import tpuzlib_torch
from tpuzlib.containers.inflate_container import ContainerInflater as JContainer
from tpuzlib_torch import Inflater, InflaterOptions, InflateResult, testing
from tpuzlib_torch.containers.inflate_container import ContainerInflater, NeedDictionary

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

DATA = testing.inflate_streams(1 << 13, seed=2)["hidden stored"][1]
ZDICT = DATA[-700:].tobytes()


def _gzip_header(mtime=1_700_000_000, extra=b"extra", name=b"name.txt", comment=b"a comment",
                 hcrc=True) -> bytes:
    """A gzip member's header with the optional fields given."""
    flg = (4 if extra is not None else 0) | (8 if name is not None else 0) | (
        16 if comment is not None else 0) | (2 if hcrc else 0)
    head = bytearray(b"\x1f\x8b\x08" + bytes([flg]) + struct.pack("<I", mtime) + b"\x00\xff")
    if extra is not None:
        head += struct.pack("<H", len(extra)) + extra
    if name is not None:
        head += name + b"\x00"
    if comment is not None:
        head += comment + b"\x00"
    if hcrc:
        head += struct.pack("<H", zlib.crc32(bytes(head)) & 0xFFFF)
    return bytes(head)


def _gzip(data: np.ndarray, **fields) -> bytes:
    return (_gzip_header(**fields) + testing.zlib_stream(data, 6, -15)
            + struct.pack("<II", zlib.crc32(data.tobytes()), len(data) & 0xFFFFFFFF))


def _fdict(data: np.ndarray) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=ZDICT)
    return c.compress(data.tobytes()) + c.flush()


def _flip(w: bytes, i: int) -> bytes:
    return w[:i] + bytes([w[i] ^ 0x10]) + w[i + 1 :]


GZ = _gzip(DATA)
Z = zlib.compress(DATA.tobytes(), 9)
STREAMS = {  # name -> (wire, raw, dictionary)
    "raw": (testing.zlib_stream(DATA, 6, -15), True, None),
    "zlib": (Z, False, None),
    "zlib FDICT": (_fdict(DATA), False, ZDICT),
    "zlib FDICT, no dictionary": (_fdict(DATA), False, None),
    "zlib FDICT, wrong dictionary": (_fdict(DATA), False, ZDICT[1:]),
    "gzip (python, mtime)": (gzip.compress(DATA.tobytes(), 6, mtime=1_234_567_890), False, None),
    "gzip (every field)": (GZ, False, None),
    "gzip (name only, no mtime)": (_gzip(DATA, mtime=0, extra=None, comment=None, hcrc=False),
                                   False, None),
    "gzip + garbage": (GZ + b"junk after the trailer", False, None),
    "gzip, two members": (GZ + gzip.compress(b"second"), False, None),
    "gzip, cut in its header": (GZ[:25], False, None),
    "gzip, cut in its body": (GZ[: len(GZ) // 2], False, None),
    "gzip, cut in its trailer": (GZ[:-3], False, None),
    "gzip, bad CRC": (_flip(GZ, len(GZ) - 6), False, None),
    "gzip, bad ISIZE": (_flip(GZ, len(GZ) - 2), False, None),
    "gzip, bad header CRC": (_flip(GZ, 20), False, None),
    "gzip, bad body": (_flip(GZ, len(GZ) // 3), False, None),
    "zlib, bad Adler-32": (_flip(Z, len(Z) - 1), False, None),
}


def _run(cls, wire: bytes, raw: bool, dictionary, split: int):
    """Each append's bytes or error, then finish()'s result and the totals."""
    inf = cls(raw=raw, dictionary=dictionary)
    log = []
    for i in range(0, len(wire), split):
        try:
            log.append([b.tobytes() for b in inf.append(wire[i : i + split])])
        except (ValueError, TypeError, RuntimeError) as e:
            log.append((type(e).__name__, str(e)))
            break
    result = dataclasses.asdict(inf.finish())
    return log, result, inf.total_in, inf.total_out


@pytest.mark.parametrize("split", [1 << 30, 4096, 7, 1])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_inflater_matches_tpuzlib(name, split):
    wire, raw, dictionary = STREAMS[name]
    got = _run(Inflater, wire, raw, dictionary, split)
    assert got == _run(tpuzlib.Inflater, wire, raw, dictionary, split)
    if name in ("raw", "zlib", "zlib FDICT", "gzip (every field)"):
        log, result, total_in, total_out = got
        assert b"".join(b for bufs in log for b in bufs) == DATA.tobytes()
        assert result["success"] and total_in == len(wire) and total_out == len(DATA)


def test_inflate_result_fields():
    """The verdict of a gzip member with every field, in the port's types."""
    inf = Inflater()
    out = inf.append(GZ)
    result = inf.finish()
    assert isinstance(result, InflateResult) and b"".join(b.tobytes() for b in out) == DATA.tobytes()
    assert (result.success, result.complete, result.checksum, result.fileSize, result.fileName) == (
        True, True, "match", "match", "name.txt")
    assert result.modDate.timestamp() == 1_700_000_000 and result.modDate.tzinfo is not None
    inf = Inflater(InflaterOptions(raw=True))
    inf.append(STREAMS["raw"][0])
    assert dataclasses.asdict(inf.finish()) == dict(success=True, complete=True,
                                                    checksum="unchecked", fileSize="unchecked",
                                                    fileName="", modDate=None)


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


def test_option_and_reuse_errors_match_tpuzlib():
    """Option checks, appends of the wrong type, an append after the
    stream's end and after finish(): tpuzlib's messages word for word."""
    ours, theirs = tpuzlib_torch, tpuzlib
    calls = [
        lambda m: m.Inflater(raw="yes"),
        lambda m: m.Inflater(raw=True, dictionary=b"abc"),
        lambda m: m.Inflater(dictionary=3.5),
        lambda m: m.Inflater(m.InflaterOptions(), raw=True),
        lambda m: m.Inflater(raw=None).append(3.5),
    ]
    for call in calls:
        want = _error(lambda: call(theirs))
        assert want is not None and _error(lambda: call(ours)) == want

    def after_end(m):
        inf = m.Inflater()
        inf.append(STREAMS["zlib"][0])
        inf.append(b"")
        inf.append(b"more")

    def after_finish(m):
        inf = m.Inflater()
        inf.finish()
        inf.append(b"x")

    for call in (after_end, after_finish):
        want = _error(lambda: call(theirs))
        assert want is not None and _error(lambda: call(ours)) == want


def test_header_parsers_agree_with_the_container():
    """ContainerInflater's header parsers, the port's only ones (the
    device route and the speculative inflate read them too), against
    tpuzlib's: the same size, mtime and name, None at the same cuts, the
    same errors; the zlib parse keeps the DICTID and leaves NEED_DICT to
    the append FSM, which raises tpuzlib's."""
    heads = [_gzip_header(), _gzip_header(extra=b"", name=b"", comment=b""),
             _gzip_header(mtime=0, extra=None, comment=None, hcrc=False),
             gzip.compress(b"x", mtime=5)[:10], _gzip_header(hcrc=False, name=b"\xe9t\xe9")]
    for head in heads:
        buf = np.frombuffer(head + b"\x03\x00", np.uint8)
        for cut in range(len(buf) + 1):
            c, jc = ContainerInflater(raw=False), JContainer(raw=False)
            size = c._parse_header(buf[:cut])
            assert size == jc._try_parse_header(buf[:cut])
            if size is not None:
                assert (c.mtime, c.file_name, c.trailer_len) == (jc.mtime, jc.file_name,
                                                                 jc.trailer_len)
    bad = np.frombuffer(_flip(_gzip_header(), 21), np.uint8)
    for parse in (lambda: ContainerInflater(raw=False)._parse_header(bad),
                  lambda: JContainer(raw=False)._try_parse_gzip_header(bad)):
        with pytest.raises(ValueError, match="header crc mismatch"):
            parse()
    for head in (b"\x1f\x8b\x07", b"\x1f\x8b\x08\xe0", b"\x79\x9c", b"\x88\x98", b"\x78\x9d"):
        buf = np.frombuffer(head + bytes(8), np.uint8)
        want = _error(lambda: JContainer(raw=False)._try_parse_header(buf))
        assert want is not None and _error(lambda: ContainerInflater(raw=False)._parse_header(buf)) == want
    fdict = np.frombuffer(_fdict(DATA[:10]), np.uint8)
    for buf, dictionary in ((np.frombuffer(STREAMS["zlib"][0], np.uint8), None),
                            (fdict, np.frombuffer(ZDICT, np.uint8)), (fdict[:5], None)):
        c = ContainerInflater(raw=False, dictionary=dictionary)
        size = c._try_parse_header(buf)
        assert size == JContainer(raw=False, dictionary=dictionary)._try_parse_header(buf)
        assert c.dict_id == (struct.unpack(">I", fdict[2:6].tobytes())[0] if size == 6 else None)
    for dictionary, kind in ((None, "required"), (np.frombuffer(ZDICT[1:], np.uint8), "invalid")):
        with pytest.raises(NeedDictionary, match=kind):
            ContainerInflater(raw=False, dictionary=dictionary)._try_parse_header(fdict)
        assert ContainerInflater(raw=False, dictionary=dictionary)._parse_header(fdict) == 6
