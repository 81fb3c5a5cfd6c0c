"""Streaming container-aware inflater (header FSM + engine + trailer).

Counterpart of tpuzlib/containers/inflate_container.py.  ContainerInflater
is tpuzlib's host object, copied: it feeds appended bytes through the
header parse, the host engine (codec/engine.py) and the trailer read
after the final block, which ignores bytes past the trailer.  Parity with
reference src/inflate.ts: gzip magic detect (:142-174), zlib CMF/FLG
check (:214-218), DICTID -> NEED_DICT (:227-270), gzip
MTIME/EXTRA/NAME/COMMENT/HCRC parsing (:277-401), trailer checksum + gzip
ISIZE (:423-463), dictionary verification (:475-503).

Its header parsers are the port's only ones for the two containers:
one-shot inflate's device route (api/inflate_api.py) and the speculative
host inflate (parallel/speculative.py) read a whole stream's header
size, gzip fields and zlib DICTID through `_parse_header`,
`_try_parse_gzip_header` and `_parse_zlib_header`, which leave the
dictionary check (NEED_DICT) to the caller; the append FSM runs it in
`_try_parse_header`.
"""

from __future__ import annotations

import struct

import numpy as np

from ..codec.engine import RawInflateEngine
from ..codec.tokenize import DataError
from ..kernels.adler32 import adler32_host
from ..kernels.crc32 import crc32_host


FMT_RAW = "raw"
FMT_ZLIB = "deflate"
FMT_GZIP = "gzip"

_ST_HEADER = 0
_ST_BODY = 1
_ST_TRAILER = 2
_ST_DONE = 3


class NeedDictionary(Exception):
    pass


class ContainerInflater:
    """Feeds appended bytes through header parse -> engine -> trailer."""

    def __init__(self, raw: bool, dictionary: np.ndarray | None = None):
        self.raw = raw
        self.dictionary = dictionary
        self.engine = RawInflateEngine(dictionary if raw else None)
        self.header_buf = np.empty(0, dtype=np.uint8)
        self.state = _ST_BODY if raw else _ST_HEADER
        self.format = FMT_RAW if raw else None
        self.file_name = ""
        self.mtime = 0
        self.stored_checksum = 0
        self.stored_isize = 0
        self.trailer_len = 0 if raw else None
        self.output_checksum = 1  # adler seed; switched to 0 for gzip/raw
        self._checksum_kind = None
        self.dict_id = None  # a zlib header's DICTID (FDICT set)

    # -- public ---------------------------------------------------------------

    def push(self, data: np.ndarray) -> np.ndarray:
        outputs = []
        if self.state == _ST_HEADER:
            self.header_buf = (
                np.concatenate([self.header_buf, data])
                if len(self.header_buf)
                else data
            )
            consumed = self._try_parse_header(self.header_buf)
            if consumed is None:
                return np.empty(0, dtype=np.uint8)
            data = self.header_buf[consumed:]
            self.header_buf = np.empty(0, dtype=np.uint8)
            self.state = _ST_BODY

        if self.state == _ST_BODY:
            out = self.engine.push(data if len(data) else None)
            if len(out):
                self._update_checksum(out)
                outputs.append(out)
            if self.engine.finished:
                self.state = _ST_TRAILER
                self.header_buf = self.engine.take_leftover()
                self._try_parse_trailer()
        elif self.state in (_ST_TRAILER, _ST_DONE):
            # excess input after the stream: buffer (ignored beyond trailer)
            self.header_buf = (
                np.concatenate([self.header_buf, data])
                if len(self.header_buf)
                else data
            )
            if self.state == _ST_TRAILER:
                self._try_parse_trailer()

        return (
            np.concatenate(outputs) if outputs else np.empty(0, dtype=np.uint8)
        )

    @property
    def is_complete(self) -> bool:
        return self.state == _ST_DONE

    @property
    def total_out(self) -> int:
        return self.engine.total_out

    # -- internals ------------------------------------------------------------

    def _update_checksum(self, out: np.ndarray) -> None:
        if self._checksum_kind == "adler":
            self.output_checksum = adler32_host(out, self.output_checksum)
        elif self._checksum_kind == "crc":
            self.output_checksum = crc32_host(out, self.output_checksum)

    def _try_parse_header(self, buf: np.ndarray):
        """Returns consumed byte count, or None if more input is needed."""
        size = self._parse_header(buf)
        if size is not None and self.dict_id is not None:
            self._use_dictionary()
        return size

    def _parse_header(self, buf: np.ndarray):
        """The gzip or zlib header's size, or None when `buf` ends inside
        it; a zlib DICTID is kept in dict_id, unchecked."""
        if len(buf) < 2:
            return None
        if buf[0] == 0x1F and buf[1] == 0x8B:
            return self._try_parse_gzip_header(buf)
        return self._parse_zlib_header(buf)

    def _parse_zlib_header(self, buf: np.ndarray):
        cmf, flg = int(buf[0]), int(buf[1])
        if (cmf & 0x0F) != 8:
            raise DataError("unknown compression method")
        if (cmf >> 4) > 7:
            raise DataError("invalid window size")
        if ((cmf << 8) + flg) % 31 != 0:
            raise DataError("incorrect header check")
        self.format = FMT_ZLIB
        self._checksum_kind = "adler"
        self.output_checksum = 1
        self.trailer_len = 4
        if flg & 0x20:  # FDICT
            if len(buf) < 6:
                return None
            self.dict_id = struct.unpack(">I", buf[2:6].tobytes())[0]
            return 6
        return 2

    def _use_dictionary(self) -> None:
        """NEED_DICT: the preset dictionary must be given and match DICTID."""
        if self.dictionary is None:
            raise NeedDictionary("required")
        if adler32_host(self.dictionary) != self.dict_id:
            raise NeedDictionary("invalid")
        self.engine.set_dictionary(self.dictionary)

    def _try_parse_gzip_header(self, buf: np.ndarray):
        if len(buf) < 10:
            return None
        cm, flg = int(buf[2]), int(buf[3])
        if cm != 8:
            raise DataError("unknown compression method")
        if flg & 0xE0:
            raise DataError("unknown header flags set")
        self.mtime = struct.unpack("<I", buf[4:8].tobytes())[0]
        pos = 10
        if flg & 0x04:  # FEXTRA
            if len(buf) < pos + 2:
                return None
            xlen = struct.unpack("<H", buf[pos : pos + 2].tobytes())[0]
            pos += 2
            if len(buf) < pos + xlen:
                return None
            pos += xlen
        if flg & 0x08:  # FNAME
            end = np.flatnonzero(buf[pos:] == 0)
            if len(end) == 0:
                return None
            self.file_name = buf[pos : pos + end[0]].tobytes().decode(
                "latin-1", "replace"
            )
            pos += int(end[0]) + 1
        if flg & 0x10:  # FCOMMENT
            end = np.flatnonzero(buf[pos:] == 0)
            if len(end) == 0:
                return None
            pos += int(end[0]) + 1
        if flg & 0x02:  # FHCRC
            if len(buf) < pos + 2:
                return None
            stored_hcrc = struct.unpack("<H", buf[pos : pos + 2].tobytes())[0]
            if (crc32_host(buf[:pos]) & 0xFFFF) != stored_hcrc:
                raise DataError("header crc mismatch")
            pos += 2
        self.format = FMT_GZIP
        self._checksum_kind = "crc"
        self.output_checksum = 0
        self.trailer_len = 8
        return pos

    def _try_parse_trailer(self) -> None:
        if self.trailer_len == 0:
            self.state = _ST_DONE
            return
        if len(self.header_buf) < self.trailer_len:
            return
        tb = self.header_buf[: self.trailer_len].tobytes()
        if self.format == FMT_ZLIB:
            self.stored_checksum = struct.unpack(">I", tb)[0]
        else:  # gzip
            self.stored_checksum, self.stored_isize = struct.unpack("<II", tb)
        self.state = _ST_DONE
