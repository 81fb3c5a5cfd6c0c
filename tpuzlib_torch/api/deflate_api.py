"""Public compression API: Deflater / DeflaterOptions / deflate().

Counterpart of tpuzlib/api/deflate_api.py.  The Deflater is a host
object, as tpuzlib's is: the host deflate engine (codec/deflate_engine.py)
compresses appended chunks, the native host checksums keep the running
Adler-32 (zlib) or CRC-32 (gzip), and a preset dictionary goes into the
zlib header as FDICT and its DICTID.

deflate() takes tpuzlib's route rule, with its `device` in place of
tpuzlib's TPUZLIB_DEVICE switch: on a CUDA device, from
DEVICE_MIN_BYTES of input (tpuzlib's floor under its switch), it runs
the batched device encoder and the container's checksum (Adler-32 for
zlib, CRC-32 for gzip) on that device (_deflate_device); with
device="cpu", below that floor, or with a preset dictionary (which the
device encoder takes none of), it runs the Deflater on the host engine,
and its bytes are those of tpuzlib's default deflate().  The rule is a
route and not a fallback: an error of the device route (CUDA, the
build, memory) propagates, and nothing retries on the host.

Telemetry (utils/trace.py) under tpuzlib's names: the Deflater's
`deflate.append` and `deflate.finish` stages; deflate()'s
`deflate.device` counter (the bytes the device encoder took) and its
`deflate.checksum` stage (the trailer's checksum).  tpuzlib's
`deflate.device_fallback` never counts here: deflate() has no fallback
from the device encoder.  The port's own: deflate() runs inside the
stage `deflate.call`, with its input bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..codec.deflate_engine import DeflateEngine
from ..common import mergeBuffers, u8_view
from ..containers.headers import (make_gzip_header, make_gzip_trailer, make_zlib_header,
                                  make_zlib_trailer)
from ..kernels.adler32 import adler32_host
from ..kernels.crc32 import crc32_host
from ..kernels.deflate_device3 import deflate_device_v3
from ..utils import trace
from ..utils.mem import tune_malloc
from .checksums import adler32, crc32

FORMATS = ("raw", "deflate", "gzip")
# the least input deflate() gives the device encoder on a CUDA device:
# tpuzlib's floor under TPUZLIB_DEVICE=1 (tpuzlib/api/deflate_api.py:170-171)
DEVICE_MIN_BYTES = 1 << 20


@dataclass
class DeflaterOptions:
    format: str = "deflate"
    level: int = 6
    dictionary: object = None
    fileName: Optional[str] = None


class Deflater:
    """Streaming compression on the host engine: append() chunks of any
    size, then finish(); each returns a list of output buffers."""

    def __init__(self, options: DeflaterOptions | None = None, **kwargs):
        if options is None:
            options = DeflaterOptions(**kwargs)
        elif kwargs:
            raise TypeError("pass either an options object or keyword options")
        level = options.level
        if not isinstance(level, int) or isinstance(level, bool) or not 1 <= level <= 9:
            raise ValueError("level must be between 1 and 9, inclusive")
        if options.format not in FORMATS:
            raise ValueError("container must be one of `raw`, `deflate`, `gzip`")
        if options.fileName is not None and not isinstance(options.fileName, str):
            raise TypeError("fileName must be a string")
        dictionary = options.dictionary
        if dictionary is not None:
            if options.format != "deflate":
                raise TypeError("Can only provide a dictionary for `deflate` containers.")
            try:
                dictionary = u8_view(dictionary)
            except TypeError:
                raise TypeError("dictionary must be an ArrayBuffer or buffer view") from None
        self.format = options.format
        self.level = level
        self.file_name = options.fileName
        self.dictionary = dictionary
        self.engine = DeflateEngine(level, dictionary)
        self.checksum = 1 if self.format == "deflate" else 0
        self.orig_size = 0
        self.compressed_size = 0
        self._started = False
        self._finished = False

    @property
    def total_in(self) -> int:
        """Bytes consumed so far."""
        return self.orig_size

    @property
    def total_out(self) -> int:
        """Compressed bytes produced so far."""
        return self.compressed_size

    def _header(self) -> np.ndarray:
        if self.format == "deflate":
            dict_id = adler32_host(self.dictionary) if self.dictionary is not None else None
            return u8_view(make_zlib_header(self.level, dict_id))
        if self.format == "gzip":
            return u8_view(make_gzip_header(self.file_name, level=self.level))
        return np.empty(0, dtype=np.uint8)

    def append(self, data) -> list[np.ndarray]:
        if self._finished:
            raise RuntimeError("Deflater instances cannot be reused")
        try:
            view = u8_view(data)
        except TypeError:
            raise TypeError("data must be an ArrayBuffer or buffer view") from None
        buffers = []
        if not self._started:
            self._started = True
            hdr = self._header()
            if len(hdr):
                buffers.append(hdr)
        if self.format == "deflate":
            self.checksum = adler32_host(view, self.checksum)
        elif self.format == "gzip":
            self.checksum = crc32_host(view, self.checksum)
        self.orig_size += len(view)
        with trace.timed_stage("deflate.append", len(view)):
            out = self.engine.push(view)
        if len(out):
            buffers.append(out)
        self.compressed_size += sum(len(b) for b in buffers)
        return buffers

    def finish(self) -> list[np.ndarray]:
        if self._finished:
            raise RuntimeError("Deflater instances cannot be reused")
        if not self._started:
            raise RuntimeError("Cannot call finish before at least 1 call to append")
        self._finished = True
        with trace.timed_stage("deflate.finish"):
            buffers = [self.engine.finish()]
        if self.format == "deflate":
            buffers.append(u8_view(make_zlib_trailer(self.checksum)))
        elif self.format == "gzip":
            buffers.append(u8_view(make_gzip_trailer(self.checksum, self.orig_size)))
        buffers = [b for b in buffers if len(b)]
        self.compressed_size += sum(len(b) for b in buffers)
        return buffers


def _deflate_device(view: np.ndarray, deflater: Deflater, device) -> np.ndarray:
    """deflate()'s device route: the batched device encoder on `device`
    with the container of `deflater` (validated options, no dictionary)
    around it, the trailer's checksum on `device` too."""
    level, fmt = deflater.level, deflater.format
    body = deflate_device_v3(np.ascontiguousarray(view), level=level, device=device)
    trace.count("deflate.device", len(view))
    if fmt == "raw":
        return body
    with trace.timed_stage("deflate.checksum", len(view)):
        if fmt == "gzip":
            head = make_gzip_header(deflater.file_name, level=level)
            trailer = make_gzip_trailer(crc32(view, device=device), len(view))
        else:
            head, trailer = make_zlib_header(level), make_zlib_trailer(adler32(view, device=device))
    return mergeBuffers([head, body, trailer])


def deflate(data, options: DeflaterOptions | None = None, *, device="cuda", **kwargs) -> np.ndarray:
    """One-shot compress `data`: with the device encoder on a CUDA
    `device` from DEVICE_MIN_BYTES without a dictionary, else with the
    host engine (the module docstring gives the rule).

    Options come as a DeflaterOptions or as its fields by keyword.
    Returns the container bytes as a uint8 array."""
    tune_malloc()  # large codec buffers must not be munmap'd per call
    try:
        view = u8_view(data)
    except TypeError:
        raise TypeError("data must be an ArrayBuffer or buffer view") from None
    deflater = Deflater(options, **kwargs)  # validates the options
    with trace.timed_stage("deflate.call", view):
        if (deflater.dictionary is None and len(view) >= DEVICE_MIN_BYTES
                and torch.device(device).type != "cpu"):
            return _deflate_device(view, deflater, device)
        return mergeBuffers(deflater.append(view) + deflater.finish())
