"""Public compression API: DeflaterOptions / deflate().

Counterpart of tpuzlib/api/deflate_api.py's option validation and its
device route.  The port has no host engine: deflate() always runs the
batched device encoder on the given device, and the container's checksum
(Adler-32 for zlib, CRC-32 for gzip) on the same device.  An error in
the encoder or a checksum propagates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..common import mergeBuffers, u8_view
from ..containers.headers import (make_gzip_header, make_gzip_trailer, make_zlib_header,
                                  make_zlib_trailer)
from ..kernels.deflate_device3 import deflate_device_v3
from .checksums import adler32, crc32

FORMATS = ("raw", "deflate", "gzip")


@dataclass
class DeflaterOptions:
    format: str = "deflate"
    level: int = 6
    dictionary: object = None
    fileName: Optional[str] = None


def _validate(options: DeflaterOptions) -> None:
    level = options.level
    if not isinstance(level, int) or isinstance(level, bool) or not 1 <= level <= 9:
        raise ValueError("level must be between 1 and 9, inclusive")
    if options.format not in FORMATS:
        raise ValueError("container must be one of `raw`, `deflate`, `gzip`")
    if options.fileName is not None and not isinstance(options.fileName, str):
        raise TypeError("fileName must be a string")
    if options.dictionary is not None:
        if options.format != "deflate":
            raise TypeError("Can only provide a dictionary for `deflate` containers.")
        try:
            u8_view(options.dictionary)
        except TypeError:
            raise TypeError("dictionary must be an ArrayBuffer or buffer view") from None
        raise NotImplementedError(
            "preset dictionaries are not supported: tpuzlib's device route declines them,"
            " and the host engine that serves them is not ported to tpuzlib_torch"
        )


def deflate(data, options: DeflaterOptions | None = None, *, device="cuda", **kwargs) -> np.ndarray:
    """One-shot compress `data` with the device encoder on `device`.

    Options come as a DeflaterOptions or as its fields by keyword.
    Returns the container bytes as a uint8 array."""
    try:
        view = u8_view(data)
    except TypeError:
        raise TypeError("data must be an ArrayBuffer or buffer view") from None
    if options is None:
        options = DeflaterOptions(**kwargs)
    elif kwargs:
        raise TypeError("pass either an options object or keyword options")
    _validate(options)
    body = deflate_device_v3(np.ascontiguousarray(view), level=options.level, device=device)
    if options.format == "raw":
        return body
    if options.format == "gzip":
        return mergeBuffers([
            make_gzip_header(options.fileName, level=options.level), body,
            make_gzip_trailer(crc32(view, device=device), len(view)),
        ])
    return mergeBuffers([
        make_zlib_header(options.level), body, make_zlib_trailer(adler32(view, device=device))
    ])
