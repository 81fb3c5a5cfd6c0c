"""Stand-ins for the timed call that `correct` must refuse.

control(entry): the plain reference put in the port's place, with one
guarantee of the configuration broken (no precision is stated, so none
can be lowered):
  deflate  zlib's stream whose trailer checks all but the input's last byte
  inflate  zlib's decode with its last byte lost
  crc32    zlib's CRC-32 of all but the record's last byte

FAULTS: the port's own call, broken where the answer is produced:
  alter    one bit of the answer flipped (a byte of the output, bit 0 of
           a checksum)
  half     half of the work left out: the first half of the answer, or
           for a checksum the first half of the record checksummed

Each is a program factory in the shape of entries/<entry>.py's program.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import zlib_ref


def _deflate(api, config, device):
    def call(piece):
        stream = bytearray(zlib_ref.compress(piece, config))
        short = memoryview(piece)[:-1]
        if config["container"] == "deflate":
            stream[-4:] = struct.pack(">I", zlib.adler32(short))
        elif config["container"] == "gzip":
            stream[-8:-4] = struct.pack("<I", zlib.crc32(short))
        else:
            stream = bytearray(zlib_ref.compress(piece[:-1], config))
        return np.frombuffer(bytes(stream), np.uint8)

    return call


def _inflate(api, config, device):
    def call(stream):
        d = zlib.decompressobj(zlib_ref.wbits(config))
        out = d.decompress(memoryview(stream)) + d.flush()
        return np.frombuffer(out[:-1], np.uint8)

    return call


def _crc32(api, config, device):
    def call(record):
        return zlib.crc32(memoryview(record.cpu().numpy())[:-1])

    return call


CONTROLS = {"deflate": _deflate, "inflate": _inflate, "crc32": _crc32}


def control(entry: str):
    return CONTROLS[entry]


def _flip(answer):
    if isinstance(answer, int):
        return answer ^ 1
    out = np.array(answer, dtype=np.uint8, copy=True)
    out[len(out) // 2] ^= 1
    return out


def alter(program):
    def make(api, config, device):
        fn = program(api, config, device)
        return lambda x: _flip(fn(x))

    return make


def half(program):
    def make(api, config, device):
        fn = program(api, config, device)

        def call(x):
            if isinstance(x, np.ndarray):
                out = fn(x)
                return out[: len(out) // 2]
            return fn(x[: len(x) // 2])

        return call

    return make


FAULTS = {"alter": alter, "half": half}
