"""Container framing: raw / zlib (RFC 1950) / gzip (RFC 1952).

The header and trailer writers (headers.py) and ContainerInflater, the
streaming container-aware inflater (inflate_container.py), whose header
parsers are the port's only ones; tpuzlib's containers package, copied.
"""

from .headers import (
    make_gzip_header,
    make_gzip_trailer,
    make_zlib_header,
    make_zlib_trailer,
)
from .inflate_container import ContainerInflater

__all__ = [
    "ContainerInflater",
    "make_gzip_header",
    "make_gzip_trailer",
    "make_zlib_header",
    "make_zlib_trailer",
]
