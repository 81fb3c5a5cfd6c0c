"""size_ratio: the bytes deflate() wrote for the piece over the
bytes zlib writes for it at the same level, window, memLevel and
container (each piece once: the encoder gives every call the same size)."""


def read(run):
    s = run.sizes
    if run.entry != "deflate" or not s.get("zlib_bytes"):
        return None
    return s["port_bytes"] / s["zlib_bytes"]
