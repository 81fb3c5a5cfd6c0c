"""h2d_bytes_per_byte.inflate: bytes copied from the host to the card by
inflate() (the port's copy.h2d_bytes counter: every device-route attempt,
declined ones included) per byte the device route returned (the
inflate.device counter).  Streams the host engine decodes add no byte
below the line, so a decline the device route stops making lowers it.
None from a program without the counter, or from a window in which the
device route returned nothing."""


def read(run):
    if run.entry != "inflate" or not run.calls or "copy.h2d_bytes" not in run.counters:
        return None
    out = run.counters.get("inflate.device", 0)
    return run.counters["copy.h2d_bytes"] / out if out else None
