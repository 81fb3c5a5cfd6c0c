"""device_route_pct.inflate: the bytes the device route gave (the port's
inflate.device counter) over all bytes inflate() returned; a fallback to
the host engine lowers it."""

from zbench import readers


def read(run):
    return readers.counter_pct(run, "inflate", "inflate.device", "out")
