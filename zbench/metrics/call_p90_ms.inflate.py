"""call_p90_ms.inflate: the 90th percentile of the host time of an
inflate() call, over the calls of the window."""

from zbench import readers


def read(run):
    return readers.latency_ms(run, "inflate", 90)
