"""inflate_MBps: MB (10^6 bytes) of output of the completed
inflate() calls, over the whole window."""

from zbench import readers


def read(run):
    return readers.rate(run, "inflate", "out", 1e6)
