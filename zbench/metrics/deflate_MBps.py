"""deflate_MBps: MB (10^6 bytes) of input that the completed
deflate() calls took, over the whole window."""

from zbench import readers


def read(run):
    return readers.rate(run, "deflate", "in", 1e6)
