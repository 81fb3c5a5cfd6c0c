"""deflate_MBps.ckpt: deflate_MBps read per layer, in the cell whose
rate spreads too widely from run to run for an end-to-end bound (the
host thread paces it): MB (10^6 bytes) of input that the completed
deflate() calls of the traced run's window took, over the whole
window."""

from zbench import readers


def read(run):
    return readers.rate(run, "deflate", "in", 1e6)
