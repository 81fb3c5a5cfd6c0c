"""call_p90_ms.deflate.ckpt: call_p90_ms.deflate in the one deflate cell
whose rate is read per layer (deflate_MBps.ckpt): the 90th percentile of
the host time of a deflate() call, over the calls of the window."""

from zbench import readers


def read(run):
    return readers.latency_ms(run, "deflate", 90)
