"""flush_ms_per_MiB.deflate.ckpt: flush_ms_per_MiB.deflate in the one
deflate cell whose rate is read per layer (deflate_MBps.ckpt): host ms
of the port's deflate.flush stage (the bit sink's final flush, inside
the last deflate.join) per MiB of input."""

from zbench import readers


def read(run):
    return readers.stage_ms_per_MiB(run, "deflate", "deflate.flush", "in")
