"""join_ms_per_MiB.deflate.ckpt: join_ms_per_MiB.deflate in the one
deflate cell whose rate is read per layer (deflate_MBps.ckpt): host ms
of the port's deflate.join stage (the host bit join and its final flush)
per MiB of input."""

from zbench import readers


def read(run):
    return readers.stage_ms_per_MiB(run, "deflate", "deflate.join", "in")
