"""match_ms_per_MiB.deflate.ckpt: match_ms_per_MiB.deflate in the one
deflate cell whose rate is read per layer (deflate_MBps.ckpt): host ms
of the port's deflate.encode.match stage (the encoder's batch layout and
match search, enqueued) per MiB of input."""

from zbench import readers


def read(run):
    return readers.stage_ms_per_MiB(run, "deflate", "deflate.encode.match", "in")
