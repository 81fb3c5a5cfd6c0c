"""parse_ms_per_MiB.deflate.ckpt: parse_ms_per_MiB.deflate in the one
deflate cell whose rate is read per layer (deflate_MBps.ckpt): host ms
of the port's deflate.encode.parse stage (the lazy rule, the segment
parse and the token compaction, enqueued) per MiB of input."""

from zbench import readers


def read(run):
    return readers.stage_ms_per_MiB(run, "deflate", "deflate.encode.parse", "in")
