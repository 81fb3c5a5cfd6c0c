"""trees_ms_per_MiB.deflate.ckpt: trees_ms_per_MiB.deflate in the one
deflate cell whose rate is read per layer (deflate_MBps.ckpt): host ms
of the port's deflate.encode.trees stage (histograms, package-merge
trees, canonical codes and the dynamic header, enqueued) per MiB of
input."""

from zbench import readers


def read(run):
    return readers.stage_ms_per_MiB(run, "deflate", "deflate.encode.trees", "in")
