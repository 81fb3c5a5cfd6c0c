"""h2d_bytes_per_byte.deflate.ckpt: h2d_bytes_per_byte.deflate in the
one deflate cell whose rate is read per layer (deflate_MBps.ckpt): bytes
copied from the host to the card (the port's copy.h2d_bytes counter) per
input byte of deflate(); none from a program without the counter."""

from zbench import readers


def read(run):
    share = readers.counter_pct(run, "deflate", "copy.h2d_bytes", "in")
    return None if share is None or "copy.h2d_bytes" not in run.counters else share / 100
