"""d2h_bytes_per_byte.deflate.ckpt: d2h_bytes_per_byte.deflate in the
one deflate cell whose rate is read per layer (deflate_MBps.ckpt): bytes
copied from the card to the host (the port's copy.d2h_bytes counter) per
input byte of deflate(); none from a program without the counter."""

from zbench import readers


def read(run):
    share = readers.counter_pct(run, "deflate", "copy.d2h_bytes", "in")
    return None if share is None or "copy.d2h_bytes" not in run.counters else share / 100
