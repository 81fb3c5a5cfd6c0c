"""idle_pct.deflate.ckpt: idle_pct.deflate in the one deflate cell whose
rate is read per layer (deflate_MBps.ckpt): the share of the traced
slice of deflate() calls in which no operation ran on the card."""

from zbench import readers


def read(run):
    return readers.idle_pct(run, "deflate")
