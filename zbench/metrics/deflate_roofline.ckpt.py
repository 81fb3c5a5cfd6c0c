"""deflate_roofline.ckpt: deflate_roofline in the one deflate cell whose
rate is read per layer (deflate_MBps.ckpt): the least time the card
needs for the traced deflate() calls' bytes in and out at its peak
memory rate, over the time an operation (any kernel, copy or memset,
aten's included) ran on the card."""

from zbench import readers


def read(run):
    return readers.roofline_pct(run, "deflate")
