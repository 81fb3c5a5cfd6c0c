"""idle_pct.crc32: the share of the traced slice of crc32() calls in which no
operation ran on the card."""

from zbench import readers


def read(run):
    return readers.idle_pct(run, "crc32")
