"""idle_pct.inflate: the share of the traced slice of inflate() calls in which no
operation ran on the card."""

from zbench import readers


def read(run):
    return readers.idle_pct(run, "inflate")
