"""crc32_GBps: GB (10^9 bytes) that completed crc32() calls checksummed on
the card, over the whole window."""

from zbench import readers


def read(run):
    return readers.rate(run, "crc32", "in", 1e9)
