"""call_p99_ms.crc32: the 99th percentile of the host time of a crc32()
call on a card-resident record, the int read back included."""

from zbench import readers


def read(run):
    return readers.latency_ms(run, "crc32", 99)
