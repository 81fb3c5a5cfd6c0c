"""plan_ms_per_MiB.inflate: host ms of the port's inflate.plan stage (the
block plan and cursor layout) per MiB of output."""

from zbench import readers


def read(run):
    return readers.stage_ms_per_MiB(run, "inflate", "inflate.plan", "out")
