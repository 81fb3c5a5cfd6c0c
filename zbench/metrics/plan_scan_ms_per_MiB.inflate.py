"""plan_scan_ms_per_MiB.inflate: host ms of the port's inflate.plan.scan
stage (the full-stream header scan inside inflate.plan) per MiB of
output."""

from zbench import readers


def read(run):
    return readers.stage_ms_per_MiB(run, "inflate", "inflate.plan.scan", "out")
