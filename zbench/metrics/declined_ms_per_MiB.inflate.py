"""declined_ms_per_MiB.inflate: host ms of the port's inflate.declined
stage (device-route attempts that ended on the host engine) per MiB of
output; 0 where the window declined nothing, none from a program
without the inflate.call stage, which has no inflate.declined either."""

from zbench import readers


def read(run):
    if "inflate.call" not in run.stages:
        return None
    if "inflate.declined" not in run.stages:
        return 0.0 if run.entry == "inflate" and run.calls else None
    return readers.stage_ms_per_MiB(run, "inflate", "inflate.declined", "out")
