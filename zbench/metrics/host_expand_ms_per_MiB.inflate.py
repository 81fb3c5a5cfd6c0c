"""host_expand_ms_per_MiB.inflate: host ms of the port's
inflate.host_expand stage (pass 3 on the host) per MiB of output."""

from zbench import readers


def read(run):
    return readers.stage_ms_per_MiB(run, "inflate", "inflate.host_expand", "out")
