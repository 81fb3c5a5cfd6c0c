"""launch_us_per_call.crc32: host us of the port's crc32.launch stage
(the checks and the launch of the kernel) per crc32() call of the
window."""


def read(run):
    if run.entry != "crc32" or not run.calls or "crc32.launch" not in run.stages:
        return None
    return run.stages["crc32.launch"]["seconds"] * 1e6 / len(run.calls)
