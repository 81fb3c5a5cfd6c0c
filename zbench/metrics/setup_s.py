"""setup_s: seconds from the start of the process to the start of the
measured window: imports, the kernel libraries loaded (built on a first
run), the inputs made and every shape warmed."""


def read(run):
    return run.setup_s
