"""plan_us_per_block.inflate: host us of inflate.plan's self_seconds (as
plan_loop_ms_per_MiB.inflate reads them) per block the plan found (the
port's inflate.plan_blocks counter); none from a program without the
counter."""


def read(run):
    plan = run.stages.get("inflate.plan", {})
    blocks = run.counters.get("inflate.plan_blocks", 0)
    if run.entry != "inflate" or not run.calls or "self_seconds" not in plan or not blocks:
        return None
    return plan["self_seconds"] * 1e6 / blocks
