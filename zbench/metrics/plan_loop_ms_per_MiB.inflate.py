"""plan_loop_ms_per_MiB.inflate: host ms of the port's inflate.plan stage
less the stages opened inside it (its self_seconds: the python loop over
the block headers and the cursor layout, without the inflate.plan.scan
header scan) per MiB of output; none from a program whose stages carry
no self_seconds."""

from zbench import readers


def read(run):
    plan = run.stages.get("inflate.plan", {})
    if run.entry != "inflate" or not run.calls or "self_seconds" not in plan:
        return None
    return plan["self_seconds"] * 1e3 / (sum(c.nout for c in run.calls) / readers.MiB)
