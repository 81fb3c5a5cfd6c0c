"""The benchmark of tpuzlib_torch on one NVIDIA H100: BENCHMARK.json's harness.

    python3 zbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix, one entry
point or one metric lives in a file of its own, found by the name that
BENCHMARK.json gives it: configs/<config>.json, traffic/<traffic>.json,
entries/<entry>.py and metrics/<metric>.py.  Nothing here imports jax or
tpuzlib; the plain reference (reference/) imports no part of the port.
"""
