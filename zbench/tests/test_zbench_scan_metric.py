"""scan_card_pct.inflate reads the share of the header scan's stream bytes
that the card scanned from a fabricated run, and nothing from a run of a
program without the scan counters, of another entry point, or with no
call."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from zbench import harness  # noqa: E402

MiB = 1 << 20
READ = harness.load_module(os.path.join(ROOT, "zbench", "metrics",
                                        "scan_card_pct.inflate.py")).read


def run(counters, entry="inflate", calls=2):
    each = [harness.Call(0.0, 1.0, 12 * MiB, 32 * MiB) for _ in range(calls)]
    return harness.Run(entry, "cpu", 1.0, 2.0, each, {}, counters, {}, None)


@pytest.mark.parametrize("card,host,value", [(3 * MiB, 0, 100.0), (3 * MiB, MiB, 75.0),
                                             (0, 2 * MiB, 0.0)])
def test_scan_card_pct_reads_the_counters(card, host, value):
    counters = {"inflate.scan_card": card, "inflate.scan_host": host, "inflate.device": 64 * MiB}
    assert READ(run({k: v for k, v in counters.items() if v})) == pytest.approx(value, rel=1e-12)


def test_scan_card_pct_reads_nothing_without_the_counters():
    assert READ(run({"inflate.device": 64 * MiB, "inflate.plan_blocks": 400})) is None
    assert READ(run({"inflate.scan_card": MiB}, entry="deflate")) is None
    assert READ(run({"inflate.scan_card": MiB}, calls=0)) is None
