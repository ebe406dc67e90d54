"""On the card (``python -m pytest rfbench/tests -m card``): a short run of
each cell from the checkout is correct and prints its metrics."""

import json
import subprocess
import sys

import pytest

from rfbench import harness

M = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_short_run_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "rfbench/run.py", "--workload", cell, "--seed", "424242",
                        "--seconds", "2", "--trace", "1"], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    want = {m["name"] for m in harness.cell_metrics(M, cell, True)}
    assert want <= set(r["metrics"])
