"""Runs of both entries at small sizes on the CPU print the contract's last
line; ``run.py`` itself refuses to run without a card, or without the
program beside it."""

import json
import shutil
import subprocess
import sys

import pytest

from rfbench import harness
from rfbench.tests.tiny import run_tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", ["flagship_rx.host", "channelizer_4096.device"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_prints_the_contracts_line(cell, trace):
    r = run_tiny(cell, seconds=0.2, trace=trace)
    line = json.dumps(harness._plain(r), allow_nan=False)
    back = json.loads(line)
    assert KEYS <= set(back) and list(back)[-1] == "checks"
    assert set(back["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in back["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for c in back["checks"].values():
        assert set(c) == {"value", "limit"}
    want = {m["name"] for m in harness.cell_metrics(
        harness.load_json(harness.ROOT / "BENCHMARK.json"), cell, trace)}
    device_only = {"step_device_ms", "k1_roofline", "k5_roofline", "device_idle_pct", "h2d_ms"}
    assert set(back["metrics"]) == {n for n in want if n.split(".")[0] not in device_only}


def _run(cwd, *args):
    return subprocess.run([sys.executable, "rfbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(harness.ROOT, "--workload", "flagship_rx.host", "--seed", "1", "--seconds", "1",
             "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_alone_prints_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "rfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, "--workload", "flagship_rx.host", "--seed", "1", "--seconds", "1",
             "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
