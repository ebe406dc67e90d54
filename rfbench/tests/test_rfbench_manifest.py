"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, and every cell's metrics."""

import json
import re

import pytest

from rfbench import harness

M = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["command"]) <= 32 and all(TEXT.match(w) for w in M["command"])
    assert M["paths"] == ["rfbench"]


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_texts():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in M[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in M["configs"])) == len(M["configs"])
    assert len(set(CELLS)) == len(CELLS)
    metric_names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for c in M["configs"]:
        assert TEXT.match(c["why"]) and TEXT.match(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("rfbench/") and (harness.ROOT / c["file"]).is_file()
    for w in M["workloads"]:
        assert TEXT.match(w["why"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["per_layer"]:
        assert TEXT.match(m["layer"])


def test_sources_and_bounds():
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_config_used_and_pairs_unique():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_and_a_layer(cell):
    e2e = {m["name"] for m in harness.cell_metrics(M, cell, False)}
    layer = harness.cell_metrics(M, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, not reported in {cell}"


@pytest.mark.parametrize("metric", M["per_layer"] + M["end_to_end"], ids=lambda m: m["name"])
def test_metric_workloads_name_cells(metric):
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


def test_one_layer_name_a_layer():
    by_layer = {}
    for m in M["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_roofline_metrics_are_percent():
    for m in M["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_manifest_is_plain_json():
    json.loads((harness.ROOT / "BENCHMARK.json").read_text())
