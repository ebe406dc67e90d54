"""The harness finds every configuration, cell, entry and metric by the name
BENCHMARK.json gives it: adding one is adding files and entries."""

import pytest

from rfbench import harness

M = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in M["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_names_its_config_and_entry(cell):
    spec = harness.load_cell(cell)
    w = next(w for w in M["workloads"] if w["name"] == cell)
    assert spec["config"] == w["config"] and spec["chips"] == w["chips"]
    cfg = harness.module("configs", spec["config"])
    for fn in ("samples_per_block", "layout", "block", "build_api", "build_stream",
               "api_outputs", "stream_outputs", "reference", "reference_lead_blocks",
               "modes", "nfm_period"):
        assert callable(getattr(cfg, fn)), fn
    assert callable(harness.module("drivers", spec["entry"]).run)
    assert set(spec["check"]["limits"]) == {name for name, _ in cfg.CHECKS.values()}


@pytest.mark.parametrize("config", [c["name"] for c in M["configs"]])
def test_config_file_is_the_manifest_file(config):
    c = next(c for c in M["configs"] if c["name"] == config)
    assert c["file"] == f"rfbench/configs/{config}.json"
    sizes = harness.load_sizes(config)
    assert sizes["name"] == config and sizes["reduced"] == c["reduced"]
    assert sizes["source"] == c["source"]
    for k in c["reduced"]:
        assert k in sizes and k in sizes["source_values"]


@pytest.mark.parametrize("metric", [m["name"] for m in M["end_to_end"] + M["per_layer"]])
def test_every_metric_has_its_reader(metric):
    assert callable(harness.reader(metric).read)


def test_a_split_metric_is_read_by_its_prefix():
    assert (harness.reader("input_msps.channelizer_4096.device")
            is harness.module("metrics", "input_msps"))
    assert harness.reader("k5_roofline.host") is harness.module("metrics", "k5_roofline")


def test_cell_metrics_follow_the_manifest():
    names = lambda cell, tr: {m["name"] for m in harness.cell_metrics(M, cell, tr)}  # noqa: E731
    assert names("flagship_rx.host", False) == {"input_msps.host", "block_ms_p99", "setup_s"}
    assert names("channelizer_4096.device", False) == {"input_msps.channelizer_4096.device",
                                                       "setup_s"}
    assert "k5_roofline.channelizer_4096.device" in names("channelizer_4096.device", True)
    assert "k5_roofline.host" in names("channelizer_4096.host", True)
    assert not any(n.startswith("k1_roofline") for n in names("channelizer_4096.device", True))
    assert "stage_in_ms" in names("channelizer_4096.host", True)


def test_a_new_metric_entry_needs_no_harness_edit():
    """A per-layer metric without ``workloads`` is reported wherever its
    ``moves`` is: a later cell picks it up from the manifest alone."""
    extra = dict(M, per_layer=M["per_layer"] + [
        {"name": "setup_s", "unit": "s", "better": "lower", "source": "host_clock",
         "layer": "device: the H100", "moves": "block_ms_p99"}])
    got = {m["name"] for m in harness.cell_metrics(extra, "channelizer_4096.host", True)}
    assert "setup_s" in got
    got = {m["name"] for m in harness.cell_metrics(extra, "channelizer_4096.device", True)}
    assert "setup_s" not in got
