"""The traced run's reductions on a hand-made timeline: busy time as the
union of device activities, idle gaps named by the host span open in them,
the device operations by time, and the per-layer readers that take them."""

import pytest

from rfbench import harness
from rfbench.metrics import device_idle_pct, h2d_ms, step_device_ms
from rfbench.trace import DeviceTrace, Event


def _trace():
    tr = DeviceTrace(10.0, 2)
    tr.first_kept_ns, tr.end_ns, tr.block_count = 0, 100_000, 2
    tr.events = [
        Event("rfbench.stage_in", 0, 30_000, False),
        Event("aten::copy_", 5_000, 25_000, False),
        Event("rfbench.step_call", 30_000, 60_000, False),
        Event("Memcpy HtoD (Pinned -> Device)", 10_000, 40_000, True),
        Event("void fused_frontend2_kernel<float, 8, 4>(Args)", 35_000, 50_000, True),
        Event("Memcpy DtoD (Device -> Device)", 50_000, 55_000, True),
        Event("rfbench.stage_out", 60_000, 100_000, False),
        Event("cudaStreamSynchronize", 62_000, 92_000, False),
        Event("Memcpy DtoH (Device -> Pinned)", 80_000, 90_000, True),
    ]
    return tr


def test_busy_is_the_union():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s() == pytest.approx(55e-6)  # [10, 55) + [80, 90) us


def test_idle_gaps_by_host_span():
    got = dict(_trace().idle_gaps())
    assert got["stage_in/aten::copy_"] == pytest.approx(10e-6)
    assert got["stage_out/cudaStreamSynchronize"] == pytest.approx(25e-6)
    assert got["stage_out"] == pytest.approx(10e-6)
    assert sum(got.values()) == pytest.approx(45e-6)


def test_device_ops_by_time():
    ops = _trace().device_ops()
    assert ops[0] == ["Memcpy HtoD (Pinned -> Device)", pytest.approx(30e-6)]
    assert ops[1][0].startswith("fused_frontend2_kernel")


def test_layer_readers():
    run = harness.Run(trace=_trace(), blocks=2)
    assert step_device_ms.read(run) == pytest.approx(1e3 * 20e-6 / 2)  # kernel + DtoD
    assert h2d_ms.read(run) == pytest.approx(1e3 * 30e-6 / 2)
    assert device_idle_pct.read(run) == pytest.approx(45.0)


def test_readers_without_a_trace_return_nothing():
    run = harness.Run()
    assert step_device_ms.read(run) is None and device_idle_pct.read(run) is None
