"""The readers of the program's spans on a planted run: made-up spans of
``radioframe_torch.diag.timing`` and device events on one clock, some
outside the profiled sub-window; each reader gives the planted number, and
nothing without a trace, without spans inside the sub-window, or from a
program that records none."""

import sys
import types
from types import SimpleNamespace

import pytest

from rfbench import harness
from rfbench.metrics import (pin_copy_gbps, pinned_allocs, replay_ms, stage_out_wait_ms,
                             step_inputs_ms)
from rfbench.trace import DeviceTrace, Event

READERS = [pin_copy_gbps, pinned_allocs, replay_ms, stage_out_wait_ms, step_inputs_ms]
US = 1_000  # ns
T0 = 1_700_000_000_000_000_000  # the profiler's clock is the wall clock's


def _span(name, a_us, b_us, nbytes=0, count=None):
    return SimpleNamespace(name=name, start_ns=T0 + a_us * US, end_ns=T0 + b_us * US,
                           nbytes=nbytes, count=count)


def _trace(blocks=2):
    tr = DeviceTrace(10.0, blocks)
    tr.first_kept_ns, tr.end_ns, tr.block_count = T0 + 1_000 * US, T0 + 3_000 * US, blocks
    tr.events = [
        Event("rfbench.kept", tr.first_kept_ns, tr.first_kept_ns, False),
        Event("Memcpy HtoD (Pinned -> Device)", T0 + 1_100 * US, T0 + 1_400 * US, True),
        Event("Memcpy DtoH (Device -> Pinned)", T0 + 1_900 * US, T0 + 1_950 * US, True),
        Event("Memcpy DtoH (Device -> Pinned)", T0 + 2_900 * US, T0 + 2_960 * US, True),
        Event("Memcpy DtoH (Device -> Pinned)", T0 + 2_970 * US, T0 + 2_980 * US, True),
    ]
    return tr


# two blocks in [1000, 3000) us; the spans before and after lie outside it
PLANTED = [
    _span("stager.pin", 900, 950, count=5),             # outside
    _span("stager.host_copy", 950, 1_050, 10**9),         # straddles the start
    _span("stager.pin", 1_000, 1_010, count=0),
    _span("stager.host_copy", 1_010, 1_110, 2 * 10**6),  # 2 MB in 100 us: 20 GB/s
    _span("compiled.inputs", 1_120, 1_150, 16),
    _span("compiled.replay", 1_150, 1_250),
    _span("stager.to_host", 1_300, 1_960, 4096),         # its copy starts at 1900
    _span("stager.pin", 2_000, 2_010, count=2),
    _span("stager.host_copy", 2_010, 2_060, 10**6),      # 1 MB in 50 us
    _span("compiled.inputs", 2_100, 2_110, 16),
    _span("compiled.replay", 2_110, 2_160),
    _span("stager.to_host", 2_800, 2_990, 4096),         # its first copy starts at 2900
    _span("compiled.replay", 2_990, 3_100),              # straddles the end
    _span("compiled.replay", 3_200, 3_300),              # outside
]


@pytest.fixture
def planted(monkeypatch):
    from radioframe_torch.diag import timing

    monkeypatch.setattr(timing, "recorded", lambda: list(PLANTED))
    return harness.Run(trace=_trace(), blocks=7)


def test_readers_give_the_planted_numbers(planted):
    assert pin_copy_gbps.read(planted) == pytest.approx(3e6 / 150e3)  # bytes a ns: GB/s
    assert pinned_allocs.read(planted) == 2.0
    assert stage_out_wait_ms.read(planted) == pytest.approx((0.600 + 0.100) / 2)
    assert step_inputs_ms.read(planted) == pytest.approx((0.030 + 0.010) / 2)
    assert replay_ms.read(planted) == pytest.approx((0.100 + 0.050) / 2)


def test_split_names_are_read_by_the_new_readers():
    assert harness.reader("replay_ms.flagship_rx.device") is replay_ms
    assert harness.reader("replay_ms.channelizer_4096.device") is replay_ms
    assert harness.reader("step_inputs_ms.host") is step_inputs_ms


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.rsplit(".", 1)[-1])
def test_no_trace_gives_nothing(reader, monkeypatch):
    from radioframe_torch.diag import timing

    monkeypatch.setattr(timing, "recorded", lambda: list(PLANTED))
    assert reader.read(harness.Run()) is None
    assert reader.read(harness.Run(trace=DeviceTrace(10.0, 2, enabled=False))) is None


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.rsplit(".", 1)[-1])
def test_spans_outside_the_sub_window_give_nothing(reader, monkeypatch):
    from radioframe_torch.diag import timing

    tr = _trace()
    outside = [s for s in PLANTED if s.start_ns < tr.first_kept_ns or s.end_ns > tr.end_ns]
    assert len(outside) == 4
    monkeypatch.setattr(timing, "recorded", lambda: list(outside))
    assert reader.read(harness.Run(trace=tr)) is None


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.rsplit(".", 1)[-1])
def test_a_program_without_spans_gives_nothing(reader, monkeypatch):
    monkeypatch.setitem(sys.modules, "radioframe_torch.diag.timing",
                        types.ModuleType("radioframe_torch.diag.timing"))
    assert reader.read(harness.Run(trace=_trace())) is None


def test_a_to_host_without_its_copy_gives_nothing(monkeypatch):
    from radioframe_torch.diag import timing

    monkeypatch.setattr(timing, "recorded", lambda: [_span("stager.to_host", 1_300, 1_800)])
    assert stage_out_wait_ms.read(harness.Run(trace=_trace())) is None
