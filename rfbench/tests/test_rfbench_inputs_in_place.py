"""The reader of ``inputs_in_place`` on a planted run (the spans and
sub-window of ``test_rfbench_spans``): the planted share, and nothing
without a trace, without spans inside the sub-window, or from a program
that records no ``compiled.bind``."""

import sys
import types

import pytest

from rfbench import harness
from rfbench.metrics import inputs_in_place
from rfbench.tests.test_rfbench_spans import PLANTED, _span, _trace

BOUND = [
    _span("compiled.bind", 800, 810, 10**9),          # outside
    _span("compiled.bind", 1_110, 1_120, 4_000, count=4),
    _span("compiled.bind", 2_090, 2_100, 4_000, count=4),
    _span("compiled.bind", 3_150, 3_160, 10**9),      # outside
]


def _planted(monkeypatch, spans):
    from radioframe_torch.diag import timing

    monkeypatch.setattr(timing, "recorded", lambda: list(spans))
    return harness.Run(trace=_trace(), blocks=7)


def test_reader_gives_the_planted_share(monkeypatch):
    run = _planted(monkeypatch, PLANTED + BOUND)
    # 8000 bytes read in place, 2 x 16 copied (PLANTED's compiled.inputs)
    assert inputs_in_place.read(run) == pytest.approx(100.0 * 8_000 / 8_032)


def test_split_names_are_read_by_the_reader():
    for name in ("inputs_in_place.host", "inputs_in_place.channelizer_4096.device",
                 "inputs_in_place.flagship_rx.device"):
        assert harness.reader(name) is inputs_in_place


def test_nothing_without_the_bind_span(monkeypatch):
    assert inputs_in_place.read(_planted(monkeypatch, PLANTED)) is None  # a parent program


def test_nothing_without_a_trace(monkeypatch):
    _planted(monkeypatch, PLANTED + BOUND)
    assert inputs_in_place.read(harness.Run(trace=None, blocks=7)) is None


def test_nothing_outside_the_sub_window(monkeypatch):
    run = _planted(monkeypatch, [s for s in BOUND if s.start_ns < _trace().first_kept_ns])
    assert inputs_in_place.read(run) is None


def test_a_program_without_spans_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "radioframe_torch.diag.timing",
                        types.ModuleType("radioframe_torch.diag.timing"))
    run = harness.Run(trace=_trace(), blocks=7)
    assert inputs_in_place.read(run) is None
