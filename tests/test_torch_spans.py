"""The port's spans (``diag.timing.span``) on the CPU: nothing recorded with
no profiler running and nothing allocated on that path; under a profiler,
the tree each of ``Radio.process``, ``Monitor.process`` and
``BlockStream.run`` records, with block ids, parents and bytes; one parent
stack a thread; the clock against the profiler's; the spans in ``trace``'s
file; the cap.

    python -m pytest tests/test_torch_spans.py -q
"""

import contextlib
import gzip
import json
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from radioframe_torch.api.monitor import Monitor
from radioframe_torch.api.radio import Radio
from radioframe_torch.core import presets
from radioframe_torch.core import stream as stream_mod
from radioframe_torch.core.config import RxConfig
from radioframe_torch.core.stream import BlockStream, Stager
from radioframe_torch.diag import timing

T = 4096


@pytest.fixture(autouse=True)
def _empty_record():
    timing._recorder.clear()
    yield
    timing._recorder.clear()


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _iq(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _radio():
    r = Radio(RxConfig(channels=2), device="cpu")
    r.tune(0, 37_000.0)
    r.set_mode(1, "am")
    return r


def _tree(spans) -> set:
    """{(name, parent's name)} of ``spans``."""
    return {(s.name, s.parent.name if s.parent is not None else None) for s in spans}


def test_no_profiler_records_nothing():
    r = _radio()
    rng = np.random.default_rng(1)
    r.process(_iq(rng, (2, T)))
    r.process(_iq(rng, (2, T)))
    assert timing.recorded() == [] and timing.dropped() == 0


def test_off_path_is_one_object_and_allocates_nothing():
    assert timing.span("a") is timing.span("b", 64, root=True)
    assert not timing.span("a")

    def loop(n):
        for _ in range(n):
            with timing.span("stager.host_copy", 1 << 20) as sp:
                if sp:
                    sp.count = 1
            with timing.span("api.process", root=True):
                pass

    loop(10)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        loop(20_000)
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown == 0
    assert timing.recorded() == []


def test_radio_process_records_its_tree():
    r = _radio()
    rng = np.random.default_rng(2)
    x0, x1 = _iq(rng, (2, T)), _iq(rng, (2, T))
    blocks = [x0, x1, x0]  # the third call finds its buffers bound
    with _profile():
        for x in blocks:
            r.process(x)
    spans = timing.recorded()
    roots = [s for s in spans if s.name == "api.process"]
    assert len(roots) == 3 and all(s.parent is None for s in roots)
    ids = [s.block for s in roots]
    assert ids == sorted(ids) and len(set(ids)) == 3
    for root in roots:
        mine = [s for s in spans if s.block == root.block]
        assert all(s.thread == root.thread and s.end_ns >= s.start_ns for s in mine)
        assert all(root.start_ns <= s.start_ns and s.end_ns <= root.end_ns for s in mine)
    first, second, later = ([s for s in spans if s.block == b] for b in ids)
    steady = {("api.process", None), ("stager.host_copy", "api.process"),
              ("stager.take", "api.process"), ("compiled.call", "api.process"),
              ("compiled.bind", "compiled.call"), ("compiled.inputs", "compiled.call"),
              ("compiled.run", "compiled.call"), ("stager.to_host", "api.process")}
    assert _tree(later) == steady
    # a new signature, then a new buffer: each set up once
    assert _tree(first) == _tree(second) == steady | {("compiled.capture", "compiled.call")}
    cap = next(s for s in first if s.name == "compiled.capture")
    assert cap.count == r._compiled.signatures == 1
    assert [next(s for s in b if s.name == "compiled.bind").count
            for b in (first, second, later)] == [1, 2, 2]
    copy = next(s for s in later if s.name == "stager.host_copy")
    assert copy.nbytes == blocks[2].nbytes
    # on the CPU every input lies on the step's device: read in place
    bind = next(s for s in later if s.name == "compiled.bind")
    assert bind.nbytes == blocks[2].nbytes + 2 * 4 + 2 * 4  # the block, words, modes
    inputs = next(s for s in later if s.name == "compiled.inputs")
    assert inputs.count == 0 and inputs.nbytes == 0
    out = next(s for s in later if s.name == "stager.to_host")
    assert out.nbytes == 2 * (T // r.config.decim) * 4


def test_monitor_process_records_its_tree():
    m = Monitor(presets.channelizer_61m44(32, fs_in=32 * 15_000.0), device="cpu")
    m.set_mode_all("am")
    n = 16 * m.chain.min_block
    rng = np.random.default_rng(3)
    blocks = [_iq(rng, n) for _ in range(2)]
    m.process(blocks[0])
    with _profile():
        m.process(blocks[1])
    spans = timing.recorded()
    assert _tree(spans) == {("api.process", None), ("stager.host_copy", "api.process"),
                            ("stager.take", "api.process"), ("compiled.call", "api.process"),
                            ("compiled.bind", "compiled.call"),
                            ("compiled.inputs", "compiled.call"),
                            ("compiled.capture", "compiled.call"),
                            ("compiled.run", "compiled.call"), ("stager.to_host", "api.process")}
    assert len({s.block for s in spans}) == 1 and spans[0].block is not None
    assert next(s for s in spans if s.name == "stager.host_copy").nbytes == blocks[1].nbytes


def test_block_stream_records_blocks_and_source_waits():
    def step(state, x):
        return {"acc": state["acc"] + x.sum()}, 2 * x, x.mean()

    rng = np.random.default_rng(4)
    blocks = [rng.standard_normal(256).astype(np.float32) for _ in range(4)]
    bs = BlockStream(step, {"acc": torch.zeros(())}, device="cpu")
    with _profile():
        outs, _ = bs.run(iter(blocks))
    assert len(outs) == 4
    spans = timing.recorded()
    names = {s.name for s in spans}
    assert {"stream.block", "stream.source", "compiled.inputs", "compiled.run"} <= names
    roots = [s for s in spans if s.name == "stream.block"]
    assert len(roots) == 4 and [s.block for s in roots] == sorted({s.block for s in roots})
    # one wait before the first block, then one inside each block (the last finds the end)
    sources = [s for s in spans if s.name == "stream.source"]
    assert len(sources) == 5 and sources[0].parent is None
    assert all(s.parent.name == "stream.block" for s in sources[1:])
    runs = [s for s in spans if s.name == "compiled.run"]
    assert [s.block for s in runs] == [s.block for s in roots]
    assert all(s.parent.name == "compiled.call" for s in runs)


def test_threads_keep_their_own_parent_stacks():
    gate = threading.Barrier(2, timeout=30)
    errors = []

    def work(tag):
        try:
            with timing.span(f"{tag}.outer", root=True):
                gate.wait()  # both outer spans open at once
                with timing.span(f"{tag}.inner"):
                    gate.wait()
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    with _profile():
        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    by_name = {s.name: s for s in timing.recorded()}
    for tag in ("a", "b"):
        inner, outer = by_name[f"{tag}.inner"], by_name[f"{tag}.outer"]
        assert inner.parent is outer and inner.block == outer.block
        assert inner.thread == outer.thread
    assert by_name["a.outer"].thread != by_name["b.outer"].thread
    assert by_name["a.outer"].block != by_name["b.outer"].block


def test_span_and_record_function_share_the_clock():
    with _profile() as prof:
        with torch.profiler.record_function("warm"):
            pass
        with timing.span("probe") as sp, torch.profiler.record_function("probe.rf"):
            torch.ones(8).add_(1)
    ev = next(e for e in prof.profiler.kineto_results.events() if e.name() == "probe.rf")
    assert abs(ev.start_ns() - sp.start_ns) < 50_000
    assert abs(ev.end_ns() - sp.end_ns) < 50_000


class _Event:
    def record(self, stream=None):
        pass


def _staging_on_the_cpu(monkeypatch):
    """The page-locked branch of ``Stager`` with CPU tensors: the same
    calls, the pinning and the side stream left out."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k: empty(*a, **k))
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    allocs = iter(range(0, 100, 3))
    monkeypatch.setattr(stream_mod, "_host_allocs", lambda: next(allocs))
    st = Stager("cpu")
    st._stream = object()
    return st


def test_trace_writes_the_spans_beside_the_ops(tmp_path, monkeypatch):
    st = _staging_on_the_cpu(monkeypatch)
    block = _iq(np.random.default_rng(5), (4, 1 << 14))
    with timing.trace(str(tmp_path), device="cpu"):
        with timing.span("api.process", root=True):
            out, _ = st.stage(block)
    np.testing.assert_array_equal(out.numpy(), block)
    pin = next(s for s in timing.recorded() if s.name == "stager.pin")
    assert pin.count == 3  # the counter read across the allocation
    files = list(tmp_path.glob("plugins/profile/*/*.trace.json.gz"))
    assert len(files) == 1
    with gzip.open(files[0], "rt") as f:
        events = json.load(f)["traceEvents"]
    lane = [e for e in events if e.get("pid") == "radioframe"]
    assert any(e.get("ph") == "M" and e["args"].get("name") == "radioframe" for e in lane)
    spans = {e["name"]: e for e in lane if e.get("ph") == "X"}
    assert set(spans) == {"api.process", "stager.pin", "stager.host_copy", "stager.h2d"}
    copy = spans["stager.host_copy"]
    assert copy["args"]["nbytes"] == block.nbytes and copy["args"]["parent"] == "api.process"
    assert spans["stager.pin"]["args"]["count"] == 3
    ops = [e for e in events if e.get("name") == "aten::copy_" and e.get("ph") == "X"]

    def inside(e, s):
        return s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]

    assert any(inside(e, copy) for e in ops)
    assert any(inside(e, spans["stager.h2d"]) for e in ops)


def test_trace_defaults_under_the_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    with timing.trace(device="cpu") as d:
        torch.ones(2) + 1
    assert d == str(tmp_path / "radioframe_trace")
    assert list((tmp_path / "radioframe_trace").glob("plugins/profile/*/*.trace.json.gz"))


def test_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(timing._recorder, "cap", 3)
    with _profile():
        for i in range(5):
            with timing.span(f"s{i}"):
                pass
    assert [s.name for s in timing.recorded()] == ["s0", "s1", "s2"]
    assert timing.dropped() == 2


def test_notes_reach_the_run_span_and_the_trace_file(tmp_path):
    """What the step notes while ``CompiledStep`` runs it (``RxChain``: the
    back end it runs, ``back_path``) is the ``compiled.run`` span's
    ``attrs`` and lands in the trace file's args; a note outside any
    ``noting`` block is dropped."""
    timing.note(back_path="nowhere")
    with timing.noting() as outer:
        with timing.noting() as inner:
            timing.note(a=1)
        timing.note(b=2)
    assert inner == {"a": 1} and outer == {"b": 2}
    r = _radio()
    with timing.trace(str(tmp_path), device="cpu"):
        r.process(_iq(np.random.default_rng(6), (2, T)))
    run = next(s for s in timing.recorded() if s.name == "compiled.run")
    assert run.attrs == {"back_path": r.chain.back_path}
    assert r.chain.back_path.startswith("composed:")
    (path,) = tmp_path.glob("plugins/profile/*/*.trace.json.gz")
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    (written,) = [e for e in events if e.get("pid") == "radioframe" and e["name"] == "compiled.run"]
    assert written["args"]["back_path"] == r.chain.back_path
