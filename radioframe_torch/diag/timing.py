"""Per-stage timing and profiler traces (counterpart of
``radioframe/diag/timing.py``).

On a CUDA device a stage is timed by a pair of CUDA events on the current
stream, read when the report is made; on the CPU by the host clock.
``sync_value`` waits for everything a tensor depends on. ``trace`` records
a torch.profiler trace and writes it where the reference's trace context
writes its own, in the same format.

``span`` marks the port's layer boundaries (``api.process``,
``stager.host_copy``, ``compiled.replay``, ...). While a torch profiler
runs in the process (``trace``, or any ``torch.profiler.profile``) each
span is kept in memory as a ``Span``: its name, its start and end on the
clock the profiler stamps its events with (``time.time_ns``), its parent,
thread and block, the bytes or the count it carries, and the CUDA stream it
enqueued work on; ``recorded()`` returns them and ``trace`` writes them into
its file. With no profiler running a span is one shared object that records
nothing.

``note`` hands attributes of the work under way (``RxChain.step_back``: the
back end it runs) to the ``noting`` block open on the thread, if any;
``CompiledStep`` opens one around each capture and sets what was noted as
the ``attrs`` of its ``compiled.capture`` and ``compiled.replay`` spans.
"""

from __future__ import annotations

import contextlib
import gzip
import itertools
import json
import os
import socket
import tempfile
import threading
import time

import torch
import torch.autograd.profiler as _profiler

from radioframe_torch.device import resolve


def sync_value(x: torch.Tensor) -> float:
    """Force everything ``x`` depends on to finish; returns sum(|x|) as a
    float (reading it back waits for the device)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(torch.sum(torch.abs(x).to(torch.float32)))


class StageTimer:
    """Accumulates per-stage times across repeated blocks on ``device``."""

    def __init__(self, device):
        self.device = resolve(device)
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._pending: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    def _add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        """Time the body; with ``sync_on`` (a tensor), the stage also waits
        for it before it ends."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            if sync_on is not None:
                sync_value(sync_on)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((name, start, end))
        else:
            t0 = time.perf_counter()
            yield
            if sync_on is not None:
                sync_value(sync_on)
            self._add(name, time.perf_counter() - t0)

    def _collect(self) -> None:
        for name, start, end in self._pending:
            end.synchronize()
            self._add(name, start.elapsed_time(end) * 1e-3)
        self._pending.clear()

    def report(self) -> str:
        self._collect()
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<24s} {tot*1e3:9.2f} ms total  {tot/n*1e3:8.3f} ms/call  x{n}")
        return "\n".join(lines)


# -- program spans -----------------------------------------------------------------


def _clock_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, read once: spans are
    stamped with the fine counter on the profiler's wall clock."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    return wall - (a + time.perf_counter_ns()) // 2


_OFFSET_NS = _clock_offset_ns()


class Span:
    """One recorded span. ``start_ns`` and ``end_ns`` are on the
    ``time.time_ns`` clock (``end_ns`` is None while it is open);
    ``parent`` is the span open on the same thread when it opened;
    ``block`` the id its root span drew (``api.process``,
    ``stream.block``), None outside one; ``nbytes`` the bytes it moved;
    ``count`` a counter read across it; ``stream`` the CUDA stream it
    enqueued work on (``stream_id``), where the span sets it; ``attrs`` a
    dict of what the work noted (``note``), where the span sets it."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "block", "nbytes", "count",
                 "stream", "attrs", "_stack")

    def __init__(self, name: str, nbytes: int, parent: Span | None, block, stack: list):
        self.name, self.nbytes, self.parent, self.block = name, nbytes, parent, block
        self.thread = threading.get_ident()
        self.start_ns = self.end_ns = self.count = self.stream = self.attrs = None
        self._stack = stack

    def __enter__(self) -> Span:
        self._stack.append(self)
        self.start_ns = time.perf_counter_ns() + _OFFSET_NS
        return self

    def __exit__(self, typ, val, tb) -> None:
        self.end_ns = time.perf_counter_ns() + _OFFSET_NS
        self._stack.pop()


class _Off:
    """The span while no profiler runs: one shared object, no record."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, typ, val, tb) -> None:
        return None


_OFF = _Off()


class _Recorder:
    """The spans of the process, about ``cap`` at most (``dropped`` counts
    the rest; a thread that races another to the last place may add one),
    a stack of open spans for each thread, and the block ids."""

    def __init__(self, cap: int = 1 << 20):
        self.cap = cap
        self.spans: list[Span] = []
        self.dropped = 0
        self._lock = threading.Lock()  # for ``dropped``
        self._local = threading.local()
        self._blocks = itertools.count()

    def open(self, name: str, nbytes: int, root: bool) -> Span:
        try:
            stack = self._local.stack
        except AttributeError:
            stack = self._local.stack = []
        parent = stack[-1] if stack else None
        if root:
            block = next(self._blocks)
        else:
            block = parent.block if parent is not None else None
        sp = Span(name, nbytes, parent, block, stack)
        if len(self.spans) < self.cap:
            self.spans.append(sp)  # one bytecode: atomic under the interpreter lock
        else:
            with self._lock:
                self.dropped += 1
        return sp

    def clear(self) -> None:
        with self._lock:
            self.spans = []
            self.dropped = 0


_recorder = _Recorder()


def span(name: str, nbytes: int = 0, *, root: bool = False):
    """A context manager around one piece of the port's work. While a torch
    profiler runs it records a ``Span`` (and yields it, so the caller can
    set ``count``, ``nbytes`` or ``stream``); otherwise it yields a shared object that
    is false and records nothing. ``root`` starts a new block id."""
    if not _profiler._is_profiler_enabled:  # torch's process-wide flag, on every thread
        return _OFF
    return _recorder.open(name, nbytes, root)


_noted = threading.local()  # ``attrs``: the dict of the ``noting`` block open on this thread


@contextlib.contextmanager
def noting():
    """Collect what the body ``note``s on this thread: yields the dict."""
    outer = getattr(_noted, "attrs", None)
    _noted.attrs = attrs = {}
    try:
        yield attrs
    finally:
        _noted.attrs = outer


def note(**attrs) -> None:
    """Attributes of the work under way, kept by the ``noting`` block open on
    this thread (dropped outside one)."""
    held = getattr(_noted, "attrs", None)
    if held is not None:
        held.update(attrs)


def stream_id(device) -> int | None:
    """The current CUDA stream of ``device`` (its ``cudaStream_t`` handle, as
    a span's ``stream``); None off a card."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.current_stream(device).cuda_stream


def recorded() -> list[Span]:
    """The spans recorded so far (since the last ``trace`` began), in the
    order they opened."""
    return list(_recorder.spans)


def dropped() -> int:
    """Spans not kept because the record was full."""
    return _recorder.dropped


def _write_spans(path: str, spans: list[Span]) -> None:
    """Add ``spans`` to the gzipped Chrome trace at ``path``, in a lane
    named ``radioframe``, on the file's own time base."""
    with gzip.open(path, "rt") as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    events = [{"ph": "M", "name": "process_name", "pid": "radioframe", "tid": 0,
               "args": {"name": "radioframe"}}]
    for tid in sorted({s.thread for s in spans}):
        events.append({"ph": "M", "name": "thread_name", "pid": "radioframe", "tid": tid,
                       "args": {"name": f"radioframe thread {tid}"}})
    for s in spans:
        if s.end_ns is None:
            continue
        args = {"block": s.block, "nbytes": s.nbytes}
        if s.count is not None:
            args["count"] = s.count
        if s.stream is not None:
            args["stream"] = s.stream
        if s.attrs:
            args.update(s.attrs)
        if s.parent is not None:
            args["parent"] = s.parent.name
        events.append({"ph": "X", "cat": "radioframe", "name": s.name, "pid": "radioframe",
                       "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    doc.setdefault("traceEvents", []).extend(events)
    with gzip.open(path, "wt") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str | None = None, *, device):
    """Profile the body with torch.profiler; yields ``log_dir`` (by default
    ``radioframe_trace`` under the system's temporary directory).

    Host activity is always recorded, and the card's kernels and copies too
    when ``device`` resolves to a CUDA device (no card raises, as
    ``resolve`` does). On exit, also when the body raises, the trace is
    written as a gzipped Chrome trace to
    ``<log_dir>/plugins/profile/<YYYY_MM_DD_HH_MM_SS>/<host>.trace.json.gz``,
    the layout of the reference's trace; Perfetto (ui.perfetto.dev) and
    chrome://tracing open it. The port's kernels are launched through ctypes,
    so no host op names them: the device lane names each by its
    ``__global__`` function (``fused_frontend2_kernel``, ``ols_demod_kernel``,
    ...).

    The port's spans (``span``) of the body go into the same file, in a
    lane named ``radioframe``: each idle stretch of the card lines up with
    the span open at the time. ``recorded()`` still holds them after exit.

    A fresh trace loses its first device activity: run the step once more
    inside the context than the steps to be read."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "radioframe_trace")
    dev = resolve(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    _recorder.clear()
    prof.start()
    try:
        yield log_dir
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        run = os.path.join(log_dir, "plugins", "profile", time.strftime("%Y_%m_%d_%H_%M_%S"))
        os.makedirs(run, exist_ok=True)
        path = os.path.join(run, f"{socket.gethostname()}.trace.json.gz")
        prof.export_chrome_trace(path)
        spans = recorded()
        if spans:
            _write_spans(path, spans)
