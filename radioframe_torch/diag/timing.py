"""Per-stage timing and profiler traces (counterpart of
``radioframe/diag/timing.py``).

On a CUDA device a stage is timed by a pair of CUDA events on the current
stream, read when the report is made; on the CPU by the host clock.
``sync_value`` waits for everything a tensor depends on. ``trace`` records
a torch.profiler trace and writes it where the reference's trace context
writes its own, in the same format.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch

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


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/radioframe_trace", *, device):
    """Profile the body with torch.profiler; yields ``log_dir``.

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

    A fresh trace loses its first device activity: run the step once more
    inside the context than the steps to be read."""
    dev = resolve(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        run = os.path.join(log_dir, "plugins", "profile", time.strftime("%Y_%m_%d_%H_%M_%S"))
        os.makedirs(run, exist_ok=True)
        prof.export_chrome_trace(os.path.join(run, f"{socket.gethostname()}.trace.json.gz"))
