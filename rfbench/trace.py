"""The traced run's device view: torch.profiler over a steady sub-window of
the measured window, reduced in memory to what the per-layer readers take.

The profiler starts once ``START_FRAC`` of the window is gone, on a drained
device, traces ``blocks`` blocks after one more that it drops (a fresh trace
loses its first device activity), drains the device inside an
``rfbench.drain`` span and stops. Nothing is written to disk.

The sub-window runs from the first kept block's first host span to the end
of the drain. Device busy time is the union of every device activity
(kernels, copies, memsets) inside it; an idle gap is a stretch of it with
none, named by the ``rfbench`` span and the innermost host operation open at
the gap's middle.
"""

from __future__ import annotations

import bisect
import os
import sys
import time
from collections import defaultdict

import torch

START_FRAC = 0.3  # of the window gone before the profiler starts
H2D = "Memcpy HtoD"
D2H = "Memcpy DtoH"


class Event:
    __slots__ = ("name", "start", "end", "device")

    def __init__(self, name, start, end, device):
        self.name, self.start, self.end, self.device = name, start, end, device


class DeviceTrace:
    """Drives the profiler over a sub-window; ``tick`` before each block,
    ``stop`` after the loop. ``events`` holds the kept events (ns)."""

    def __init__(self, seconds: float, blocks: int, enabled=True):
        self.start_at = seconds * START_FRAC
        self.blocks = blocks
        self.enabled = enabled
        self.prof = None
        self.seen = 0          # blocks ticked since the profiler started
        self.done = False
        self.first_kept_ns = None
        self.events: list[Event] = []
        self.block_count = 0   # blocks inside the kept sub-window
        self.warm_s = self.start_s = 0.0

    def warm(self) -> None:
        """Start and stop the profiler once (CUPTI's first start takes
        seconds): part of the traced run's set-up, not of its window."""
        if not self.enabled:
            return
        # CUPTI torn down after this cycle and set up again for the next one
        # can fail under CUDA graphs; keep it up
        os.environ.setdefault("TEARDOWN_CUPTI", "0")
        t = time.perf_counter()
        with torch.profiler.profile(activities=self._activities()):
            torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self.warm_s = time.perf_counter() - t

    @staticmethod
    def _activities():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def tick(self, elapsed_s: float, drain) -> None:
        """Called before a block starts; ``drain()`` synchronizes the device."""
        if not self.enabled or self.done:
            return
        if self.prof is None:
            if elapsed_s < self.start_at:
                return
            drain()
            t = time.perf_counter()
            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.start()
            self.start_s = time.perf_counter() - t
            self.seen = 0
        if self.seen == 1:
            self._mark = torch.profiler.record_function("rfbench.kept")
            self._mark.__enter__()
            self._mark.__exit__(None, None, None)
        if self.seen == self.blocks + 1:
            self.stop(drain)
            return
        self.seen += 1

    def stop(self, drain) -> None:
        if self.prof is None or self.done:
            return
        with torch.profiler.record_function("rfbench.drain"):
            drain()
        self.prof.stop()
        self.done = True
        self.block_count = max(0, self.seen - 1)
        self._collect()
        self.prof = None

    def _collect(self) -> None:
        evs = []
        for e in self.prof.profiler.kineto_results.events():
            dev = e.device_type() == torch.autograd.DeviceType.CUDA
            if dev and e.name().startswith(("rfbench.", "ProfilerStep")):
                continue  # a host range mirrored on the device's timeline, not device work
            evs.append(Event(e.name(), e.start_ns(), e.end_ns(), dev))
        marks = [e.start for e in evs if e.name == "rfbench.kept"]
        drains = [e.end for e in evs if e.name == "rfbench.drain"]
        print(f"rfbench: trace: {len(evs)} events, {sum(e.device for e in evs)} on the device, "
              f"{len(marks)} marks, {len(drains)} drains, {self.seen} blocks; profiler warm-up "
              f"{self.warm_s:.3f} s, start {self.start_s:.3f} s", file=sys.stderr)
        if not marks or not drains:
            self.events = []
            return
        self.first_kept_ns, self.end_ns = marks[0], drains[-1]
        self.events = [e for e in evs if e.end > self.first_kept_ns and e.start < self.end_ns]

    # -- reductions -----------------------------------------------------------------

    @property
    def window_s(self) -> float | None:
        if not self.events:
            return None
        return (self.end_ns - self.first_kept_ns) * 1e-9

    def device_events(self, keep=lambda name: True) -> list[Event]:
        return [e for e in self.events if e.device and keep(e.name)]

    def busy_s(self, keep=lambda name: True) -> float:
        """Seconds of the sub-window in which some kept device activity runs."""
        return _union_ns(self._clipped(self.device_events(keep))) * 1e-9

    def _clipped(self, evs):
        lo, hi = self.first_kept_ns, self.end_ns
        return sorted((max(e.start, lo), min(e.end, hi)) for e in evs
                      if min(e.end, hi) > max(e.start, lo))

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device activities with the most time."""
        tot = defaultdict(int)
        for a, b, name in ((max(e.start, self.first_kept_ns), min(e.end, self.end_ns), e.name)
                           for e in self.device_events()):
            if b > a:
                tot[_short(name)] += b - a
        return [[n, t * 1e-9] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host was doing, idle seconds]]: the device's idle time
        summed by the host span open at each gap's middle, largest first."""
        busy = _merge(self._clipped(self.device_events()))
        gaps, t = [], self.first_kept_ns
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end_ns > t:
            gaps.append((t, self.end_ns))
        host = sorted((e for e in self.events if not e.device), key=lambda e: e.start)
        starts = [e.start for e in host]
        tot = defaultdict(int)
        for a, b in gaps:
            tot[self._doing(host, starts, (a + b) // 2)] += b - a
        return [[n, t * 1e-9] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    @staticmethod
    def _doing(host, starts, t) -> str:
        """'<rfbench span>/<innermost host op>' open at time t."""
        i = bisect.bisect_right(starts, t)
        span, inner = "harness", None
        for e in host[max(0, i - 4000):i]:
            if e.end >= t:
                if e.name.startswith("rfbench."):
                    span = e.name[len("rfbench."):]
                else:
                    inner = e.name
        return span if inner is None else f"{span}/{_short(inner)}"


def _short(name: str, n: int = 80) -> str:
    name = name.removeprefix("void ")
    return name if len(name) <= n else name[:n]


def _merge(iv):
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _union_ns(iv) -> int:
    return sum(b - a for a, b in _merge(iv))
