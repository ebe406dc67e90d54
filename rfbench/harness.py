"""One run of one cell: inputs from the seed, the port's object built and its
one block signature captured, a closed-loop window of ``seconds``, the check
against the plain reference, and the contract's last line.

Everything that belongs to one item is found by name: the cell
``workloads/<cell>.json`` names its configuration (``configs/<config>.json``
and ``configs/<config>.py``) and its entry (``drivers/<entry>.py``); each
metric that ``BENCHMARK.json`` lists for the cell is read by
``metrics/<metric>.py``, where a metric's name is a reader's name, or a
reader's name, a dot and the cells it is split by (``input_msps.host`` and
``input_msps.channelizer_4096.device`` are both read by
``metrics/input_msps.py``). Adding any of them is adding files and entries.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "radioframe")  # top-level module names, compared whole


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def load_sizes(config: str) -> dict:
    return load_json(HERE / "configs" / f"{config}.json")


def module(kind: str, name: str):
    """``rfbench/<kind>/<name>.py`` (a configuration, an entry or a metric)."""
    return importlib.import_module(f"rfbench.{kind}.{name}")


def reader(metric: str):
    """The reader of ``metric``: ``metrics/<name before the first dot>.py``."""
    return module("metrics", metric.split(".")[0])


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# -- the metrics a cell reports --------------------------------------------------------


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The manifest's metrics for ``cell``: its end-to-end metrics (trace 0)
    or its per-layer metrics (trace 1). A metric with ``workloads`` is
    reported in those cells; a per-layer one without it wherever its
    ``moves`` is reported."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def here(m):
        return cell in m["workloads"] if "workloads" in m else m["moves"] in names
    return [m for m in manifest["per_layer"] if here(m)]


# -- spans and wrappers ----------------------------------------------------------------


class Spans:
    """Host-clock seconds spent in named calls, summed over the window; with
    ``on``, each is also an ``rfbench.<name>`` range for the profiler."""

    def __init__(self, on: bool):
        self.on = on
        self.total = defaultdict(float)
        self.calls = defaultdict(int)

    @contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        import torch

        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(f"rfbench.{name}"):
                yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def reset(self) -> None:
        self.total.clear()
        self.calls.clear()


class Wrapped:
    """A program object seen through the benchmark: the methods named in
    ``names`` (``__call__`` too) run inside spans; ``after`` sees what a
    call returned. Everything else passes through."""

    def __init__(self, inner, spans: Spans, names: dict, after=None):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_spans", spans)
        object.__setattr__(self, "_names", names)
        object.__setattr__(self, "_after", after)

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in self._names:
            return attr
        spans, span = self._spans, self._names[name]

        def call(*a, **k):
            with spans.span(span):
                return attr(*a, **k)
        return call

    def __setattr__(self, name, value):
        setattr(self._inner, name, value)

    def __call__(self, *a, **k):
        with self._spans.span(self._names.get("__call__", "call")):
            out = self._inner(*a, **k)
        if self._after is not None:
            self._after(out)
        return out


# -- the blocks kept for the check -------------------------------------------------------


class Keep:
    """Which window blocks are checked: ``sample`` of them drawn uniformly
    from the seed as the window goes (reservoir sampling: the window's
    length is not known ahead), plus the last one."""

    def __init__(self, sample: int, seed: int):
        self.sample = sample
        self.rng = np.random.default_rng([int(seed) % 2 ** 63, 0x6B656570])
        self.seen = 0
        self.slots: dict[int, dict] = {}
        self.last: tuple[int, dict] | None = None

    def wants(self) -> int | None:
        """Before block i of the window: the slot it would take, or None."""
        i = self.seen
        self.seen += 1
        if i < self.sample:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.sample else None

    def put(self, slot: int, k: int, outputs: dict) -> None:
        self.slots[slot] = (k, outputs)

    def blocks(self) -> dict[int, dict]:
        out = dict(self.slots.values())
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return dict(sorted(out.items()))


# -- one run ---------------------------------------------------------------------------


class Run:
    """What a run measured; the metric readers take it."""

    def __init__(self, **kw):
        self.samples_per_block = 0
        self.blocks = 0            # blocks completed in the window
        self.window_s = None
        self.latencies_s = []      # per block, where the entry has them
        self.setup_s = None
        self.spans = None
        self.captures_in_window = None
        self.trace = None          # trace.DeviceTrace of the traced run
        self.__dict__.update(kw)


class Context:
    """What a driver gets: the cell, its configuration module and sizes, the
    seed, the window length, spans, the blocks to keep and the device trace."""

    def __init__(self, cell_name, cell, sizes, cfg, seed, seconds, trace, device, t0):
        self.cell_name, self.cell, self.sizes, self.cfg = cell_name, cell, sizes, cfg
        self.seed, self.seconds, self.trace, self.device, self.t0 = (seed, seconds, trace,
                                                                     device, t0)
        self.spans = Spans(trace)
        self.keep = Keep(cell["check"]["sample"], seed)
        self.run = Run(samples_per_block=cfg.samples_per_block(sizes, cell))
        self.dtrace = None
        self.memory_peak_bytes = 0
        self.pool_host = None      # numpy blocks, where the entry takes host blocks
        self.pool = None           # the device pool, where the entry keeps it
        self.marks = [("start", t0)]  # set-up's steps, host clock

    def mark(self, what: str) -> None:
        self.marks.append((what, time.perf_counter()))

    def setup_parts(self) -> str:
        return ", ".join(f"{b[0]} {b[1] - a[1]:.2f}" for a, b in zip(self.marks, self.marks[1:]))


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_pool(ctx: Context):
    import torch

    from rfbench import signals

    pool = signals.make_pool(ctx.cfg.layout(ctx.sizes, ctx.cell), ctx.cell["signal"], ctx.seed,
                             ctx.device)
    synchronize(ctx.device)
    ctx.mark("pool")
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return pool


def reference_check(ctx: Context, kept: dict) -> dict:
    """Run the plain reference over each kept block, from a fresh state
    ``reference_lead_blocks`` earlier (block 0 at the latest), and compare.
    Returns {check name: worst number over the kept blocks}."""
    from rfbench.compare import compare
    from rfbench.reference.plain import F64

    cfg, sizes = ctx.cfg, ctx.sizes
    ref = cfg.reference(sizes, ctx.device)
    worst: dict[str, float] = {}
    for k, prog in kept.items():
        out = reference_outputs(ref, ctx, k, lambda j: reference_block(ctx, j), F64)
        nums = compare(prog, out, cfg.CHECKS, cfg.modes(sizes), cfg.nfm_period(sizes))
        for name, v in nums.items():
            worst[name] = max(worst.get(name, 0.0), v)
        print(f"rfbench: block {k}: " + ", ".join(f"{n} {v:.3e}" for n, v in nums.items())
              + "; audio by mode " + _by_mode(prog["audio"], out["audio"], cfg, sizes),
              file=sys.stderr)
    return worst


def reference_outputs(ref, ctx: Context, k: int, block, p) -> dict:
    """The reference's outputs of block k in precision p, from a fresh state
    ``reference_lead_blocks`` earlier (block 0 at the latest); ``block(j)``
    gives block j."""
    import torch

    s = max(0, k - ctx.cfg.reference_lead_blocks(ctx.sizes, ctx.cell))
    st = ref.init_state(s, ctx.cell["block"], p)
    with torch.no_grad():
        for j in range(s, k + 1):
            st, out = ref.step(st, block(j), p)
    return out


def _by_mode(prog, ref, cfg, sizes) -> str:
    """The worst channel's audio error of each mode, with the channel."""
    from rfbench.compare import audio_err_rows

    modes = cfg.modes(sizes)
    rows = audio_err_rows(prog, ref, modes, cfg.nfm_period(sizes)).numpy()
    out = []
    for m in sorted(set(modes.tolist())):
        idx = np.flatnonzero(modes == m)
        c = int(idx[np.argmax(rows[idx])])
        out.append(f"{cfg.MODE_NAMES[m]} {rows[c]:.2e} (ch {c})")
    return ", ".join(out)


def reference_block(ctx: Context, k: int):
    """Block k as the reference gets it: the same blocks the entry got."""
    import torch

    if ctx.pool is not None:
        return ctx.cfg.block(ctx.pool, k)
    return torch.from_numpy(ctx.cfg.block(ctx.pool_host, k)).to(ctx.device)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             manifest: dict | None = None, cell: dict | None = None, sizes: dict | None = None,
             t0: float | None = None) -> dict:
    """One run of ``cell_name``; returns the result line's object. ``cell``
    and ``sizes`` replace the files' (the CPU tests' small sizes)."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    manifest = manifest if manifest is not None else load_json(ROOT / "BENCHMARK.json")
    cell = cell if cell is not None else load_cell(cell_name)
    sizes = sizes if sizes is not None else load_sizes(cell["config"])
    cfg = module("configs", cell["config"])
    driver = module("drivers", cell["entry"])
    ctx = Context(cell_name, cell, sizes, cfg, seed, seconds, trace, device, t0)
    ctx.mark("imports")
    if trace:
        from rfbench.trace import DeviceTrace

        ctx.dtrace = DeviceTrace(seconds, cell["trace_blocks"],
                                 enabled=torch.device(device).type == "cuda")
        ctx.dtrace.warm()
        ctx.mark("profiler")
    driver.run(ctx)  # set-up, the window, the kept outputs
    print(f"rfbench: set-up s: {ctx.setup_parts()}", file=sys.stderr)
    run = ctx.run
    run.spans = ctx.spans
    run.trace = ctx.dtrace
    run.sizes, run.cell = sizes, cell
    metrics = {}
    for m in cell_metrics(manifest, cell_name, trace):
        v = reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    kept = ctx.keep.blocks()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums = reference_check(ctx, kept)
    limits = cell["check"]["limits"]
    checks = {n: {"value": nums.get(n, float("inf")), "limit": lim} for n, lim in limits.items()}
    failed = [n for n, c in checks.items() if not c["value"] <= c["limit"]]
    result = {"correct": not failed and bool(kept), "attempted": run.blocks,
              "failed": len(failed), "metrics": metrics, "device": device_info(ctx, device)}
    if trace and ctx.dtrace is not None and ctx.dtrace.window_s and ctx.dtrace.busy_s() > 0:
        result["device"]["busy_s"] = ctx.dtrace.busy_s()
        result["device"]["window_s"] = ctx.dtrace.window_s
        result["breakdown"] = {"device_ops": ctx.dtrace.device_ops(),
                               "idle_gaps": ctx.dtrace.idle_gaps()}
    result["checks"] = checks
    print(f"rfbench: {len(kept)} blocks checked {sorted(kept)}, reference "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    return result


def device_info(ctx: Context, device: str) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": ctx.memory_peak_bytes}


def card_check(chips: int) -> str | None:
    """Why this machine cannot run a cell of ``chips`` cards, or None."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: the benchmark needs a CUDA card"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}"
    return None


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"rfbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    why = card_check(cells[args.workload]["chips"])
    if why:
        print(f"rfbench: {why}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      manifest=manifest, t0=t0)
    bad = forbidden_modules()
    if bad:
        print(f"rfbench: the run loaded {', '.join(bad)}; the port may load none of "
              f"{', '.join(FORBIDDEN)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(_plain(result), allow_nan=False))
    return 0


def _plain(x):
    """The result with numpy numbers as floats and a non-finite number as
    its name (a check that found none has the value "inf")."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (bool, str)) or x is None:
        return x
    if isinstance(x, (int, np.integer)):
        return int(x)
    x = float(x)
    return x if math.isfinite(x) else repr(x)
