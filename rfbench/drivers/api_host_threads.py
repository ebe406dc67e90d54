"""Entry ``api_host_threads``: a station of receivers on one card, the API
users call, one caller thread a receiver, in lockstep. The configuration's
``build_api`` gives the station's objects (``Radio``s); caller thread r
only ever calls receiver r's ``process(block)``. The main thread runs
rounds: a round hands block k of every receiver out at once and waits for
all of them to return, one sample clock for the whole station. The blocks
are pageable numpy row-slices of the round (``receiver_block``), which the
pool holds on the host, made on the card from the seed and copied to the
host once during set-up.

A latency is the host clock around one receiver's ``process`` call, taken
on its caller thread, so a round gives one a receiver; a block of the
window is a round (``samples_per_block`` counts every receiver's). The
first round of the set-up hands the blocks out one receiver at a time, so
that each captures its step (and the kernels are built) alone; the later
ones at once. The kept outputs are whole rounds: the receivers' outputs
concatenated over channels (``station_outputs``), so the check holds every
receiver's channels to the reference. In the traced run each receiver's
``Stager`` and ``CompiledStep`` are seen through spans of its own
(``Spans`` is not shared between threads), merged after the window, and
the device trace ticks between rounds.
"""

from __future__ import annotations

import queue
import sys
import threading
import time

import torch

from rfbench.harness import Spans, Wrapped, make_pool, synchronize
from rfbench.metrics.block_ms_p99 import percentile

ROUND_TIMEOUT_S = 900.0  # a round that takes longer has hung: the run fails


class _Caller:
    """Receiver r's caller: a thread that runs ``process`` on each block it
    is handed and reports (r, seconds, outputs, error) to ``outbox``."""

    def __init__(self, r: int, obj, cfg, spans: Spans, outbox: queue.Queue):
        self.r, self.obj, self.cfg, self.spans, self.outbox = r, obj, cfg, spans, outbox
        self.inbox: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._serve, name=f"receiver-{r}", daemon=True)
        self.thread.start()

    def _serve(self) -> None:
        while True:
            blk = self.inbox.get()
            if blk is None:
                return
            try:
                with self.spans.span("process"):
                    t0 = time.perf_counter()
                    audio = self.obj.process(blk)
                    dt = time.perf_counter() - t0
                self.outbox.put((self.r, dt, self.cfg.api_outputs(self.obj, audio), None))
            except Exception as e:  # handed to the main thread, which raises it
                self.outbox.put((self.r, None, None, e))


def _round(callers, outbox: queue.Queue, cfg, sizes, blk) -> list:
    """Hand each caller its rows of the round ``blk`` at once; returns
    [(seconds, outputs)] in receiver order once all have returned."""
    for c in callers:
        c.inbox.put(cfg.receiver_block(blk, sizes, c.r))
    got = {}
    for _ in callers:
        r, dt, outs, err = outbox.get(timeout=ROUND_TIMEOUT_S)
        if err is not None:
            raise RuntimeError(f"receiver {r}'s process raised") from err
        got[r] = (dt, outs)
    return [got[c.r] for c in callers]


def run(ctx) -> None:
    cfg, sizes, cell, dev = ctx.cfg, ctx.sizes, ctx.cell, ctx.device
    pool = make_pool(ctx)
    ctx.pool_host = pool.cpu().numpy()
    del pool
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ctx.mark("pool to host")
    objs = cfg.build_api(sizes, cell, dev)
    ctx.mark("objects")
    compiled = [o._compiled for o in objs]
    spans = [Spans(ctx.trace) for _ in objs]
    if ctx.trace:
        for o, sp in zip(objs, spans):
            o._stager = Wrapped(o._stager, sp, {"to_device": "stage_in", "to_host": "stage_out"})
            o._compiled = Wrapped(o._compiled, sp, {"__call__": "step_call"})
    outbox: queue.Queue = queue.Queue()
    callers = [_Caller(r, o, cfg, sp, outbox) for r, (o, sp) in enumerate(zip(objs, spans))]
    try:
        _window(ctx, callers, outbox, compiled, spans)
    finally:
        for c in callers:
            c.inbox.put(None)
        for c in callers:
            c.thread.join(timeout=60.0)
    if torch.device(dev).type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated()


def _window(ctx, callers, outbox, compiled, spans) -> None:
    cfg, sizes, cell, dev = ctx.cfg, ctx.sizes, ctx.cell, ctx.device
    # set-up: capture each receiver's one signature, alone in the first
    # round; the outputs held meanwhile leave the page-locked cache as many
    # buffers as the kept rounds take later
    first = cfg.block(ctx.pool_host, 0)
    held = [_round([c], outbox, cfg, sizes, first) for c in callers]
    held += [_round(callers, outbox, cfg, sizes, cfg.block(ctx.pool_host, k))
             for k in range(1, cell["warm_blocks"])]
    synchronize(dev)
    del held
    ctx.mark("capture and warm-up")
    k = cell["warm_blocks"]
    captures0 = sum(c.captures for c in compiled)
    for sp in spans:
        sp.reset()
    drain = lambda: synchronize(dev)  # noqa: E731
    lat, rounds = [], []
    t_start = time.perf_counter()
    ctx.run.setup_s = t_start - ctx.t0
    while True:
        if ctx.dtrace is not None:
            ctx.dtrace.tick(time.perf_counter() - t_start, drain)
        slot = ctx.keep.wants()
        b0 = time.perf_counter()
        got = _round(callers, outbox, cfg, sizes, cfg.block(ctx.pool_host, k))
        b1 = time.perf_counter()
        rounds.append(b1 - b0)
        lat += [dt for dt, _ in got]
        parts = [outs for _, outs in got]
        if slot is not None:
            ctx.keep.put(slot, k, parts)
        ctx.keep.last = (k, parts)
        k += 1
        if b1 - t_start >= ctx.seconds:
            break
    ctx.run.window_s = b1 - t_start
    if ctx.dtrace is not None:
        ctx.dtrace.stop(drain)
    synchronize(dev)
    # the kept rounds as the check reads them: every receiver's channels
    ctx.keep.slots = {s: (kk, cfg.station_outputs(p)) for s, (kk, p) in ctx.keep.slots.items()}
    ctx.keep.last = (ctx.keep.last[0], cfg.station_outputs(ctx.keep.last[1]))
    for sp in spans:
        for name, t in sp.total.items():
            ctx.spans.total[name] += t
            ctx.spans.calls[name] += sp.calls[name]
    ctx.run.blocks = len(rounds)
    ctx.run.latencies_s = lat
    q, qr = sorted(lat), sorted(rounds)
    med = percentile(q, 50.0)
    print(f"rfbench: {len(callers)} receivers, {len(rounds)} rounds; round ms p50 "
          f"{1e3 * percentile(qr, 50.0):.3f} max {1e3 * qr[-1]:.3f}; block ms p50 "
          f"{1e3 * med:.3f} p99 {1e3 * percentile(q, 99.0):.3f} max {1e3 * q[-1]:.3f}; "
          f"{sum(x > 2 * med for x in q)} of {len(q)} blocks over twice the median",
          file=sys.stderr)
    ctx.run.captures_in_window = sum(c.captures for c in compiled) - captures0
