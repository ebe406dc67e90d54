"""Entry ``api_host``: the API users call, ``process(block)`` of the
configuration's object (``Radio`` or ``Monitor``), one caller in a closed
loop. Pageable numpy complex64 blocks go in, as an SDR driver hands over fc32
host buffers; numpy audio comes out. The blocks cycle through the pool, made
on the card from the seed and copied to the host once during set-up.

A block's latency is the host clock around its ``process`` call, which ends
on the host with its audio. In the traced run the object's ``Stager`` and
``CompiledStep`` are seen through spans (``stage_in``, ``stage_out``,
``step_call``, inside ``process``).
"""

from __future__ import annotations

import sys
import time

import torch

from rfbench.harness import Wrapped, make_pool, synchronize
from rfbench.metrics.block_ms_p99 import percentile


def run(ctx) -> None:
    cfg, sizes, cell, dev = ctx.cfg, ctx.sizes, ctx.cell, ctx.device
    pool = make_pool(ctx)
    ctx.pool_host = pool.cpu().numpy()
    del pool
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ctx.mark("pool to host")
    obj = cfg.build_api(sizes, cell, dev)
    ctx.mark("object")
    compiled = obj._compiled
    if ctx.trace:
        obj._stager = Wrapped(obj._stager, ctx.spans,
                              {"to_device": "stage_in", "to_host": "stage_out"})
        obj._compiled = Wrapped(compiled, ctx.spans, {"__call__": "step_call"})
    # set-up: capture the one signature; the outputs held meanwhile leave the
    # page-locked cache as many buffers as the kept blocks take later
    held = [obj.process(cfg.block(ctx.pool_host, k)) for k in range(cell["warm_blocks"])]
    synchronize(dev)
    del held
    ctx.mark("capture and warm-up")
    k = cell["warm_blocks"]
    captures0 = compiled.captures
    ctx.spans.reset()
    drain = lambda: synchronize(dev)  # noqa: E731
    lat = []
    t_start = time.perf_counter()
    ctx.run.setup_s = t_start - ctx.t0
    while True:
        if ctx.dtrace is not None:
            ctx.dtrace.tick(time.perf_counter() - t_start, drain)
        slot = ctx.keep.wants()
        blk = cfg.block(ctx.pool_host, k)
        with ctx.spans.span("process"):
            b0 = time.perf_counter()
            audio = obj.process(blk)
            b1 = time.perf_counter()
        lat.append(b1 - b0)
        outs = cfg.api_outputs(obj, audio)
        if slot is not None:
            ctx.keep.put(slot, k, outs)
        ctx.keep.last = (k, outs)
        k += 1
        if b1 - t_start >= ctx.seconds:
            break
    ctx.run.window_s = b1 - t_start
    if ctx.dtrace is not None:
        ctx.dtrace.stop(drain)
    ctx.run.blocks = len(lat)
    ctx.run.latencies_s = lat
    q = sorted(lat)
    med = percentile(q, 50.0)
    print(f"rfbench: block ms p50 {1e3 * med:.3f} p99 {1e3 * percentile(q, 99.0):.3f} "
          f"max {1e3 * q[-1]:.3f}; {sum(x > 2 * med for x in q)} of {len(q)} blocks over twice "
          f"the median, {1e3 * sum(x for x in q if x > 2 * med):.1f} ms in them",
          file=sys.stderr)
    ctx.run.captures_in_window = compiled.captures - captures0
    if torch.device(dev).type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated()
