"""Entry ``stream_device``: ``BlockStream(step, state, device=...).run`` over
a ring of the pool's distinct blocks resident in device memory, as a
GPUDirect NIC ring lands them. The outputs stay on the card; the host
enqueues ahead, and the window ends with a drain of the device, which its
time includes.

Only what the check needs is kept: the outputs of the sampled blocks,
cloned on the device right after their step is enqueued, and those of the
last block. The stream's ``CompiledStep`` is seen through the benchmark's
wrapper, which takes those clones and, in the traced run, a ``step_call``
span.
"""

from __future__ import annotations

import time

import torch

from rfbench.harness import Wrapped, make_pool, synchronize


def _clone(outs: dict) -> dict:
    return {k: v.clone() for k, v in outs.items()}


def run(ctx) -> None:
    from radioframe_torch.core.stream import BlockStream

    cfg, sizes, cell, dev = ctx.cfg, ctx.sizes, ctx.cell, ctx.device
    ctx.pool = pool = make_pool(ctx)
    step, state, args = cfg.build_stream(sizes, cell, dev)
    bs = BlockStream(step, state, device=dev)
    ctx.mark("object")
    compiled = bs.compiled
    live = {"window": False, "k": 0, "last": None}

    def after(out):
        live["last"] = out
        if not live["window"]:
            return
        slot = ctx.keep.wants()
        if slot is not None:
            ctx.keep.put(slot, live["k"], _clone(cfg.stream_outputs(*out)))

    bs.compiled = Wrapped(compiled, ctx.spans, {"__call__": "step_call"}, after=after)
    warm = cell["warm_blocks"]
    bs.run((cfg.block(pool, k) for k in range(warm)), *args, collect=False)
    synchronize(dev)
    ctx.mark("capture and warm-up")
    captures0 = compiled.captures
    ctx.spans.reset()
    drain = lambda: synchronize(dev)  # noqa: E731
    count = {"n": 0}
    t_start = time.perf_counter()
    ctx.run.setup_s = t_start - ctx.t0

    def ring():
        k = warm
        while True:
            elapsed = time.perf_counter() - t_start
            if elapsed >= ctx.seconds:
                return
            if ctx.dtrace is not None:
                ctx.dtrace.tick(elapsed, drain)
            live["k"] = k
            count["n"] += 1
            yield cfg.block(pool, k)
            k += 1

    live["window"] = True
    bs.run(ring(), *args, collect=False)
    synchronize(dev)
    ctx.run.window_s = time.perf_counter() - t_start
    live["window"] = False
    if ctx.dtrace is not None:
        ctx.dtrace.stop(drain)
    ctx.run.blocks = count["n"]
    ctx.run.captures_in_window = compiled.captures - captures0
    if live["last"] is not None:
        ctx.keep.last = (warm + count["n"] - 1, _clone(cfg.stream_outputs(*live["last"])))
    if torch.device(dev).type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated()
