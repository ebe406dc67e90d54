"""api_self_ms: host ms a block inside ``process`` not covered by its
``Stager`` and ``CompiledStep`` calls (the API's own work: argument checks,
words and modes, the clone of the aux)."""

from rfbench.metrics._spans import per_block_ms


def read(run):
    total = per_block_ms(run, "process")
    if total is None:
        return None
    parts = [per_block_ms(run, n) for n in ("stage_in", "stage_out", "step_call")]
    return total - sum(p for p in parts if p is not None)
