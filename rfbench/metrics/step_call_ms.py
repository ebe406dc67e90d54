"""step_call_ms: host ms a block in ``CompiledStep.__call__``: the copy into the static inputs and the replay, enqueued."""

from rfbench.metrics._spans import per_block_ms


def read(run):
    return per_block_ms(run, "step_call")
