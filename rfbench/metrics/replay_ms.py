"""replay_ms: host ms a block in the program's ``compiled.replay`` span
(``CompiledStep``'s ``graph.replay()`` and its launch counters), in the
profiled sub-window."""

from rfbench.metrics._program import per_block_ms


def read(run):
    return per_block_ms(run, "compiled.replay")
