"""step_inputs_ms: host ms a block in the program's ``compiled.inputs``
span (``CompiledStep``'s copies into the static inputs, enqueued; a
pageable host input waits for the stream), in the profiled sub-window."""

from rfbench.metrics._program import per_block_ms


def read(run):
    return per_block_ms(run, "compiled.inputs")
