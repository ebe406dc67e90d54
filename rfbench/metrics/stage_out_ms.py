"""stage_out_ms: host ms a block in ``Stager.to_host``, which waits for the step and copies the audio out, inside ``process``."""

from rfbench.metrics._spans import per_block_ms


def read(run):
    return per_block_ms(run, "stage_out")
