"""stage_in_ms: host ms a block in ``Stager.to_device`` (pinned staging and the start of the host-to-device copy), inside ``process``."""

from rfbench.metrics._spans import per_block_ms


def read(run):
    return per_block_ms(run, "stage_in")
