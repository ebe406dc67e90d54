"""input_msps: the input IQ samples of the blocks completed in the window
over the window's wall time, in millions a second (host clock)."""


def read(run):
    if not run.window_s or not run.blocks:
        return None
    return run.blocks * run.samples_per_block / run.window_s / 1e6
