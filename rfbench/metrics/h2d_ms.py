"""h2d_ms: device ms a block of host-to-device copies, from the profiled
sub-window."""

from rfbench.trace import H2D


def read(run):
    tr = run.trace
    if tr is None or not tr.window_s or not tr.block_count:
        return None
    evs = tr.device_events(lambda n: n.startswith(H2D))
    if not evs:
        return None
    return 1e-6 * sum(e.end - e.start for e in evs) / tr.block_count
