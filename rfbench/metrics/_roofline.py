"""A kernel's share of its roofline: the least time its bytes and
operations allow on the card (``peaks.bound_s``) over its mean device time
in the profiled sub-window (%). No kernel of that name traced: nothing."""

from rfbench.peaks import bound_s


def roofline_pct(run, kernel: str, work):
    tr = run.trace
    if tr is None or not tr.window_s:
        return None
    evs = tr.device_events(lambda n: kernel in n)
    if not evs:
        return None
    mean_s = 1e-9 * sum(e.end - e.start for e in evs) / len(evs)
    nbytes, ops = work(run.sizes, run.cell)
    return 100.0 * bound_s(nbytes, ops)[0] / mean_s
