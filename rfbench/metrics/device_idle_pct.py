"""device_idle_pct: the share of the profiled sub-window in which no kernel
and no copy runs on the card (%)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.window_s or not tr.device_events():
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
