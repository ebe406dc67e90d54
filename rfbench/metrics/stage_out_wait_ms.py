"""stage_out_wait_ms: host ms from the start of the program's
``stager.to_host`` span to the start of the first device-to-host copy
inside it (the wait for the step ahead of the copy out), the mean over
the spans of the profiled sub-window that hold one."""

import bisect

from rfbench.metrics._program import spans
from rfbench.trace import D2H


def read(run):
    got = spans(run, "stager.to_host")
    if got is None:
        return None
    starts = sorted(e.start for e in run.trace.device_events(lambda n: n.startswith(D2H)))
    waits = []
    for s in got:
        i = bisect.bisect_left(starts, s.start_ns)
        if i < len(starts) and starts[i] <= s.end_ns:
            waits.append(starts[i] - s.start_ns)
    return 1e-6 * sum(waits) / len(waits) if waits else None
