"""kernel_overlap_pct: the share (%) of the profiled sub-window's
kernel-busy time during which two or more kernels run at once, from the
trace's kernel intervals (every device activity but the copies and the
memsets); no stream is needed to read it. Kernels that one stream queues
run one after another: about 0 there."""

COPIES = ("Memcpy", "Memset")


def read(run):
    tr = run.trace
    if tr is None or not tr.window_s:
        return None
    lo, hi = tr.first_kept_ns, tr.end_ns
    edges = []
    for e in tr.device_events(lambda n: not n.startswith(COPIES)):
        a, b = max(e.start, lo), min(e.end, hi)
        if b > a:
            edges += [(a, 1), (b, -1)]
    if not edges:
        return None
    edges.sort()  # at one instant an end comes before a start: back to back is no overlap
    busy = both = depth = 0
    t0 = edges[0][0]
    for t, d in edges:
        if depth >= 1:
            busy += t - t0
        if depth >= 2:
            both += t - t0
        depth += d
        t0 = t
    return 100.0 * both / busy
