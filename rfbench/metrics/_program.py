"""The program's own spans (``radioframe_torch.diag.timing``), recorded
while the traced run's profiler runs, kept where they lie whole inside the
profiled sub-window (the same clock as its events). A program that records
none, or a run without a trace, gives nothing."""


def spans(run, name: str):
    """The spans named ``name`` inside the sub-window, or None."""
    tr = run.trace
    if tr is None or not tr.window_s or not tr.block_count:
        return None
    try:
        from radioframe_torch.diag.timing import recorded
    except ImportError:  # a program without spans
        return None
    lo, hi = tr.first_kept_ns, tr.end_ns
    got = [s for s in recorded() if s.name == name and s.end_ns is not None
           and s.start_ns >= lo and s.end_ns <= hi]
    return got or None


def per_block_ms(run, name: str):
    """Host ms a block in the spans named ``name``, over the sub-window's
    blocks."""
    got = spans(run, name)
    if got is None:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in got) / run.trace.block_count
