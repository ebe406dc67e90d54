"""pinned_allocs: new page-locked host allocations in the profiled
sub-window: the sum of the counter the program's ``stager.pin`` spans read
across their ``torch.empty(..., pin_memory=True)`` (torch's caching host
allocator's ``num_host_alloc``; a buffer handed out again is none)."""

from rfbench.metrics._program import spans


def read(run):
    got = spans(run, "stager.pin")
    if got is None:
        return None
    return float(sum(s.count or 0 for s in got))
