"""pin_copy_gbps: the rate of the host's copy of a block into page-locked
memory, GB/s: the bytes of the program's ``stager.host_copy`` spans over
their summed time, in the profiled sub-window."""

from rfbench.metrics._program import spans


def read(run):
    got = spans(run, "stager.host_copy")
    if got is None:
        return None
    ns = sum(s.end_ns - s.start_ns for s in got)
    return sum(s.nbytes for s in got) / ns if ns > 0 else None
