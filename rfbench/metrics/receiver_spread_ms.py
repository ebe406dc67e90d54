"""receiver_spread_ms: the mean over the profiled sub-window's rounds of
the slowest receiver's ``api.process`` less the fastest's (ms): the
program's spans grouped by the CUDA stream each ran on (their ``stream``),
the i-th of each stream its receiver's block of round i. A program whose
spans carry no stream, or a run on one stream, gives nothing."""

from collections import defaultdict

from rfbench.metrics._program import spans


def read(run):
    got = spans(run, "api.process")
    if got is None:
        return None
    by_stream = defaultdict(list)
    for s in got:
        sid = getattr(s, "stream", None)
        if sid is None:
            return None
        by_stream[sid].append(s)
    if len(by_stream) < 2:
        return None
    per = [sorted(v, key=lambda s: s.start_ns) for v in by_stream.values()]
    rounds = min(len(v) for v in per)
    spread = 0
    for i in range(rounds):
        took = [v[i].end_ns - v[i].start_ns for v in per]
        spread += max(took) - min(took)
    return 1e-6 * spread / rounds
