"""block_ms_p99: the 99th percentile over all blocks of the window of the
host-clock time from handing a block to ``process`` to getting its audio
back (ms): the highest percentile with some tens of blocks beyond it in a
window. Entries without a per-block wait report nothing."""

import math


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def read(run):
    if not run.latencies_s:
        return None
    return 1e3 * percentile(run.latencies_s, 99.0)
