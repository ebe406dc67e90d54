"""Host ms a block spent in a span of the benchmark's wrappers, over the
window's blocks."""


def per_block_ms(run, name: str):
    if run.spans is None or not run.spans.calls.get(name) or not run.blocks:
        return None
    return 1e3 * run.spans.total[name] / run.blocks
