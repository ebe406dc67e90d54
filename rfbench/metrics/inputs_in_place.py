"""inputs_in_place: the share (%) of the step's tensor-input bytes that
``CompiledStep`` read where they lay, in the profiled sub-window: Σ
``compiled.bind`` bytes over that plus Σ ``compiled.inputs`` bytes (the
copies into the static inputs). A program without the ``compiled.bind``
span gives nothing."""

from rfbench.metrics._program import spans


def read(run):
    bound = spans(run, "compiled.bind")
    if bound is None:
        return None
    in_place = sum(s.nbytes for s in bound)
    copied = sum(s.nbytes for s in spans(run, "compiled.inputs") or [])
    if in_place + copied == 0:
        return None
    return 100.0 * in_place / (in_place + copied)
