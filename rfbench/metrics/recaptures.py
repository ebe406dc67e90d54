"""recaptures: CUDA graph captures of the entry's ``CompiledStep`` during the
window (a steady stream captures none)."""


def read(run):
    return None if run.captures_in_window is None else float(run.captures_in_window)
