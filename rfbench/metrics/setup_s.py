"""setup_s: process start to the start of the window (host clock): imports,
CUDA's start, loading or building the kernels, making the pool from the
seed, building the object and capturing its one block signature."""


def read(run):
    return run.setup_s
