"""Build the port's CUDA C++ kernels with ``nvcc`` and load them via ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use for Hopper (``sm_90a``) into ``build/kernels/`` at the checkout root (a
git-ignored directory), keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a fresh checkout builds what it runs from
its own sources. ``build_all`` compiles several sources in parallel. No PyTorch headers
are included, so a build takes seconds, not minutes.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# no -use_fast_math: it would swap sincosf for the approximate intrinsic
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the kernel wrappers count their launches in ``launches`` (and
# ``variant_launches``) through ``launched``; a replayed CUDA graph
# (core/compiled.py) adds what its capture recorded through ``advance``
_counting = threading.Lock()   # the counters' read-modify-writes, from any thread
_capturing = threading.local()  # ``tally``: the launches of a capture open on this thread
_building: dict = {}            # a lock a source: one thread builds it, the others wait
_building_lock = threading.Lock()


@dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time in this process; 0.0 when the library was cached
    log: str        # nvcc/ptxas output (registers, shared memory, spills)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built on a machine with the CUDA toolkit")


def launched(wrapper, variant=None) -> None:
    """One launch of ``wrapper`` (of ``variant``): counted in its
    ``launches`` (and ``variant_launches``), or, while this thread captures
    a CUDA graph (``recording``), recorded for the graph's replays."""
    tally = getattr(_capturing, "tally", None)
    if tally is not None:
        entry = tally.setdefault(wrapper, [0, {}])
        entry[0] += 1
        if variant is not None:
            entry[1][variant] = entry[1].get(variant, 0) + 1
        return
    advance([(wrapper, 1, {} if variant is None else {variant: 1})])


@contextlib.contextmanager
def recording():
    """The launches this thread makes inside are recorded, not counted
    (launches on other threads are theirs): yields a list that holds
    ``[(wrapper, launches, {variant: launches})]`` once the block ends."""
    _capturing.tally = tally = {}
    made: list = []
    try:
        yield made
    finally:
        _capturing.tally = None
        made.extend((w, n, dv) for w, (n, dv) in tally.items())


def advance(launches) -> None:
    """Count ``launches`` (``[(wrapper, launches, {variant: launches})]``,
    what a capture recorded) as launched: a graph's replay."""
    with _counting:
        for w, n, dv in launches:
            w.launches += n
            for k, v in dv.items():
                w.variant_launches[k] += v


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` (once per source hash) and load it. Threads
    that launch a kernel for the first time together wait for one build."""
    with _building_lock:
        lock = _building.setdefault(name, threading.Lock())
    with lock:
        return _build(name)


@functools.cache
def _build(name: str) -> Built:
    src = CSRC / f"{name}.cu"
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    log = log_path.read_text() if log_path.is_file() else ""
    return Built(ctypes.CDLL(str(out)), out, seconds, log)


def build_all(names) -> dict[str, Built]:
    """Build several kernels at once, one nvcc process each, all started
    together; returns {name: Built}."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))
