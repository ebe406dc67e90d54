"""The host side of the channelizer's polyphase stage on the card, shared by
K3 (``csrc/pfb_dft.cu``) and K9's pfb_only: the plans of their runs of
frames and the resources each launch takes on the card (``occupancy``, also
read for K5), as ``fft_plan.py`` is for ``rf::fft`` and ``walk_plan.py`` for
the walk.

The stage: u[f][p] = sum_{k<K} h[k][p] x(f - k)[p], k = 0 first. A thread
walks P = 2 columns p down the frames (``rf::PfbColumns``), Q = 8 frames a
step, so that each input sample is read from device memory once per run of
frames, not K times (``execute`` runs either schedule in plain PyTorch).
K3 (``plan``) launches clusters of C = 8 CTAs of B =
max(32, M/16) threads (G = B / (M/16) FFT frame groups a CTA); a cluster
walks a run of L frames in steps of C G frames: CTA r computes the
polyphase of its M/C columns of every frame of the step and stores frame j's
columns into the FFT exchange buffer of group j mod G of CTA j div G
(distributed shared memory); each group then runs ``rf::fft`` on its whole
frame. The history of a thread's columns waits in shared memory between
steps (K - 1 frames), so that two CTAs share an SM. L is a multiple of C G;
the runs are as many as the card keeps clusters resident. K9's pfb_only
(``columns_plan``) walks the columns with no cluster, straight to device
memory. (K5's phase one keeps its frame-by-frame polyphase: the cluster walk
measured slower there; PERF.md.)
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from radioframe_torch.kernels import _build, fft_plan

CLUSTER = 8          # CTAs of a cluster (rf::kPfbCluster; the portable most)
POINTS = 2           # columns a thread walks (rf::kPfbPoints)
FRAMES = 8           # frames a thread takes a step (rf::kPfbFrames)
MAX_TAPS = 16        # the kernels' window holds 8 or 16 taps
MIN_M, MAX_M = 16, 8192
SMEM_LIMIT = 227 * 1024    # dynamic shared memory one Hopper block may use
COLUMN_THREADS = 256       # pfb_only's blocks
COLUMN_BLOCKS_PER_SM = 2   # their runs: about this many blocks an SM
# rf::occupancy's values, in order
OCCUPANCY = ("registers", "blocks_per_sm", "clusters", "cluster", "threads", "smem",
             "local_bytes", "sms")


@dataclass(frozen=True)
class PfbPlan:
    M: int
    K: int
    F: int
    cluster: int      # C, CTAs of a cluster (1: the column walk)
    threads: int      # B, threads of a CTA
    groups: int       # G, FFT frame groups of a CTA
    lanes: int        # J, threads that walk one column set of a CTA (each Q frames a step)
    step: int         # frames a cluster (or a block) takes a step: C G = Q J
    runs: int         # clusters (or rows of column blocks) launched, a run of frames each
    run_length: int   # L, frames a run (a multiple of ``step``; the last run cut at F)
    smem: int         # dynamic shared memory a CTA, bytes
    taps: int         # KW, the window's tap capacity (8 or 16)
    grid: int         # CTAs launched


def taps_width(K: int) -> int:
    """KW, the window's tap capacity for K taps; raises beyond MAX_TAPS."""
    if not 1 <= K <= MAX_TAPS:
        raise ValueError(f"the card's polyphase stage takes 1 <= K <= {MAX_TAPS} taps, got {K}")
    return 8 if K <= 8 else 16


def check_channels(M: int) -> None:
    """M a power of two in [MIN_M, MAX_M]: the columns split into P per
    thread over C CTAs and M/16 FFT threads a frame."""
    if M < MIN_M or M > MAX_M or M & (M - 1):
        raise ValueError(f"the card's polyphase stage takes a power-of-two M in "
                         f"[{MIN_M}, {MAX_M}], got {M}")


def cluster_threads(M: int) -> int:
    return max(32, fft_plan.threads(M))


@functools.cache
def _twiddle_words(M: int) -> int:
    return len(fft_plan.twiddles(M))


def smem_bytes(M: int, taps: int = 8) -> int:
    """A K3 cluster CTA's dynamic shared memory: the FFT's twiddle table, G
    exchange buffers (where the cluster delivers the frames) and the history
    ring (``taps`` - 1 frames of the CTA's M/C columns)."""
    G = cluster_threads(M) // fft_plan.threads(M)
    return 8 * (_twiddle_words(M) + G * fft_plan.exchange_points(M)
                + (taps - 1) * (M // CLUSTER))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _runs(F: int, step: int, most: int) -> tuple[int, int]:
    """(runs, run length): at most ``most`` runs of a whole number of steps
    covering F, as even as that allows."""
    if F < 1:
        raise ValueError(f"the stage takes F >= 1 frames, got {F}")
    if most < 1:
        raise ValueError("the card keeps nothing of this launch resident")
    runs = min(most, _ceil(F, step))
    L = step * _ceil(_ceil(F, runs), step)
    return _ceil(F, L), L


def plan(M: int, K: int, F: int, clusters: int) -> PfbPlan:
    """The cluster plan of K3 at M channels, K taps, F frames, with
    ``clusters`` resident clusters on the card (``occupancy``'s). Raises
    ValueError where the kernel refuses."""
    check_channels(M)
    KW = taps_width(K)
    T = fft_plan.threads(M)
    B = cluster_threads(M)
    G = B // T
    npt = M // CLUSTER // POINTS
    J = B // npt
    step = CLUSTER * G
    if step != FRAMES * J:
        raise AssertionError(f"M={M}: a step of {step} frames is not {J} lanes of {FRAMES}")
    smem = smem_bytes(M, KW)
    if smem > SMEM_LIMIT:
        raise ValueError(f"M={M}: {smem} B of shared memory a CTA, more than {SMEM_LIMIT}")
    runs, L = _runs(F, step, clusters)
    return PfbPlan(M, K, F, CLUSTER, B, G, J, step, runs, L, smem, KW, runs * CLUSTER)


def columns_plan(M: int, K: int, F: int, sms: int) -> PfbPlan:
    """The plan of K9's pfb_only: blocks of COLUMN_THREADS
    (M/P when fewer) threads walking P columns each, no cluster; as many runs
    as give COLUMN_BLOCKS_PER_SM blocks an SM, each a whole number of Q-frame
    steps."""
    check_channels(M)
    KW = taps_width(K)
    B = min(COLUMN_THREADS, M // POINTS)
    per_row = M // (B * POINTS)
    runs, L = _runs(F, FRAMES, max(1, COLUMN_BLOCKS_PER_SM * sms // per_row))
    return PfbPlan(M, K, F, 1, B, 1, 1, FRAMES, runs, L, 0, KW, runs * per_row)


@functools.cache
def occupancy(source: str, device: int, *shape: int) -> dict:
    """The resources of kernel ``source``'s launch at ``shape`` on CUDA
    device ``device`` (the current one when called), from its C entry
    ``rf_<source>_occupancy``: {name: value} over OCCUPANCY."""
    fn = getattr(_build.build(source).lib, f"rf_{source}_occupancy")
    fn.argtypes = [ctypes.c_int] * len(shape) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(OCCUPANCY))()
    rc = fn(*shape, out)
    if rc != 0:
        raise RuntimeError(f"{source} occupancy query failed: CUDA error {rc}")
    return dict(zip(OCCUPANCY, out))


def check_occupancy(p: PfbPlan, occ: dict) -> None:
    """The card's view of the launch agrees with the plan's (threads,
    shared memory, cluster size); raises RuntimeError where it does not."""
    want = {"threads": p.threads, "smem": p.smem, "cluster": p.cluster if p.cluster > 1 else 0}
    got = {k: occ[k] for k in want}
    if got != want:
        raise RuntimeError(f"the kernel's launch {got} is not the plan's {want}")


def bytes_read(p: PfbPlan) -> int:
    """Input bytes the stage loads from device memory: each run's frames
    and the K - 1 frames before it (8 B a complex sample)."""
    return 8 * p.M * sum(min(p.run_length, p.F - r * p.run_length) + p.K - 1
                         for r in range(p.runs))


def execute(p: PfbPlan, h, tail, xr, xi):
    """The stage in the kernels' order, in plain PyTorch: the runs of ``p``,
    each in steps; for a cluster plan, CTA r's M/C columns walked by its
    lanes (lane l: the step's frames l Q .. l Q + Q - 1, its history
    reloaded unless it walks the whole step, then carried from the last
    step), each frame delivered to group j mod G of CTA j div G; for a
    column plan, every column walked down the run, its history carried. Each
    sum k = 0 first (the kernels' order, their fmaf here a product and an
    add, as ``ops.pfb.polyphase_frames``). Returns (ur, ui) (F, M), every
    frame written once (checked)."""
    K, M = h.shape
    if (p.M, p.K) != (M, K) or xr.shape[-1] != p.F * M:
        raise ValueError(f"the plan is for M={p.M}, K={p.K}, F={p.F}")
    H, Q = p.taps - 1, FRAMES
    rows = torch.complex(torch.cat([tail[0].real, xr.to(torch.float32)]),
                         torch.cat([tail[0].imag, xi.to(torch.float32)])).reshape(-1, M)

    def sample(g, cols):  # frame g (the tail's before 0, zero before it)
        if g < 1 - K:
            return torch.zeros(len(cols), dtype=torch.complex64)
        return rows[g + K - 1, cols]

    def walk(w, cols, q):  # u of the window's frame H + q
        u = torch.zeros(len(cols), dtype=torch.complex64)
        for k in range(K):
            x = w[H + q - k]
            u = torch.complex(u.real + h[k, cols] * x.real, u.imag + h[k, cols] * x.imag)
        return u

    out = torch.full((p.F, M), float("nan"), dtype=torch.complex64)
    C = p.cluster
    parts = [torch.arange(r * (M // C), (r + 1) * (M // C)) for r in range(C)]
    for run in range(p.runs):
        fa, fb = run * p.run_length, min((run + 1) * p.run_length, p.F)
        ring = {}
        for f0 in range(fa, fb, p.step):
            for r, cols in enumerate(parts):
                for lane in range(p.lanes):
                    fl = f0 + lane * Q
                    if f0 == fa or p.lanes > 1:  # zero from fb on, as the kernel
                        hist = [sample(fl - H + j, cols) if fl - H + j < fb
                                else torch.zeros(len(cols), dtype=torch.complex64)
                                for j in range(H)]
                    else:
                        hist = ring[r]
                    w = hist + [sample(fl + q, cols) if fl + q < fb
                                else torch.zeros(len(cols), dtype=torch.complex64)
                                for q in range(Q)]
                    for q in range(Q):
                        f = fl + q  # step frame j = lane Q + q: group j mod G of CTA j div G
                        if f < fb:
                            if not torch.isnan(out[f, cols].real).all():
                                raise AssertionError(f"frame {f} written twice")
                            out[f, cols] = walk(w, cols, q)
                    if p.lanes == 1:
                        ring[r] = w[Q:Q + H]
    if torch.isnan(out.real).any():
        raise AssertionError("a frame no run wrote")
    return out.real.contiguous(), out.imag.contiguous()

