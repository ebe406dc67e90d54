"""The host side of the port's M-point FFT (``csrc/channelizer.cuh`` ``rf::fft``),
shared by K3, K5, K6 and K9: the radix plan, the per-pass twiddle table the
kernels stage in shared memory, and a plain PyTorch executor that runs the
same passes with the same index maps as the CUDA code.

The transform is a register-resident mixed-radix Stockham FFT (decimation
in time, natural order in and out). For N >= 16 each of T = N/16 threads
holds P = 16 points; for N < 16 one thread holds all N. Thread t owns the
elements t + T*m, m < P, on entry and on exit. The plan is one radix
2^(log2 N mod 4) pass (or none) followed by radix-16 passes, so N = 4096 is
16·16·16 (three passes, two exchanges through shared memory) and N = 1024
is 4·16·16. Pass p with radix R works on sub-transforms of length
L = Ns·R, Ns the product of the earlier radices: butterfly j reads the
pass input at j + r·N/R (r < R), multiplies element r by w_L^(r·k),
k = j mod Ns, takes the R-point DFT and writes its output r to
(j div Ns)·L + k + r·Ns.

Twiddles: for every pass after the first (all radix 16), the table holds
e^{-2 pi i 2^b k / L} for b < 4, k < Ns, built in float64 and stored
complex64, row b contiguous in k so that neighbouring threads read
neighbouring words. A thread forms w^r for the other r by products,
w^r = w^(h) w^(r-h), h the highest power of two <= r.
"""

from __future__ import annotations

import numpy as np
import torch

POINTS = 16  # points per thread, and the radix of every pass after the first
_LOG_R = 4   # log2 of that radix: rows of a pass's twiddle table


def check_size(N: int) -> int:
    """log2 N for a power of two N >= 2; raises otherwise."""
    if N < 2 or N & (N - 1):
        raise ValueError(f"the FFT takes a power of two N >= 2, got {N}")
    return N.bit_length() - 1


def plan(N: int) -> tuple[int, ...]:
    """The radices in pass order: 2^(log2 N mod 4) first where that is not
    1, then radix 16 (N < 16: one pass of radix N)."""
    n = check_size(N)
    if N < POINTS:
        return (N,)
    first = (1 << (n % _LOG_R),) if n % _LOG_R else ()
    return first + (POINTS,) * (n // _LOG_R)


def points_per_thread(N: int) -> int:
    return min(POINTS, N)


def threads(N: int) -> int:
    """Threads that transform one N-point frame."""
    return N // points_per_thread(N)


def pass_spans(N: int) -> list[int]:
    """Ns of each pass: the product of the radices before it."""
    spans, ns = [], 1
    for r in plan(N):
        spans.append(ns)
        ns *= r
    return spans


def twiddles(N: int) -> np.ndarray:
    """The kernels' twiddle table, complex64, flat: for each pass after the
    first, rows b < 4 of e^{-2 pi i 2^b k / (16 Ns)}, k < Ns."""
    rows = []
    for ns in pass_spans(N)[1:]:
        k = np.arange(ns)
        for b in range(_LOG_R):
            rows.append(np.exp(-2j * np.pi * (1 << b) * k / (POINTS * ns)))
    if not rows:
        return np.zeros(0, np.complex64)
    return np.concatenate(rows).astype(np.complex64)


def smem_index(i):
    """Shared-memory slot of exchange element i: one float2 of padding per
    16, so that a half-warp's 8-byte accesses fall on distinct banks."""
    return i + (i >> 4)


def exchange_points(N: int) -> int:
    """float2 words of one frame's exchange buffer."""
    return N + N // 16


def _dft_matrix(R: int) -> torch.Tensor:
    n = np.arange(R)
    return torch.from_numpy(np.exp(-2j * np.pi * np.outer(n, n) / R).astype(np.complex64))


def _powers(base: list[torch.Tensor], R: int) -> list[torch.Tensor]:
    """w^r for r < R from base[b] = w^(2^b), by the kernel's products."""
    w = [torch.ones_like(base[0])] + [None] * (R - 1)
    for r in range(1, R):
        h = 1 << (r.bit_length() - 1)
        w[r] = base[h.bit_length() - 1] if r == h else w[h] * w[r - h]
    return w


def plain_fft(x: torch.Tensor, tw: torch.Tensor | None = None) -> torch.Tensor:
    """The plain executor: the forward DFT over the last dimension of a
    complex64 tensor (N a power of two), computed pass by pass as the
    kernel does, thread by thread (a (..., T, P) register array), with the
    kernel's index maps and twiddle products. ``tw`` is ``twiddles(N)``."""
    N = x.shape[-1]
    radices, spans = plan(N), pass_spans(N)
    P, T = points_per_thread(N), threads(N)
    if tw is None:
        tw = torch.from_numpy(twiddles(N)).to(x.device)
    t = torch.arange(T, device=x.device)[:, None]
    m = torch.arange(P, device=x.device)
    v = x[..., t + T * m]  # thread t's elements t + T m, slot m
    buf = None
    off = 0
    for p, (R, ns) in enumerate(zip(radices, spans)):
        Q = P // R
        q = torch.arange(Q, device=x.device)
        r = torch.arange(R, device=x.device)
        if p == 0:
            # slot q R + r holds element t + T (q + Q r): register renaming
            s_q, s_r = torch.meshgrid(q, r, indexing="ij")
            v = v[..., (s_q + Q * s_r).reshape(-1)]
        else:
            v = buf[..., t + T * m]  # Q = 1: slot r is element t + T r
        j = t + T * q  # (T, Q) butterfly index
        k = j % ns
        vb = v.reshape(*v.shape[:-1], Q, R)
        if p > 0:
            base = [tw[off + b * ns + k] for b in range(_LOG_R)]  # each (T, Q)
            off += _LOG_R * ns
            w = torch.stack(_powers(base, R), dim=-1)  # (T, Q, R)
            vb = vb * w
        vb = vb @ _dft_matrix(R).to(x.device).T  # out[r'] = sum_r W[r', r] in[r]
        if p == len(radices) - 1:
            v = vb.reshape(*vb.shape[:-2], P)  # Q = 1 (or one pass): slot r is t + T r
            break
        dest = ((j // ns) * ns * R + k)[..., None] + r * ns  # (T, Q, R)
        buf = torch.empty_like(x)
        buf[..., dest.reshape(-1)] = vb.reshape(*vb.shape[:-3], T * P)
    out = torch.empty_like(x)
    out[..., (t + T * m).reshape(-1)] = v.reshape(*v.shape[:-2], T * P)
    return out
