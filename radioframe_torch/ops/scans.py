"""Block-scan forms of per-sample recursions (counterpart of
``radioframe/ops/scans.py``):

  - affine:    s[n] = a[n] * s[n-1] + b[n]
  - max-decay: s[n] = max(a[n] * s[n-1], b[n])
  - 2x2 affine: s[n] = A[n] s[n-1] + b[n], s a 2-vector (the biquad's state)

The generic forms are log-step (Hillis-Steele) scans over the time axis:
ceil(log2 T) whole-tensor passes, never a per-sample Python loop. The
constant-coefficient fast paths and their static ``*_ok`` guards are the
reference's, with the same thresholds, so both packages pick the same path
for the same tables.
"""

from __future__ import annotations

import numpy as np
import torch

_AFFINE_CHUNK = 128
_AFFINE_AMIN = 0.93          # a^-(G-1) <= ~1e4 at G=128
_MAXDECAY_RESCALE_LIMIT = 64.0  # max allowed a^-(T-1)


def _log_scan(a, b, combine_b):
    """Inclusive scan of (a, b) pairs along the last axis with the semiring
    (al, bl) . (ar, br) = (al*ar, combine_b(bl, ar, br))."""
    T = a.shape[-1]
    d = 1
    while d < T:
        b = torch.cat([b[..., :d], combine_b(b[..., :-d], a[..., d:], b[..., d:])], dim=-1)
        a = torch.cat([a[..., :d], a[..., :-d] * a[..., d:]], dim=-1)
        d *= 2
    return a, b


def affine2_scan(a, b):
    """Inclusive scan of 2x2 affine maps s -> A[n] s + b[n] along the last
    axis, from a zero state: returns (P, s) with P[n] = A[n] ... A[0] and
    s[n] the state after sample n.

    ``a`` = (a00, a01, a10, a11) and ``b`` = (b0, b1) are the entries as
    separate tensors (..., T); ``a`` may be shared over the batch (e.g.
    (T,) against (C, T) ``b``). The log-step form of ``_log_scan`` with the
    composition (Al, bl) then (Ar, br) = (Ar Al, Ar bl + br) spelt out as
    elementwise products: no matmul, so no TF32 path exists."""
    a00, a01, a10, a11 = a
    b0, b1 = b
    T = b0.shape[-1]
    d = 1
    while d < T:
        r00, r01, r10, r11 = (t[..., d:] for t in (a00, a01, a10, a11))
        l00, l01, l10, l11 = (t[..., :-d] for t in (a00, a01, a10, a11))
        lb0, lb1 = b0[..., :-d], b1[..., :-d]
        b0 = torch.cat([b0[..., :d], r00 * lb0 + r01 * lb1 + b0[..., d:]], dim=-1)
        b1 = torch.cat([b1[..., :d], r10 * lb0 + r11 * lb1 + b1[..., d:]], dim=-1)
        n00 = torch.cat([a00[..., :d], r00 * l00 + r01 * l10], dim=-1)
        n01 = torch.cat([a01[..., :d], r00 * l01 + r01 * l11], dim=-1)
        n10 = torch.cat([a10[..., :d], r10 * l00 + r11 * l10], dim=-1)
        n11 = torch.cat([a11[..., :d], r10 * l01 + r11 * l11], dim=-1)
        a00, a01, a10, a11 = n00, n01, n10, n11
        d *= 2
    return (a00, a01, a10, a11), (b0, b1)


def affine_scan(a, b, s0):
    """s[n] = a[n]*s[n-1] + b[n] along the last axis, s[-1] = s0.

    a, b: (..., T); s0: (...,). Returns s (..., T)."""
    aa, bb = _log_scan(a, b, lambda bl, ar, br: bl * ar + br)
    return bb + aa * s0[..., None]


def maxdecay_scan(a, v, s0):
    """s[n] = max(a[n]*s[n-1], v[n]) along the last axis, s[-1] = s0."""
    aa, vv = _log_scan(a, v, lambda vl, ar, vr: torch.maximum(vl * ar, vr))
    return torch.maximum(vv, aa * s0[..., None])


def first_order_iir(x, pole, zero_num, s0):
    """y[n] = pole*y[n-1] + zero_num[n]; convenience over affine_scan (the
    pole tensor takes ``x``'s shape and dtype)."""
    return affine_scan(torch.full_like(x, pole), zero_num, s0)


def affine_const_ok(a_values) -> bool:
    """Static check: may affine_scan_const take the chunked path for
    coefficients drawn from this table? (zeros allowed — handled exactly)."""
    a = np.asarray(a_values, np.float64).ravel()
    a = a[a != 0.0]
    return bool(a.size == 0 or (a.min() >= _AFFINE_AMIN and a.max() < 1.0))


def maxdecay_const_ok(a_values, T: int) -> bool:
    """Static check: is the global a^{-n} rescale bounded for block length T?"""
    amin = float(np.asarray(a_values, np.float64).min())
    return 0.0 < amin < 1.0 and amin ** -(T - 1) <= _MAXDECAY_RESCALE_LIMIT


def affine_scan_const(a_ch, b, s0, chunk: int = _AFFINE_CHUNK):
    """s[n] = a*s[n-1] + b[n] with a CONSTANT along time: a_ch (...,) per
    channel (may include exact zeros), b (..., T).

    Within a chunk of G samples: an a^{-j} rescale turns the recursion into
    a prefix sum; across chunks: a short scan of the chunk carries. The
    caller must have verified ``affine_const_ok`` on the coefficient table.
    Falls back to affine_scan when T does not chunk."""
    T = b.shape[-1]
    G = chunk
    if T % G != 0 or T < 2 * G:
        return affine_scan(a_ch[..., None].expand(b.shape), b, s0)
    nC = T // G
    sh = tuple(b.shape[:-1])
    j = torch.arange(G, dtype=torch.float32, device=b.device)
    a_safe = torch.clamp_min(a_ch, _AFFINE_AMIN)[..., None]  # (..., 1)
    aji = a_safe ** (-j)     # (..., G)
    ajp = a_safe ** j
    bc = b.reshape(sh + (nC, G)) * aji[..., None, :]
    p = torch.cumsum(bc, dim=-1) * ajp[..., None, :]
    aG = a_safe[..., 0] ** G  # (...,)
    carries = affine_scan(aG[..., None].expand(sh + (nC,)), p[..., -1], s0)
    prev = torch.cat([s0[..., None], carries[..., :-1]], dim=-1)
    s = p + prev[..., None] * (a_safe * ajp)[..., None, :]
    s = s.reshape(sh + (T,))
    # exact zero coefficients: s[n] = b[n] (instant) — restored after the
    # clamped compute so mixed zero/nonzero channel populations stay exact
    return torch.where((a_ch == 0.0)[..., None], b, s)


def maxdecay_scan_const(a_ch, v, s0):
    """s[n] = max(a*s[n-1], v[n]) with a CONSTANT along time (a_ch (...,)).

    Global-rescale form: s = a^n * cummax(v * a^{-n}), the s0 seed folded
    into n=0. Caller must have verified ``maxdecay_const_ok`` for this T."""
    T = v.shape[-1]
    n = torch.arange(T, dtype=torch.float32, device=v.device)
    a = a_ch[..., None]
    w = v * (a ** (-n))
    w = torch.cat([torch.maximum(w[..., :1], (s0 * a_ch)[..., None]), w[..., 1:]], dim=-1)
    return torch.cummax(w, dim=-1).values * (a ** n)
