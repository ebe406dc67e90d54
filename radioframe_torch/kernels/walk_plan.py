"""The host side of the per-channel demod/AGC walk (``csrc/channelizer.cuh``
``rf::agc_walk_all``), shared by K4, K5 and K6: the time-segment plan, and a
plain PyTorch executor of the segmented passes with the same summaries, the
same composition order and the same per-pass work as the CUDA code, as
``fft_plan.py`` is for ``rf::fft``. It also holds the constants the kernels'
wrappers share (``demod_agc`` takes them from here, so that neither module
imports the other's importer).

The walk's recurrences, per channel and frame in order: the AM DC block
y = (sqrt(p) - x_prev) + pole y_prev, the AGC release env = max(|a|, rel env),
the attack lpf = al lpf + (1 - al) env (lpf = env where al = 0), the gain
min(mg, tgt / max(lpf, 1e-9)) (not on NFM channels), the power sum and the
``wf_avg``-frame waterfall lines. Each channel's F frames are cut into S
segments of L frames, L a multiple of ``wf_avg`` (so no waterfall line
straddles a join), the last segment possibly shorter. A (channel, segment)
item walks its segment from zero to form a summary; the carry into segment
s is composed from the summaries of segments 0..s-1:

    AM x_prev  sqrt(p[sL - 1]), read directly (carry row 0 for s = 0)
    AM y       y_in(s+1)   = pole^L y_in(s) + y_loc(s)
    release    env_in(s+1) = max(env_loc(s), rel^L env_in(s))
    attack     lpf_in(s+1) = al^L lpf_in(s) + lpf_loc(s)    (al != 0 only)
    power      row 6 = partial(0) + ... + partial(S-1), partial(0) from row 6

Passes, each ended by a grid barrier on the card: ``summary`` (S > 1 with AM
enabled, or with power and no release pass: y_loc and the power partials),
``release`` (S > 1 under AGC_APPLY or AGC_EMIT_ENV: env_loc, and the power
partials if the summary pass did not run), ``attack`` (S > 1, AGC_APPLY,
some channel with al != 0: lpf_loc) and ``final`` (audio, env, waterfall,
the carry). With S = 1 only ``final`` runs: the sequential walk. rel^L, al^L
and pole^L are float32 powers (``powf`` on the card).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from radioframe_torch.kernels import _build
from radioframe_torch.ops import demod as demod_op

CW_SCALE = float(np.float32(2.0 * np.pi / 2.0 ** 32))  # int32 Q0.32 turns -> radians
# what the kernels' per-channel walk does after the demod (enum Agc in
# csrc/channelizer.cuh): nothing, the full AGC, or K5's release env alone
AGC_OFF, AGC_APPLY, AGC_EMIT_ENV = 0, 1, 2

# zeroed words the walk takes after a kernel's own barriers: a grid barrier
# for each pass before the last, then the attack flag (rf::kWalkCounters)
WALK_COUNTERS = 4
# the most segments the default plan takes: K6's walk (C = 128, Ta = 4096)
# was fastest at S = 128 in probe_frontend.py's sweep on an H100 (device time
# 0.0910 ms, against 0.0994 at 64 and 0.0925 at 256); K4's and K5's plans are
# capped by their launches' threads first (S = 22 and 16 at M = 4096)
MAX_SEGMENTS = 128
DC_POLE = np.float32(demod_op.DC_POLE)


@dataclass(frozen=True)
class WalkPlan:
    segments: int  # S
    length: int    # L, frames per segment (the last may have fewer)


def _unit(wf_avg: int) -> int:
    return wf_avg if wf_avg > 0 else 1


def segment_length(F: int, S: int, wf_avg: int) -> int:
    """Frames per segment: ceil(lines / S) whole waterfall lines
    (rf::walk_length)."""
    unit = _unit(wf_avg)
    return unit * -(-(F // unit) // S)


def check(F: int, S: int, wf_avg: int) -> WalkPlan:
    """The plan of S segments over F frames; raises ValueError where the
    kernels refuse it (rf::walk_plan_ok): F not whole lines of ``wf_avg``
    frames, S outside 1..lines, or no segment length that gives S segments."""
    unit = _unit(wf_avg)
    if F < 1 or F % unit:
        raise ValueError(f"the walk takes F >= 1 whole lines of {unit} frames, got F={F}")
    lines = F // unit
    if not 1 <= S <= lines:
        raise ValueError(f"segments must be in 1..{lines} (F={F}, wf_avg={wf_avg}), got {S}")
    L = segment_length(F, S, wf_avg)
    if -(-F // L) != S:
        raise ValueError(f"no segment length gives {S} segments of whole {unit}-frame lines "
                         f"over F={F} (L={L} gives {-(-F // L)})")
    return WalkPlan(S, L)


def plan(M: int, F: int, wf_avg: int, items: int, segments: int | None = None) -> WalkPlan:
    """The segments for M channels over F frames on a launch of ``items``
    threads: the given ``segments`` (checked), else the most that keep
    M S <= items and S <= MAX_SEGMENTS."""
    if M < 1:
        raise ValueError(f"the walk takes M >= 1 channels, got {M}")
    if segments is not None:
        return check(F, int(segments), wf_avg)
    check(F, 1, wf_avg)
    lines = F // _unit(wf_avg)
    cap = max(1, min(items // M, MAX_SEGMENTS, lines))
    # the largest realizable S <= cap: k lines a segment gives ceil(lines / k)
    return check(F, -(-lines // -(-lines // cap)), wf_avg)


@functools.cache
def launch_threads(source: str, device: int, *shape: int, entry: str | None = None) -> int:
    """Threads (grid times block) of the launch of kernel ``source`` at
    ``shape`` on CUDA device ``device`` (the current one when called), as its
    C entry ``rf_<source>_threads`` (or ``entry``, for another form of the
    kernel) reports them: the plan's ``items``."""
    fn = getattr(_build.build(source).lib, entry or f"rf_{source}_threads")
    fn.argtypes = [ctypes.c_int] * len(shape) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    rc = fn(*shape, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"{source} launch query failed: CUDA error {rc}")
    return n.value


def scratch(p: WalkPlan, M: int, device) -> torch.Tensor | None:
    """The (4, S, M) summaries (AM y, release env, attack lpf, power), or
    None when S = 1."""
    if p.segments == 1:
        return None
    return torch.empty((4, p.segments, M), dtype=torch.float32, device=device)


def demod_values(yr, yi, mode, cw_word, cw_acc, st_in, *, enabled, dev_scale: float):
    """The kernels' phase one on (F, M) planes (rf::demod_value): the demod
    value before the AM DC block and the AGC (2 Re for SSB/LSB, the CW beat at
    the DDS angle cw_acc + cw_word f, the NFM discriminator against the
    previous frame, 0 for AM and disabled modes), |X|^2, and the NFM carry
    (the last frame, or carry rows 2-3 when NFM is off). Returns
    (v, p, nfm_re, nfm_im)."""
    F, M = yr.shape
    mode = mode.to(torch.int64)
    on = torch.zeros(M, dtype=torch.bool, device=yr.device)
    for m in enabled:
        on |= mode == m
    pr = torch.cat([st_in[2:3], yr[:-1]])
    pi = torch.cat([st_in[3:4], yi[:-1]])
    f = torch.arange(F, dtype=torch.int64, device=yr.device)[:, None]
    theta = (cw_acc.to(torch.int64) + cw_word.to(torch.int64) * f + 2 ** 31) % 2 ** 32 - 2 ** 31
    ang = theta.to(torch.float32) * np.float32(CW_SCALE)
    cw = 2.0 * (yr * torch.cos(ang) - yi * torch.sin(ang))
    nfm = torch.atan2(yi * pr - yr * pi, yr * pr + yi * pi) * np.float32(dev_scale)
    v = torch.zeros_like(yr)
    v = torch.where(mode == demod_op.SSB, 2.0 * yr, v)
    v = torch.where(mode == demod_op.LSB, 2.0 * yr, v)
    v = torch.where(mode == demod_op.CW, cw, v)
    v = torch.where(mode == demod_op.NFM, nfm, v)
    v = torch.where(on, v, 0.0)
    p = yr * yr + yi * yi
    if demod_op.NFM in enabled:
        return v, p, yr[-1], yi[-1]
    return v, p, st_in[2], st_in[3]


def sqrtf(x):
    """float32 square root correctly rounded, as CUDA's ``sqrtf`` (torch's
    float32 CPU sqrt is not): in float64, then rounded once to float32, which
    is exact for a square root."""
    return torch.sqrt(x.double()).float()


def _compose_affine(x0, a, L: int, summ):
    """(S, M) carries into each segment: x <- a^L x + summ[s]."""
    aL = torch.pow(a, float(L))
    out, x = [x0], x0
    for s in range(summ.shape[0] - 1):
        x = aL * x + summ[s]
        out.append(x)
    return torch.stack(out)


def _compose_maxdecay(x0, r, L: int, summ):
    """(S, M) carries into each segment: x <- max(summ[s], r^L x)."""
    rL = torch.pow(r, float(L))
    out, x = [x0], x0
    for s in range(summ.shape[0] - 1):
        x = torch.maximum(summ[s], rL * x)
        out.append(x)
    return torch.stack(out)


def plain_walk(v, p, mode, rel, al, tgt, mg, st_in, *, enabled, wf_avg: int, agc: int,
               segments: int):
    """The segmented walk over (F, M) phase-one planes ``v`` and ``p``, all S
    segments at once (items as (S, M) tensors), pass by pass as the kernel
    runs them. Returns (audio (F, M), wf (F/wf_avg, M) or None,
    st_out (7, M) with rows 2-3 passed through, env (F, M) or None)."""
    F, M = v.shape
    plan_ = check(F, int(segments), wf_avg)
    S, L = plan_.segments, plan_.length
    dev = v.device
    st = st_in.to(torch.float32)
    en_am = demod_op.AM in enabled
    is_am = (mode.to(torch.int64) == demod_op.AM) & en_am
    bypass = mode.to(torch.int64) == demod_op.NFM
    aux = wf_avg > 0
    apply, emit = agc == AGC_APPLY, agc == AGC_EMIT_ENV
    pad = S * L - F
    vs = torch.nn.functional.pad(v, (0, 0, 0, pad)).reshape(S, L, M)
    ps = torch.nn.functional.pad(p, (0, 0, 0, pad)).reshape(S, L, M)
    valid = (torch.arange(S * L, device=dev) < F).reshape(S, L, 1)
    first = (torch.arange(S, device=dev) == 0)[:, None]
    x0 = torch.cat([st[0:1], sqrtf(p[L - 1:(S - 1) * L:L])])  # AM x_prev into each segment
    zeros = torch.zeros((S, M), dtype=torch.float32, device=dev)
    pole = torch.tensor(DC_POLE, device=dev)

    def walk(y, env, lpf, pw, *, dc, release, attack, power, final):
        """Walk every segment from the given (S, M) carries."""
        x = x0
        audio, envs, lines = [], [], []
        wacc = zeros
        for i in range(L):
            ok = valid[:, i]
            out = vs[:, i]
            if dc:
                e = sqrtf(ps[:, i])
                y_new = (e - x) + pole * y
                x, y = torch.where(ok, e, x), torch.where(ok, y_new, y)
                out = torch.where(is_am, y_new, out)
            if release:
                env = torch.where(ok, torch.maximum(out.abs(), rel * env), env)
            if attack:
                lpf = torch.where(ok, torch.where(al == 0.0, env, al * lpf + (1.0 - al) * env),
                                  lpf)
            if power:
                pw = torch.where(ok, pw + ps[:, i], pw)
            if not final:
                continue
            if apply:
                gain = torch.minimum(mg, tgt / torch.clamp_min(lpf, 1e-9))
                out = torch.where(bypass, out, out * gain)
            audio.append(out)
            envs.append(env)
            if aux:
                wacc = wacc + ps[:, i]
                if (i + 1) % wf_avg == 0:
                    lines.append(wacc / np.float32(wf_avg))
                    wacc = zeros
        return x, y, env, lpf, pw, audio, envs, lines

    release = S > 1 and (apply or emit)
    summary = S > 1 and (en_am or (aux and not release))
    pw0 = torch.where(first, st[6], 0.0)
    sum_y = sum_pw = sum_env = sum_lpf = None
    if summary:
        _, sum_y, _, _, sum_pw, *_ = walk(zeros, zeros, zeros, pw0, dc=en_am, release=False,
                                          attack=False, power=aux, final=False)
    y_in = _compose_affine(st[1], pole, L, sum_y) if sum_y is not None else st[1].expand(S, M)
    attack_on = False
    if release:
        _, _, sum_env, _, pw, *_ = walk(y_in, zeros, zeros, pw0, dc=en_am, release=True,
                                        attack=False, power=aux and not summary, final=False)
        if not summary:
            sum_pw = pw
        attack_on = apply and bool((al != 0.0).any())
    env_in = (_compose_maxdecay(st[4], rel, L, sum_env) if sum_env is not None
              else st[4].expand(S, M))
    if attack_on:
        _, _, _, sum_lpf, *_ = walk(y_in, env_in, zeros, zeros, dc=en_am, release=True,
                                    attack=True, power=False, final=False)
    lpf_in = st[5].expand(S, M)
    if sum_lpf is not None:
        lpf_in = torch.where(al != 0.0, _compose_affine(st[5], al, L, sum_lpf), lpf_in)
    x, y, env, lpf, pw, audio, envs, lines = walk(
        y_in, env_in, lpf_in, pw0, dc=en_am, release=apply or emit, attack=apply,
        power=aux and S == 1, final=True)
    audio = torch.stack(audio, dim=1).reshape(S * L, M)[:F]
    env_out = torch.stack(envs, dim=1).reshape(S * L, M)[:F] if emit else None
    wf = None
    if aux:
        wf = torch.stack(lines, dim=1).reshape(-1, M)[:F // wf_avg]
        if S > 1:  # row 6: the partials in segment order
            pw = sum_pw[0]
            for s in range(1, S):
                pw = pw + sum_pw[s]
        else:
            pw = pw[0]
    rows = [x[-1] if en_am else st[0], y[-1] if en_am else st[1], st[2], st[3],
            env[-1] if apply or emit else st[4], lpf[-1] if apply else st[5],
            pw if aux else st[6]]
    return audio, wf, torch.stack(rows), env_out


def walk_demod_agc(yr, yi, mode, cw_word, cw_acc, rel, al, tgt, mg, st_in, *, enabled,
                   fs: float, nfm_deviation_hz: float, wf_avg: int, agc: int, segments: int):
    """Phase one (``demod_values``) and the segmented walk over (F, M)
    planes: the kernels' back end as the CUDA code computes it. Returns
    (audio (F, M), power (M,), wf (F/wf_avg, M), st_out (7, M)) and, under
    AGC_EMIT_ENV, env (F, M), as ``plain_demod_agc``; with ``wf_avg`` = 0 no
    power sum and no waterfall (row 6 passed through, wf None)."""
    dev_scale = fs / (2.0 * math.pi * nfm_deviation_hz)
    v, p, nre, nim = demod_values(yr, yi, mode, cw_word, cw_acc, st_in, enabled=enabled,
                                  dev_scale=dev_scale)
    audio, wf, st_out, env = plain_walk(v, p, mode, rel, al, tgt, mg, st_in, enabled=enabled,
                                        wf_avg=wf_avg, agc=agc, segments=segments)
    st_out = torch.cat([st_out[:2], torch.stack([nre, nim]), st_out[4:]])
    out = (audio, st_out[6], wf, st_out)
    return out + (env,) if agc == AGC_EMIT_ENV else out
