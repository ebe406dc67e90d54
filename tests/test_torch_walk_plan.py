"""The host side of the segmented demod/AGC walk
(``radioframe_torch/kernels/walk_plan.py``), whose passes and composition
order ``csrc/channelizer.cuh`` ``rf::agc_walk_all`` mirrors: the segment plan
and the plain executor of the segmented passes.

The executor with S = 1 equals the sequential walk (the kernels' walk before
it was segmented, transcribed frame by frame) bit for bit. With S > 1 it is
held against ``plain_demod_agc`` at small sizes (M = 8-64, F = 32-256, S in
1, 2, 3, 8 and one segment per waterfall line), over all five modes, instant
and nonzero attack, the AGC applied, off and emit_env, ``wf_avg`` 1 and 16,
one frame per segment and two chained blocks; and against the JAX package's
K4, K5 (emit_env) and K6 in Pallas interpret mode. Limits, as chip_smoke.py
holds the kernels: audio 2e-4 after block 0 (pre-gain audio 2e-4 of its
scale; NFM rows modulo fs/deviation = 6.0, 19.2 for K6), the carry rows and
emit_env's env 2e-4 of scale, waterfall 1e-2 dB, power rtol 1e-4; against
the JAX K6 the audio bound of tests/test_torch_ols_demod.py, 3e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.core import config as jcfg
from radioframe.kernels.channelizer_one import FusedChannelizerOne as JOne
from radioframe.kernels.demod_agc import FusedDemodAgc as JDemod
from radioframe.ops.agc import AgcBank as JAgcBank
from radioframe.pipelines import channelizer as jch
from radioframe.pipelines.rx_chain import RxChain as JChain
from radioframe_torch.kernels import walk_plan as wp
from radioframe_torch.kernels.demod_agc import (AGC_APPLY, AGC_EMIT_ENV, AGC_OFF,
                                                FusedDemodAgc, plain_demod_agc)
from radioframe_torch.kernels.ols_demod import FusedOlsDemod, plain_ols_demod
from radioframe_torch.kernels.pfb_dft import plain_pfb_dft
from radioframe_torch.ops.filter_design import pfb_prototype_taps
from radioframe_torch.ops.ols import _framed

torch.set_num_threads(2)

FS_CH = 15_000.0
DEV_HZ = 2500.0
NFM_PERIOD = 6.0   # 15 kHz / 2.5 kHz
TOL = 2e-4
WF_TOL_DB = 1e-2
ATTACK = (dict(release_s=0.5, attack_s=0.002), dict(release_s=0.25, attack_s=0.001),
          dict(release_s=0.8, attack_s=0.005), dict(), dict(release_s=0.5, attack_s=0.002),
          dict(release_s=0.8, attack_s=0.005))
ALL_MODES = (0, 1, 2, 3, 4)
NO_AM = (0, 1, 3, 4)


def _consts(M, agc_modes, modes, fs=FS_CH):
    """(mode, cw_word, rel, al, tgt, mg) as numpy, from the JAX AgcBank."""
    cfgs = (tuple(jcfg.AgcConfig(**a) for a in agc_modes) if agc_modes
            else (jcfg.AgcConfig(),) * 6)
    bank = JAgcBank(cfgs, fs)
    rel, al, tgt, mg = (np.array(v) for v in bank.per_channel(jnp.asarray(modes)))
    return bank, (modes.astype(np.int32), np.full(M, 1234567, np.int32), rel, al, tgt, mg)


def _planes(rng, F, M, blk=0):
    """(F, M) channel planes: a carrier in every channel (rotating, so that
    the NFM discriminator is well conditioned) under unit complex noise; the
    carrier fades in over the first block so that the AGC's release works."""
    f = blk * F + np.arange(F)[:, None]
    amp = 0.2 + 2.0 * np.minimum(1.0, f / 40.0) * (1.0 + 0.5 * np.sin(0.05 * f + np.arange(M)))
    x = amp * np.exp(1j * 0.3 * f * (1 + np.arange(M) % 3))
    x = x + 0.3 * (rng.standard_normal((F, M)) + 1j * rng.standard_normal((F, M)))
    return (torch.from_numpy(x.real.astype(np.float32)),
            torch.from_numpy(x.imag.astype(np.float32)))


def _carry0(M):
    st = torch.zeros((7, M), dtype=torch.float32)
    st[2] = 1.0  # nfm_last starts at 1 + 0j
    return st


def _agc_flags(agc):
    return dict(apply_agc=agc == AGC_APPLY, emit_env=agc == AGC_EMIT_ENV)


def _nfm_mod(d, modes, period):
    d = np.array(d, copy=True)
    rows = modes == 3
    d[:, rows] -= period * np.round(d[:, rows] / period)
    return d


def _scale(a):
    return max(1.0, float(np.abs(np.asarray(a)).max()))


def _close(out_e, out_p, modes, agc, *, audio=True, period=NFM_PERIOD, audio_tol=TOL):
    """Executor outputs against another version's: (audio, power, wf, st_out
    [, env]) as numpy or torch."""
    e = [np.asarray(o) if o is not None else None for o in out_e]
    p = [np.asarray(o) if o is not None else None for o in out_p]
    if audio:
        d = np.abs(_nfm_mod(e[0] - p[0], modes, period))
        lim = audio_tol if agc == AGC_APPLY else audio_tol * _scale(p[0])
        assert d.max() <= lim, f"audio {d.max():.3g} > {lim:.3g}"
    if e[2] is not None and e[2].size:
        db = lambda w: 10 * np.log10(np.maximum(w, 1e-24))  # noqa: E731
        np.testing.assert_allclose(db(e[2]), db(p[2]), atol=WF_TOL_DB, rtol=0)
        np.testing.assert_allclose(e[1], p[1], rtol=1e-4)
    for r in range(7):
        np.testing.assert_allclose(e[3][r], p[3][r], rtol=0, atol=TOL * _scale(p[3][r]),
                                   err_msg=f"carry row {r}")
    if agc == AGC_EMIT_ENV:
        np.testing.assert_allclose(e[4], p[4], rtol=0, atol=TOL * _scale(p[4]))


def _sequential_walk(v, p, mode, rel, al, tgt, mg, st, *, enabled, wf_avg, agc):
    """The per-channel walk frame by frame, as rf::agc_walk ran it before
    segments: one step for all channels at a time, carries in (M,) rows."""
    F, M = v.shape
    en_am = 2 in enabled
    is_am = (mode.long() == 2) & en_am
    bypass = mode.long() == 3
    apply, emit = agc == AGC_APPLY, agc == AGC_EMIT_ENV
    pole = torch.tensor(wp.DC_POLE)
    am_x, am_y, env, lpf, pw = st[0], st[1], st[4], st[5], st[6]
    audio, envs, lines = [], [], []
    wacc = torch.zeros(M)
    for f in range(F):
        out = v[f]
        if en_am:
            e = wp.sqrtf(p[f])
            y = (e - am_x) + pole * am_y
            am_x, am_y = e, y
            out = torch.where(is_am, y, out)
        if apply:
            env = torch.maximum(out.abs(), rel * env)
            lpf = torch.where(al == 0.0, env, al * lpf + (1.0 - al) * env)
            gain = torch.minimum(mg, tgt / torch.clamp_min(lpf, 1e-9))
            out = torch.where(bypass, out, out * gain)
        elif emit:
            env = torch.maximum(out.abs(), rel * env)
        envs.append(env)
        audio.append(out)
        if wf_avg:
            pw = pw + p[f]
            wacc = wacc + p[f]
            if (f + 1) % wf_avg == 0:
                lines.append(wacc / np.float32(wf_avg))
                wacc = torch.zeros(M)
    rows = [am_x if en_am else st[0], am_y if en_am else st[1], st[2], st[3],
            env if apply or emit else st[4], lpf if apply else st[5], pw]
    return (torch.stack(audio), torch.stack(lines) if wf_avg else None, torch.stack(rows),
            torch.stack(envs) if emit else None)


# --- the plan ------------------------------------------------------------------------------


@pytest.mark.parametrize("M,F,wf_avg,items", [
    (4096, 2048, 16, 65536), (4096, 512, 16, 16384), (128, 4096, 0, 33792), (5, 4096, 0, 33792),
    (64, 128, 16, 64), (32, 48, 16, 1 << 20), (8, 37, 1, 100), (4096, 16, 16, 1 << 20)])
def test_default_plan(M, F, wf_avg, items):
    """L is whole lines, S <= lines, S segments of L cover F with a ragged
    last one at most, and the plan fills the launch up to MAX_SEGMENTS."""
    p = wp.plan(M, F, wf_avg, items)
    unit = max(1, wf_avg)
    S, L = p.segments, p.length
    assert L % unit == 0 and 1 <= S <= F // unit
    assert (S - 1) * L < F <= S * L
    assert M * S <= max(items, M) and S <= wp.MAX_SEGMENTS
    cap = min(items // M, wp.MAX_SEGMENTS, F // unit)
    realizable = [s for s in range(1, cap + 1) if -(-F // wp.segment_length(F, s, wf_avg)) == s]
    assert S == max(realizable, default=1)


@pytest.mark.parametrize("F,wf_avg", [(2048, 16), (4096, 0), (512, 16), (96, 1), (80, 16)])
def test_forced_segments(F, wf_avg):
    """Every S the kernels take is reproduced exactly; the others are refused."""
    unit = max(1, wf_avg)
    for S in range(1, F // unit + 1):
        L = wp.segment_length(F, S, wf_avg)
        if -(-F // L) == S:
            assert wp.plan(7, F, wf_avg, 1, segments=S) == wp.WalkPlan(S, L)
        else:
            with pytest.raises(ValueError, match="segment length"):
                wp.plan(7, F, wf_avg, 1, segments=S)


@pytest.mark.parametrize("args,match", [
    ((64, 100, 16, 64), "whole lines"), ((64, 0, 1, 64), "whole lines"),
    ((0, 64, 1, 64), "M >= 1")])
def test_plan_refuses_what_the_kernels_refuse(args, match):
    with pytest.raises(ValueError, match=match):
        wp.plan(*args)


@pytest.mark.parametrize("S", [0, 5])
def test_plan_refuses_segments_outside_the_lines(S):
    with pytest.raises(ValueError, match="segments must be"):
        wp.plan(64, 64, 16, 1024, segments=S)


# K4 (csrc/demod_agc.cu) launches 256-thread blocks, as many as stay resident
# on 132 SMs: its plan at 2, 3 and 4 blocks an SM, at config 5's M = 4096 and
# the sharded two-kernel form's M/D = 1024 (F = 2048, wf_avg 16: 128 lines)
@pytest.mark.parametrize("M,per_sm,S,L", [
    (4096, 2, 16, 128), (4096, 3, 22, 96), (4096, 4, 32, 64), (1024, 3, 64, 32)])
def test_k4_plan_at_its_shapes(M, per_sm, S, L):
    assert wp.plan(M, 2048, 16, 132 * per_sm * 256) == wp.WalkPlan(S, L)


@pytest.mark.parametrize("S", [0, 5, 200])
def test_k4_refuses_the_segments_the_walk_refuses(S):
    """A FusedDemodAgc whose walk_segments is set refuses, on the CPU as on
    the card, what walk_plan.check refuses (F = 64, wf_avg 16: 4 lines; 5
    and 200 are no segmentation of them)."""
    M, F = 8, 64
    k4 = FusedDemodAgc(M, FS_CH, DEV_HZ, wf_avg=16)
    k4.walk_segments = S
    with pytest.raises(ValueError, match="segments"):
        wp.check(F, S, 16)
    zeros = torch.zeros((F, M))
    consts = [torch.zeros(M, dtype=torch.int32)] * 3 + [torch.full((M,), 0.5)] * 4
    with pytest.raises(ValueError, match="segments"):
        k4(zeros, zeros, *consts, _carry0(M))
    k4.walk_segments = 2  # a segmentation it takes: the plain version runs
    assert k4(zeros, zeros, *consts, _carry0(M))[0].shape == (F, M)


def test_scratch_is_four_summary_planes():
    assert wp.scratch(wp.WalkPlan(1, 64), 8, "cpu") is None
    assert wp.scratch(wp.WalkPlan(3, 16), 8, "cpu").shape == (4, 3, 8)


# --- the executor --------------------------------------------------------------------------

AGCS = {"apply": AGC_APPLY, "off": AGC_OFF, "emit_env": AGC_EMIT_ENV}
CASES = [  # (label, agc, attack profiles, enabled modes)
    ("instant", AGC_APPLY, None, ALL_MODES), ("attack", AGC_APPLY, ATTACK, ALL_MODES),
    ("demod_only", AGC_OFF, None, ALL_MODES), ("demod_only_no_am", AGC_OFF, None, NO_AM),
    ("emit_env", AGC_EMIT_ENV, None, NO_AM), ("attack_no_am", AGC_APPLY, ATTACK, NO_AM)]


def _inputs(rng, M, F, agc_modes, blocks=1):
    modes = np.arange(M) % 5
    _, consts = _consts(M, agc_modes, modes)
    return modes, [torch.from_numpy(c) for c in consts], [_planes(rng, F, M, b)
                                                           for b in range(blocks)]


@pytest.mark.parametrize("wf_avg", [1, 16])
@pytest.mark.parametrize("label,agc,agc_modes,enabled", CASES, ids=[c[0] for c in CASES])
def test_one_segment_is_the_sequential_walk(rng, label, agc, agc_modes, enabled, wf_avg):
    """S = 1 is the sequential walk, bit for bit, in every output."""
    M, F = 16, 64
    modes, (mode, word, rel, al, tgt, mg), [(yr, yi)] = _inputs(rng, M, F, agc_modes)
    st = _carry0(M)
    st[4], st[5], st[6] = 0.3, 0.2, 5.0
    v, p, _, _ = wp.demod_values(yr, yi, mode, word, torch.zeros(M, dtype=torch.int32), st,
                                 enabled=enabled, dev_scale=FS_CH / (2 * np.pi * DEV_HZ))
    got = wp.plain_walk(v, p, mode, rel, al, tgt, mg, st, enabled=enabled, wf_avg=wf_avg,
                        agc=agc, segments=1)
    want = _sequential_walk(v, p, mode, rel, al, tgt, mg, st, enabled=enabled, wf_avg=wf_avg,
                            agc=agc)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def _segments(F, wf_avg):
    lines = F // max(1, wf_avg)
    return sorted({s for s in (1, 2, 3, 8, lines) if s <= lines
                   and -(-F // wp.segment_length(F, s, wf_avg)) == s})


@pytest.mark.parametrize("M,F,wf_avg", [(8, 32, 1), (64, 256, 16), (48, 96, 16), (32, 128, 1)])
@pytest.mark.parametrize("label,agc,agc_modes,enabled", CASES, ids=[c[0] for c in CASES])
def test_executor_matches_plain_demod_agc(rng, label, agc, agc_modes, enabled, M, F, wf_avg):
    """Every S (1, 2, 3, 8, one per waterfall line; one frame per segment
    where wf_avg is 1) over two chained blocks against the plain version;
    each side carries its own state."""
    modes, consts, blocks = _inputs(rng, M, F, agc_modes, blocks=2)
    for S in _segments(F, wf_avg):
        st_e = st_p = _carry0(M)
        acc = 0
        for blk, (yr, yi) in enumerate(blocks):
            mode, word, rel, al, tgt, mg = consts
            args = (yr, yi, mode, word, torch.full((M,), acc, dtype=torch.int32), rel, al, tgt,
                    mg)
            out_e = wp.walk_demod_agc(*args, st_e, enabled=enabled, fs=FS_CH,
                                      nfm_deviation_hz=DEV_HZ, wf_avg=wf_avg, agc=agc, segments=S)
            out_p = plain_demod_agc(*args, st_p, enabled=enabled, fs=FS_CH,
                                    nfm_deviation_hz=DEV_HZ, wf_avg=wf_avg, **_agc_flags(agc))
            _close(out_e, out_p, modes, agc, audio=blk > 0)
            st_e, st_p = out_e[3], out_p[3]
            acc = int(np.int64(acc + 1234567 * F).astype(np.int32))


@pytest.mark.parametrize("label,agc,agc_modes,enabled", CASES, ids=[c[0] for c in CASES])
def test_segments_agree_with_each_other(rng, label, agc, agc_modes, enabled):
    """The joins change rounding only: S = 8 and S = 64 (one frame each)
    against S = 1 on one block from a warm carry, every frame held."""
    M, F = 16, 64
    modes, (mode, word, rel, al, tgt, mg), [(yr, yi)] = _inputs(rng, M, F, agc_modes)
    st = _carry0(M)
    st[0], st[1], st[4], st[5], st[6] = 1.5, 0.1, 2.0, 1.8, 3.0
    kw = dict(enabled=enabled, fs=FS_CH, nfm_deviation_hz=DEV_HZ, wf_avg=1, agc=agc)
    args = (yr, yi, mode, word, torch.zeros(M, dtype=torch.int32), rel, al, tgt, mg, st)
    one = wp.walk_demod_agc(*args, segments=1, **kw)
    for S in (8, F):
        _close(wp.walk_demod_agc(*args, segments=S, **kw), one, modes, agc)


def test_release_underflow_at_long_segments(rng):
    """A fast release over long segments: rel^L underflows to 0 in float32,
    and the carry across the join is the segment's own envelope, as in the
    sequential walk (whose chained rel products underflow too)."""
    M, F = 8, 512
    modes, (mode, word, rel, al, tgt, mg), [(yr, yi)] = _inputs(rng, M, F, None)
    rel = torch.full((M,), 0.5)
    assert float(torch.pow(rel, 256.0)[0]) == 0.0
    kw = dict(enabled=ALL_MODES, fs=FS_CH, nfm_deviation_hz=DEV_HZ, wf_avg=16, agc=AGC_APPLY)
    args = (yr, yi, mode, word, torch.zeros(M, dtype=torch.int32), rel, al, tgt, mg, _carry0(M))
    _close(wp.walk_demod_agc(*args, segments=2, **kw), wp.walk_demod_agc(*args, segments=1, **kw),
           modes, AGC_APPLY)


# --- against the JAX kernels (Pallas interpret mode) ------------------------------------------

JAX_CASES = [("instant", AGC_APPLY, None), ("attack", AGC_APPLY, ATTACK),
             ("demod_only", AGC_OFF, None)]


@pytest.mark.parametrize("label,agc,agc_modes", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_executor_matches_jax_k4(rng, label, agc, agc_modes):
    """The executor at S = 8 and S = 3 (ragged last segment) against the
    JAX K4 over two chained blocks, M = 64, F = 64, wf_avg 4."""
    M, F, wf = 64, 64, 4
    modes = (np.arange(M) % 5).astype(np.int32)
    bank, consts = _consts(M, agc_modes, modes)
    kw = dict(wf_avg=wf, enabled=ALL_MODES, apply_agc=agc == AGC_APPLY)
    j = JDemod(M, FS_CH, DEV_HZ, attack_alphas=tuple(bank.alpha.tolist()), interpret=True, **kw)
    j_call = jax.jit(j.__call__)
    blocks = [_planes(rng, F, M, b) for b in range(2)]
    outs_j, st_j, acc = [], np.asarray(_carry0(M)), 0
    for yr, yi in blocks:
        args = (consts[0], consts[1], np.full(M, acc, np.int32), *consts[2:])
        out = j_call(jnp.asarray(yr.numpy()), jnp.asarray(yi.numpy()), *map(jnp.asarray, args),
                     jnp.asarray(st_j))
        outs_j.append(out)
        st_j = np.asarray(out[3])
        acc = int(np.int64(acc + 1234567 * F).astype(np.int32))
    assert -(-F // wp.segment_length(F, 3, wf)) == 3 and F % wp.segment_length(F, 3, wf)
    for S in (8, 3):
        st_e, acc = _carry0(M), 0
        for blk, ((yr, yi), out_j) in enumerate(zip(blocks, outs_j)):
            args = (consts[0], consts[1], np.full(M, acc, np.int32), *consts[2:])
            out_e = wp.walk_demod_agc(yr, yi, *map(torch.from_numpy, args), st_e,
                                      enabled=ALL_MODES, fs=FS_CH, nfm_deviation_hz=DEV_HZ,
                                      wf_avg=wf, agc=agc, segments=S)
            _close(out_e, out_j, modes, agc, audio=blk > 0)
            st_e = out_e[3]
            acc = int(np.int64(acc + 1234567 * F).astype(np.int32))


@pytest.mark.parametrize("agc", [AGC_APPLY, AGC_OFF], ids=["apply", "hang_route"])
def test_executor_matches_jax_k4_at_k4_lines(rng, agc):
    """K4's own form: 16-frame waterfall lines as config 5 has them, the AGC
    applied with nonzero attack or off (the hang route), at S = 3 (L = 48,
    a ragged last segment of 32 frames) and S = 8 (one line a segment),
    against the JAX K4 over two chained blocks, M = 32, F = 128."""
    M, F, wf = 32, 128, 16
    modes = (np.arange(M) % 5).astype(np.int32)
    bank, consts = _consts(M, ATTACK, modes)
    j = JDemod(M, FS_CH, DEV_HZ, attack_alphas=tuple(bank.alpha.tolist()), interpret=True,
               wf_avg=wf, enabled=ALL_MODES, apply_agc=agc == AGC_APPLY)
    j_call = jax.jit(j.__call__)
    blocks = [_planes(rng, F, M, b) for b in range(2)]
    assert wp.check(F, 3, wf) == wp.WalkPlan(3, 48)
    outs = {}
    for S in (None, 3, 8):
        st, acc, outs[S] = _carry0(M), 0, []
        for yr, yi in blocks:
            args = (consts[0], consts[1], np.full(M, acc, np.int32), *consts[2:])
            if S is None:
                out = [np.asarray(o) for o in j_call(jnp.asarray(yr.numpy()),
                                                      jnp.asarray(yi.numpy()),
                                                      *map(jnp.asarray, args),
                                                      jnp.asarray(np.asarray(st)))]
            else:
                out = wp.walk_demod_agc(yr, yi, *map(torch.from_numpy, args), st,
                                        enabled=ALL_MODES, fs=FS_CH, nfm_deviation_hz=DEV_HZ,
                                        wf_avg=wf, agc=agc, segments=S)
            outs[S].append(out)
            st = out[3]
            acc = int(np.int64(acc + 1234567 * F).astype(np.int32))
    for S in (3, 8):
        for blk, (out_e, out_j) in enumerate(zip(outs[S], outs[None])):
            _close(out_e, out_j, modes, agc, audio=blk > 0 or agc == AGC_OFF)


def test_executor_matches_jax_k5_emit_env(rng):
    """The plain polyphase + DFT, then the executor at S = 4 with emit_env
    (AM off), against the JAX K5 emit_env variant over two blocks; M = 32,
    F = 64, wf_avg 4."""
    M, F, K, wf = 32, 64, 8, 4
    modes = np.array([0, 1, 3, 4])[np.arange(M) % 4].astype(np.int32)
    bank, consts = _consts(M, ATTACK, modes)
    kw = dict(wf_avg=wf, enabled=NO_AM, apply_agc=False, emit_env=True)
    j = JOne(M, K, FS_CH, DEV_HZ, attack_alphas=tuple(bank.alpha.tolist()), interpret=True, **kw)
    nat = lambda v: jch.native_order(jnp.asarray(v), j.M1, j.M2)  # noqa: E731
    chan = lambda v: np.asarray(jch.channel_order(v, j.M1, j.M2))  # noqa: E731
    j_call = jax.jit(j.call_planes)
    h = torch.from_numpy(pfb_prototype_taps(M, K, "hamming").reshape(K, M).astype(np.float32))
    tail = np.zeros((1, (K - 1) * M), np.complex64)
    st_j, st_e, acc = np.asarray(_carry0(M)), _carry0(M), 0
    for _ in range(2):
        x = rng.standard_normal((2, F * M)).astype(np.float32)
        args = (consts[0], consts[1], np.full(M, acc, np.int32), *consts[2:])
        out_j = [chan(o) for o in j_call(jnp.asarray(tail), jnp.asarray(x[0]), jnp.asarray(x[1]),
                                          *map(nat, args), nat(st_j))]
        yr, yi = plain_pfb_dft(h, torch.from_numpy(tail), torch.from_numpy(x[0]),
                               torch.from_numpy(x[1]))
        out_e = wp.walk_demod_agc(yr, yi, *map(torch.from_numpy, args), st_e, enabled=NO_AM,
                                  fs=FS_CH, nfm_deviation_hz=DEV_HZ, wf_avg=wf,
                                  agc=AGC_EMIT_ENV, segments=4)
        _close(out_e, out_j, modes, AGC_EMIT_ENV)
        st_j, st_e = out_j[3], out_e[3]
        tail = (x[0] + 1j * x[1])[None, -(K - 1) * M:].astype(np.complex64)
        acc = int(np.int64(acc + 1234567 * F).astype(np.int32))


@pytest.mark.parametrize("attack", [False, True])
def test_executor_matches_k6(rng, attack):
    """K6's back end: the plain overlap-save filter, then the executor at
    S = 8 (wf_avg = 0: no power, row 6 passed through) against the JAX K6
    (audio 3e-4, as tests/test_torch_ols_demod.py) and against the port's
    plain_ols_demod (2e-4), three chained blocks at C = 8, Ta = 1024."""
    C, Ta, fs = 8, 1024, 48_000.0
    period = fs / DEV_HZ
    agc_modes = (jcfg.AgcConfig(release_s=0.5, attack_s=0.002 if attack else 0.0),) * 6
    j = JChain(jcfg.RxConfig(fs_in=1_536_000.0, channels=C,
                             stages=(jcfg.CicStage(R=8, N=4),
                                     jcfg.FirStage(R=4, numtaps=97, passband_hz=15_000.0)),
                             ols_hop=512, enabled_modes=(0, 1, 2, 3), agc_modes=agc_modes,
                             fuse_backend=True))
    jk = j.backend_kernel
    tk = FusedOlsDemod(jk.nfft, jk.hop, C, fs, DEV_HZ, enabled=(0, 1, 2, 3))
    modes = (np.arange(C) % 4).astype(np.int32)
    h_sel = np.asarray(j.mode_bank._H)[modes]
    rel, al, tgt, mg = (np.asarray(a) for a in j.agc_bank.per_channel(jnp.asarray(modes)))
    assert bool((al != 0).any()) == attack
    cw_word = np.full(C, j.cw_tone_word, np.int32)
    L1 = jk.nfft - jk.hop
    tail = np.zeros((C, L1), np.complex64)
    st_j = st_p = st_e = _carry0(C)
    tail_p = torch.from_numpy(tail)
    cw_acc = np.zeros(C, np.int32)
    call_j = jax.jit(jk.__call__)
    keep = np.ones((7, C), bool)
    keep[4:6, modes == 3] = False  # the envelope of an NFM row latches branch flips
    for blk in range(3):
        t = (blk * Ta + np.arange(Ta)) / fs
        x = np.exp(2j * np.pi * (1000.0 + 37.0 * np.arange(C))[:, None] * t)
        x = (x + 0.05 * (rng.standard_normal((C, Ta)) + 1j * rng.standard_normal((C, Ta))))
        x = x.astype(np.complex64)
        args = (x, h_sel, modes, cw_word, cw_acc, rel, al, tgt, mg)
        a_j, st_j, tail_j = call_j(jnp.asarray(tail), *map(jnp.asarray, args),
                                   jnp.asarray(np.asarray(st_j)))
        targs = [torch.from_numpy(np.array(a)) for a in args]
        a_p, st_p, tail_p_next = plain_ols_demod(tk, tail_p, *targs, st_p)
        frames, _ = _framed(tail_p, targs[0], jk.hop, jk.nfft, L1 + 1)
        y = torch.fft.ifft(torch.fft.fft(frames, dim=-1) * targs[1][:, None, :], dim=-1)
        s = y[..., L1:].reshape(C, Ta).T
        a_e, _, _, st_e = wp.walk_demod_agc(
            s.real.contiguous(), s.imag.contiguous(), *targs[2:], st_e, enabled=(0, 1, 2, 3),
            fs=fs, nfm_deviation_hz=DEV_HZ, wf_avg=0, agc=AGC_APPLY, segments=8)
        if blk > 0:
            for ref, tol in ((np.asarray(a_j), 3e-4), (a_p.numpy(), TOL)):
                d = np.abs(_nfm_mod((a_e.T.numpy() - ref).T, modes, period))
                assert d.max() <= tol, f"block {blk}: audio {d.max():.3g}"
        for ref in (np.asarray(st_j), st_p.numpy()):
            scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1.0)
            err = np.where(keep, (st_e.numpy() - ref) / scale, 0.0)
            assert np.abs(err).max() <= TOL, f"block {blk}: carry {np.abs(err).max():.3g}"
        np.testing.assert_array_equal(st_e[6].numpy(), st_p[6].numpy())  # row 6 passed through
        tail, tail_p = np.asarray(tail_j), tail_p_next
        cw_acc = ((cw_acc.astype(np.int64) + cw_word.astype(np.int64) * Ta + 2 ** 31) % 2 ** 32
                  - 2 ** 31).astype(np.int32)
