"""Fused demod bank + AGC for the channelizer back end (counterpart of
``radioframe/kernels/demod_agc.py``, kernel K4).

``FusedDemodAgc.__call__`` launches the hand-written CUDA C++ kernel
``csrc/demod_agc.cu`` for CUDA tensors and runs the plain PyTorch version
``plain_demod_agc`` for CPU tensors. For a CUDA tensor it launches or
raises: there is no fallback. ``launches`` counts kernel launches. The
kernel's per-channel walk runs in S time segments planned by
``walk_plan.plan`` from the launch's thread count (``walk_segments`` fixes
S; ``last_plan`` is the last launch's), as K5's and K6's do.

Modes SSB, CW, AM, NFM and LSB; attack/release AGC with per-channel
constants gathered on the host (no hang: the chain routes hang AGC through
``apply_agc=False`` and the dense ``AgcBank``). Channels are in channel
order. The reference's TPU gate on ``num_channels % 128`` is gone; its frame
tile cap (``max_tf``), which bounds ``waterfall_frame_avg`` and the release
rescale guard, stays so that the port accepts what the reference accepts.

The 7-row carry: [0] am x_prev, [1] am y_prev, [2] nfm re, [3] nfm im,
[4] release env, [5] attack lpf, [6] power sum.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch import nn

from radioframe_torch.kernels import _build, walk_plan
# the shared constants live in walk_plan (which imports nothing of this
# module) and are importable from here as before
from radioframe_torch.kernels.walk_plan import (AGC_APPLY, AGC_EMIT_ENV,  # noqa: F401
                                                AGC_OFF, CW_SCALE)
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops.scans import affine_scan, maxdecay_scan


def release_decays_ok(release_values, max_tf: int) -> bool:
    """The reference's rescale-boundedness guard for its in-kernel release:
    rel**(-(max_tf-1)) <= 64. The port's kernel walks the release exactly and
    needs no bound; the chain keeps the guard so that it refuses what the
    reference refuses."""
    rmin = float(np.min(np.asarray(release_values, np.float64)))
    return 0.0 < rmin < 1.0 and rmin ** -(max_tf - 1) <= 64.0


def check_modes(enabled) -> frozenset:
    en = frozenset(map(int, enabled))
    if demod_op.SAM in en:
        raise AssertionError("SAM needs whole-block statistics: use the dense bank")
    return en


def check_wf_avg(wf_avg: int, max_tf: int, M: int) -> int:
    """``waterfall_frame_avg`` must be a power of two within the reference's
    frame-tile cap; returns max(1, wf_avg)."""
    avg = max(1, int(wf_avg))
    if (avg & (avg - 1)) or avg > max_tf:
        raise ValueError(
            f"waterfall_frame_avg={avg} must be a power of two <= {max_tf} (the reference "
            f"kernel's frame-tile cap at M={M}); use the dense waterfall_from_pfb path for "
            "other averaging factors")
    return avg


def plain_demod_agc(yr, yi, mode, cw_word, cw_acc, rel, al, tgt, mg, st_in, *, enabled,
                    fs: float, nfm_deviation_hz: float, wf_avg: int, apply_agc: bool,
                    emit_env: bool = False):
    """The plain PyTorch version of the kernel, on the (M, F) transpose:
    ``ops/demod.bank_apply`` over the enabled modes, the release max-decay
    and attack one-pole scans with the per-channel constants, the gain clip
    with the NFM bypass, power and frame-mean waterfall power.

    Returns (audio (F, M), power (M,), wf (F/wf_avg, M), st_out (7, M)), and
    under ``emit_env`` (with ``apply_agc`` off) a fifth output: the release
    env (F, M) scanned from carry row 4, whose last frame becomes row 4."""
    F, M = yr.shape
    zeros2 = torch.zeros((2, M), dtype=torch.float32, device=yr.device)
    dstate = {"cw_phase": cw_acc, "am_dc": st_in[0:2], "nfm_last": torch.complex(st_in[2], st_in[3]),
              "sam_dc": zeros2, "sam_carrier": zeros2}
    audio, d = demod_op.bank_apply(dstate, torch.complex(yr, yi).T, mode, cw_word, fs,
                                   nfm_deviation_hz, enabled=tuple(sorted(enabled)))
    if apply_agc:
        env_r = maxdecay_scan(rel[:, None].expand(M, F), torch.abs(audio), st_in[4])
        env = affine_scan(al[:, None].expand(M, F), (1.0 - al)[:, None] * env_r, st_in[5])
        gain = torch.minimum(mg[:, None], tgt[:, None] / torch.clamp_min(env, 1e-9))
        audio = torch.where((mode == demod_op.NFM)[:, None], audio, audio * gain)
        env_last, lpf_last = env_r[:, -1], env[:, -1]
    elif emit_env:
        env_r = maxdecay_scan(rel[:, None].expand(M, F), torch.abs(audio), st_in[4])
        env_last, lpf_last = env_r[:, -1], st_in[5]
    else:
        env_last, lpf_last = st_in[4], st_in[5]
    p = yr * yr + yi * yi
    power = st_in[6] + p.sum(dim=0)
    wf = p.reshape(F // wf_avg, wf_avg, M).mean(dim=1)
    st_out = torch.stack([d["am_dc"][0], d["am_dc"][1], d["nfm_last"].real, d["nfm_last"].imag,
                          env_last, lpf_last, power])
    out = (audio.T.contiguous(), power, wf, st_out)
    return out + (env_r.T.contiguous(),) if emit_env else out


def demod_args(M: int, F: int, wf_avg: int, consts, st_in, barriers: int = 1):
    """Validate and place the per-channel inputs, allocate the outputs and the
    scratch on the state's device. Returns ((audio, wf, st_out), the data
    pointers from ``mode`` to ``barrier`` in the order of the C entry
    points). ``wf_avg`` = 0 allocates no waterfall; ``barriers`` zeroed grid
    barrier counters. Temporaries freed here are reused only by later work on
    the same stream, so they outlive the launch, provided the caller allocates
    nothing between this call and the launch (a tensor allocated then may
    take their memory)."""
    mode, cw_word, cw_acc, rel, al, tgt, mg = consts
    dev = st_in.device
    ints = [t.to(device=dev, dtype=torch.int32).contiguous() for t in (mode, cw_word, cw_acc)]
    flts = [t.to(device=dev, dtype=torch.float32).contiguous() for t in (rel, al, tgt, mg)]
    for t in ints + flts:
        if t.shape != (M,):
            raise ValueError(f"per-channel inputs must be ({M},), got {tuple(t.shape)}")
    st = st_in.to(torch.float32).contiguous()
    if st.shape != (7, M):
        raise ValueError(f"st_in must be (7, {M})")
    audio = torch.empty((F, M), dtype=torch.float32, device=dev)
    wf = torch.empty((F // wf_avg if wf_avg else 0, M), dtype=torch.float32, device=dev)
    st_out = torch.empty((7, M), dtype=torch.float32, device=dev)
    v = torch.empty((F, M), dtype=torch.float32, device=dev)
    p = torch.empty((F, M), dtype=torch.float32, device=dev)
    barrier = torch.zeros((barriers,), dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in ints + flts + [st, audio, wf, st_out, v, p, barrier]]
    return (audio, wf, st_out), ptrs


def mode_bits(en) -> int:
    return sum(1 << m for m in en)


@functools.cache
def _kernel_fn():
    fn = _build.build("demod_agc").lib.rf_demod_agc
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class FusedDemodAgc(nn.Module):
    """Channelizer back end: (yr/yi (F, M) frame-major planes, mode (M,),
    per-channel CW and AGC constants, st_in (7, M)) ->
    (audio (F, M), power (M,), wf_power (F/avg, M), st_out (7, M))."""

    def __init__(self, M: int, fs_channel: float, nfm_deviation_hz: float, wf_avg: int = 1,
                 enabled=(0, 1, 2, 3, 4), apply_agc: bool = True):
        super().__init__()
        self.M = int(M)
        self.fs = float(fs_channel)
        self.nfm_deviation_hz = float(nfm_deviation_hz)
        self.dev_scale = float(fs_channel / (2.0 * np.pi * nfm_deviation_hz))
        self.max_tf = max(8, min(128, (64 * 4096) // self.M))  # the reference's tile cap
        self.wf_avg = check_wf_avg(wf_avg, self.max_tf, self.M)
        self.en = check_modes(enabled)
        self.apply_agc = bool(apply_agc)
        self.launches = 0
        self.walk_segments: int | None = None  # S of the walk; None: walk_plan.plan's
        self.last_plan: walk_plan.WalkPlan | None = None

    def release_ok(self, release_values) -> bool:
        return release_decays_ok(release_values, self.max_tf)

    def forward(self, yr, yi, mode, cw_word, cw_acc, rel, al, tgt, mg, st_in):
        F, M = yr.shape
        if M != self.M or yi.shape != yr.shape or F % self.wf_avg:
            raise ValueError(f"planes {tuple(yr.shape)}: need (F, {self.M}) with F a multiple "
                             f"of {self.wf_avg}")
        if self.walk_segments is not None:  # refused on every device alike
            walk_plan.check(F, int(self.walk_segments), self.wf_avg)
        if yr.device.type == "cuda":
            return self._launch(yr, yi, (mode, cw_word, cw_acc, rel, al, tgt, mg), st_in)
        if yr.device.type == "cpu":
            return plain_demod_agc(yr, yi, mode, cw_word, cw_acc, rel, al, tgt, mg, st_in,
                                   enabled=self.en, fs=self.fs,
                                   nfm_deviation_hz=self.nfm_deviation_hz,
                                   wf_avg=self.wf_avg, apply_agc=self.apply_agc)
        raise ValueError(f"unsupported device {yr.device}")

    def _launch(self, yr, yi, consts, st_in):
        dev = yr.device
        if yi.device != dev or st_in.device != dev:
            raise ValueError(f"planes and state must share device {dev}")
        if yr.dtype != torch.float32 or yi.dtype != torch.float32:
            raise ValueError("planes must be float32")
        yr, yi = yr.contiguous(), yi.contiguous()
        F, M = yr.shape
        items = walk_plan.launch_threads("demod_agc", torch.cuda.current_device(), M, F)
        plan = walk_plan.plan(M, F, self.wf_avg, items, self.walk_segments)
        seg = walk_plan.scratch(plan, M, dev)
        (audio, wf, st_out), ptrs = demod_args(M, F, self.wf_avg, consts, st_in,
                                               barriers=1 + walk_plan.WALK_COUNTERS)
        rc = _kernel_fn()(yr.data_ptr(), yi.data_ptr(), *ptrs, M, F, mode_bits(self.en),
                          self.wf_avg, AGC_APPLY if self.apply_agc else AGC_OFF,
                          self.dev_scale, CW_SCALE, plan.segments,
                          None if seg is None else seg.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"demod_agc kernel launch failed: CUDA error {rc}")
        _build.launched(self)
        self.last_plan = plan
        return audio, st_out[6], wf, st_out
