"""Fused overlap-save mode filter + demod bank + AGC, the flagship's audio
back end in one kernel (counterpart of ``radioframe/kernels/ols_demod.py``,
kernel K6).

``FusedOlsDemod.__call__`` launches the hand-written CUDA C++ kernel
``csrc/ols_demod.cu`` for CUDA tensors and runs the plain PyTorch version
``plain_ols_demod`` for CPU tensors. For a CUDA tensor it launches or
raises: there is no fallback. ``launches`` counts kernel launches. The
kernel's per-channel walk runs in S time segments planned by
``walk_plan.plan`` from the launch's thread count (``walk_segments`` fixes S
instead; ``last_plan`` is the plan of the last launch).

Streaming contract of ``OverlapSaveBank.apply_selected`` followed by
``demod.bank_apply`` and ``AgcBank`` (attack/release, no hang), with the
7-row carry of ``kernels/demod_agc.py``; row 6 (power) is passed through.
Modes SSB, CW, AM, NFM and LSB. The reference's TPU gate on
``C % 128`` is gone, and both ``dft_precision`` settings compute in FP32.

Two forms of the one kernel (``variant_launches`` counts each, ``FORMS``):
``forward`` is the reference's call, on per-channel inputs the caller
gathers (selected responses, AGC constants, the packed carry); ``call_chain``
is ``RxChain``'s back end, which hands over the bank's response table, the
per-mode AGC tables and the state as the chain keeps it: the kernel gathers,
packs and unpacks itself, advances the CW phase, gives the last gain and
writes (C, Ta) audio, so the back end is one launch with nothing around it.
``plain_call_chain`` is that form's plain version: the gathers and the carry
around ``plain_ols_demod``, the same values.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch import nn

from radioframe_torch.kernels import _build, fft_plan, walk_plan
from radioframe_torch.kernels.demod_agc import (CW_SCALE, check_modes, demod_args, mode_bits,
                                                plain_demod_agc, release_decays_ok)
from radioframe_torch.kernels.pfb_dft import DFT_PRECISIONS, check_channels
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops import nco
from radioframe_torch.ops.ols import _framed

# the kernel's forms, as ``variant_launches`` counts them
FORMS = ("per_channel", "chain")


def next_tail(tail, x, L1: int):
    """The last L1 samples of [tail | x]: the OLS tail after the block."""
    if x.shape[-1] >= L1:
        return x[:, x.shape[-1] - L1:]
    return torch.cat([tail, x], dim=-1)[:, -L1:]


def plain_ols_demod(k6: "FusedOlsDemod", tail, x, h_sel, mode, cw_word, cw_acc, rel, al, tgt,
                    mg, st_in):
    """The plain PyTorch version of the kernel: ``torch.fft`` overlap-save
    with each channel's response, then ``plain_demod_agc`` over the (Ta, C)
    planes. Returns (audio (C, Ta), st_out (7, C), new_tail (C, L1))."""
    C, Ta = x.shape
    L1 = k6.nfft - k6.hop
    frames, new_tail = _framed(tail, x, k6.hop, k6.nfft, L1 + 1)
    y = torch.fft.ifft(torch.fft.fft(frames, dim=-1) * h_sel[:, None, :], dim=-1)
    s = y[..., L1:].reshape(C, Ta).T
    audio, _, _, st_out = plain_demod_agc(
        s.real.contiguous(), s.imag.contiguous(), mode, cw_word, cw_acc, rel, al, tgt, mg,
        st_in, enabled=k6.en, fs=k6.fs, nfm_deviation_hz=k6.nfm_deviation_hz, wf_avg=1,
        apply_agc=True)
    return audio.T, torch.cat([st_out[:6], st_in[6:7]]), new_tail


def plain_call_chain(k6: "FusedOlsDemod", tail, x, H, mode, tables, cw_word: int,
                     demod_state: dict, agc_state: dict):
    """The plain PyTorch version of the chain's form: each channel's row of
    ``H`` and its constants of the per-mode ``tables`` gathered by mode, the
    carry packed from the state, ``plain_ols_demod``, the carry unpacked into
    the state's form, the CW phase advanced by Ta words and the last gain.
    Returns (audio (C, Ta), new_tail, demod_state', agc_state', gain_last)."""
    m = mode.to(torch.int64)
    h_sel = H.index_select(0, demod_op.filter_index(mode).to(torch.int64))
    rel, al, tgt, mg = (t[m] for t in tables)
    words = torch.full(mode.shape, cw_word, dtype=torch.int32, device=x.device)
    d = demod_state
    st_in = torch.stack([d["am_dc"][0], d["am_dc"][1], d["nfm_last"].real, d["nfm_last"].imag,
                         agc_state["env"], agc_state["lpf"], torch.zeros_like(agc_state["env"])])
    audio, st_out, new_tail = plain_ols_demod(k6, tail, x, h_sel, mode, words, d["cw_phase"],
                                              rel, al, tgt, mg, st_in)
    new_demod = {**d, "am_dc": st_out[0:2], "nfm_last": torch.complex(st_out[2], st_out[3]),
                 "cw_phase": nco.wrap_i32(d["cw_phase"].to(torch.int64)
                                          + words.to(torch.int64) * x.shape[-1])}
    gain_last = torch.minimum(mg, tgt / torch.clamp_min(st_out[5], 1e-9))
    return (audio, new_tail, new_demod, {"hist": (), "env": st_out[4], "lpf": st_out[5]},
            gain_last)


@functools.cache
def _kernel_fn():
    fn = _build.build("ols_demod").lib.rf_ols_demod
    fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _chain_fn():
    fn = _build.build("ols_demod").lib.rf_ols_demod_chain
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] + [ctypes.c_void_p] * 13
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


class FusedOlsDemod(nn.Module):
    """Flagship audio back end: (OLS tail (C, L1), x (C, Ta) complex64,
    per-channel selected response h_sel (C, nfft), mode + CW + AGC constants
    (C,), st_in (7, C)) -> (audio (C, Ta) float32, st_out (7, C), new_tail).

    ``attack_alphas`` is the reference's static table of the distinct
    nonzero attack coefficients; the kernel walks each channel's own
    coefficient, so it keeps the table only as the reference's record.
    Buffer: ``tw`` the FFT's twiddle table (``fft_plan.twiddles``).
    ``call_chain`` is the chain's form (the module docstring)."""

    def __init__(self, nfft: int, hop: int, C: int, fs_audio: float, nfm_deviation_hz: float,
                 enabled=(0, 1, 2, 3, 4), attack_alphas: tuple = (),
                 dft_precision: str = "highest"):
        super().__init__()
        if nfft < 2 or nfft & (nfft - 1):
            raise ValueError(f"nfft must be a power of two, got {nfft}")
        if not 0 < hop < nfft:
            raise ValueError(f"hop must be in (0, {nfft}), got {hop}")
        check_channels(nfft, 1)
        if dft_precision not in DFT_PRECISIONS:
            raise ValueError(f"dft_precision must be one of {DFT_PRECISIONS}, got {dft_precision!r}")
        self.dft_precision = dft_precision
        self.nfft, self.hop, self.C = int(nfft), int(hop), int(C)
        self.fs = float(fs_audio)
        self.nfm_deviation_hz = float(nfm_deviation_hz)
        self.dev_scale = float(fs_audio / (2.0 * np.pi * nfm_deviation_hz))
        self.en = check_modes(enabled)
        self.attack_alphas = tuple(sorted({float(a) for a in attack_alphas if float(a) != 0.0}))
        self.register_buffer("tw", torch.from_numpy(fft_plan.twiddles(self.nfft)))
        self.launches = 0
        self.variant_launches = dict.fromkeys(FORMS, 0)
        self.walk_segments: int | None = None  # S of the walk; None: walk_plan.plan's
        self.last_plan: walk_plan.WalkPlan | None = None

    def release_ok(self, release_values) -> bool:
        """The reference's guard over its AGC tile, which is the hop."""
        return release_decays_ok(release_values, self.hop)

    def _check(self, x) -> None:
        C, Ta = x.shape
        if C != self.C or Ta % self.hop:
            raise ValueError(f"x {tuple(x.shape)}: need ({self.C}, Ta) with Ta a multiple of "
                             f"{self.hop}")
        if x.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {x.device}")

    def forward(self, tail, x, h_sel, mode, cw_word, cw_acc, rel, al, tgt, mg, st_in):
        self._check(x)
        args = (tail, x, h_sel, mode, cw_word, cw_acc, rel, al, tgt, mg, st_in)
        if x.device.type == "cuda":
            return self._launch(*args)
        return plain_ols_demod(self, *args)

    def call_chain(self, tail, x, H, mode, tables, cw_word: int, demod_state: dict,
                   agc_state: dict):
        """The chain's form: (OLS tail (C, L1), x (C, Ta) complex64, the
        bank's response table H (rows, nfft), mode (C,) int32, the per-mode
        AGC tables (release, alpha, target, max_gain), the CW tone's DDS
        word, the demod state {cw_phase, am_dc, nfm_last, ...} and the AGC
        state {env, lpf}) -> (audio (C, Ta) float32, new_tail, demod_state',
        agc_state', the last gain (C,)). The SAM carry passes through."""
        self._check(x)
        args = (tail, x, H, mode, tables, int(cw_word), demod_state, agc_state)
        if x.device.type == "cuda":
            return self._launch_chain(*args)
        return plain_call_chain(self, *args)

    def _plan(self, dev, C: int, Ta: int, entry: str | None = None):
        """(walk plan, its scratch) of a launch at (C, Ta)."""
        items = walk_plan.launch_threads("ols_demod", torch.cuda.current_device(), C, Ta,
                                         self.nfft, self.hop, entry=entry)
        plan = walk_plan.plan(C, Ta, 0, items, self.walk_segments)
        return plan, walk_plan.scratch(plan, C, dev)

    def _launch(self, tail, x, h_sel, mode, cw_word, cw_acc, rel, al, tgt, mg, st_in):
        """Launch the CUDA kernel on the current stream; outputs and scratch
        are allocated here. Raises if the launch is refused."""
        dev = x.device
        for name, t in (("tail", tail), ("h_sel", h_sel), ("st_in", st_in), ("tw", self.tw)):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, x on {dev}")
        C, Ta = x.shape
        L1 = self.nfft - self.hop
        x_c = x.to(torch.complex64).contiguous()
        tail_c = tail.to(torch.complex64).contiguous()
        h_c = h_sel.to(torch.complex64).contiguous()
        if tail_c.shape != (C, L1) or h_c.shape != (C, self.nfft):
            raise ValueError(f"tail must be ({C}, {L1}) and h_sel ({C}, {self.nfft})")
        sr = torch.empty((Ta, C), dtype=torch.float32, device=dev)
        si = torch.empty_like(sr)
        consts = (mode, cw_word, cw_acc, rel, al, tgt, mg)
        plan, seg = self._plan(dev, C, Ta)
        (audio, _, st_out), ptrs = demod_args(C, Ta, 0, consts, st_in,
                                              barriers=2 + walk_plan.WALK_COUNTERS)
        rc = _kernel_fn()(x_c.data_ptr(), tail_c.data_ptr(), h_c.data_ptr(), self.tw.data_ptr(),
                          sr.data_ptr(), si.data_ptr(), *ptrs, C, Ta, self.nfft, self.hop,
                          mode_bits(self.en), self.dev_scale, CW_SCALE, plan.segments,
                          None if seg is None else seg.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ols_demod kernel launch failed: CUDA error {rc}")
        _build.launched(self, FORMS[0])
        self.last_plan = plan
        return audio.T, st_out, next_tail(tail_c, x_c, L1)

    def _launch_chain(self, tail, x, H, mode, tables, cw_word: int, demod_state, agc_state):
        """Launch the chain's form on the current stream. Inputs of the
        kernel's dtype and contiguous are read where they lie (any other is
        converted first, one more graph node); outputs and scratch are
        allocated here. Raises if the launch is refused."""
        dev = x.device
        C, Ta = x.shape
        L1 = self.nfft - self.hop
        d = demod_state

        def read(name, t, dtype, shape):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, x on {dev}")
            t = t.to(dtype).contiguous()
            if t.shape != shape:
                raise ValueError(f"{name} is {tuple(t.shape)}, need {tuple(shape)}")
            return t

        x = read("x", x, torch.complex64, (C, Ta))
        tail = read("tail", tail, torch.complex64, (C, L1))
        H = read("H", H, torch.complex64, (H.shape[0], self.nfft))
        mode = read("mode", mode, torch.int32, (C,))
        cw_acc = read("cw_phase", d["cw_phase"], torch.int32, (C,))
        am = read("am_dc", d["am_dc"], torch.float32, (2, C))
        nfm = read("nfm_last", d["nfm_last"], torch.complex64, (C,))
        env = read("env", agc_state["env"], torch.float32, (C,))
        lpf = read("lpf", agc_state["lpf"], torch.float32, (C,))
        tables = [read(f"table {i}", t, torch.float32, (demod_op.SAM + 1,))
                  for i, t in enumerate(tables)]
        plan, seg = self._plan(dev, C, Ta, entry="rf_ols_demod_chain_threads")
        f32 = dict(dtype=torch.float32, device=dev)
        sr, si = torch.empty((Ta, C), **f32), torch.empty((Ta, C), **f32)
        v, p = torch.empty((Ta, C), **f32), torch.empty((Ta, C), **f32)
        consts, carry = torch.empty((5, C), **f32), torch.empty((7, C), **f32)
        audio, st_out = torch.empty((C, Ta), **f32), torch.empty((8, C), **f32)
        nfm_out = torch.empty((C,), dtype=torch.complex64, device=dev)
        cw_out = torch.empty((C,), dtype=torch.int32, device=dev)
        barrier = torch.zeros((2 + walk_plan.WALK_COUNTERS,), dtype=torch.int32, device=dev)
        rc = _chain_fn()(x.data_ptr(), tail.data_ptr(), H.data_ptr(), self.tw.data_ptr(),
                         sr.data_ptr(), si.data_ptr(), mode.data_ptr(), cw_acc.data_ptr(),
                         *(t.data_ptr() for t in tables), cw_word, am.data_ptr(), nfm.data_ptr(),
                         env.data_ptr(), lpf.data_ptr(), consts.data_ptr(), carry.data_ptr(),
                         audio.data_ptr(), st_out.data_ptr(), nfm_out.data_ptr(),
                         cw_out.data_ptr(), v.data_ptr(), p.data_ptr(), barrier.data_ptr(),
                         C, Ta, self.nfft, self.hop, mode_bits(self.en), self.dev_scale,
                         CW_SCALE, plan.segments, None if seg is None else seg.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ols_demod kernel launch failed: CUDA error {rc}")
        _build.launched(self, FORMS[1])
        self.last_plan = plan
        new_demod = {**d, "cw_phase": cw_out, "am_dc": st_out[0:2], "nfm_last": nfm_out}
        return (audio, next_tail(tail, x, L1), new_demod,
                {"hist": (), "env": st_out[4], "lpf": st_out[5]}, st_out[7])
