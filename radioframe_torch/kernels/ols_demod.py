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
from radioframe_torch.ops.ols import _framed


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


@functools.cache
def _kernel_fn():
    fn = _build.build("ols_demod").lib.rf_ols_demod
    fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


class FusedOlsDemod(nn.Module):
    """Flagship audio back end: (OLS tail (C, L1), x (C, Ta) complex64,
    per-channel selected response h_sel (C, nfft), mode + CW + AGC constants
    (C,), st_in (7, C)) -> (audio (C, Ta) float32, st_out (7, C), new_tail).

    ``attack_alphas`` is the reference's static table of the distinct
    nonzero attack coefficients; the kernel walks each channel's own
    coefficient, so it keeps the table only as the reference's record.
    Buffer: ``tw`` the FFT's twiddle table (``fft_plan.twiddles``)."""

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
        self.walk_segments: int | None = None  # S of the walk; None: walk_plan.plan's
        self.last_plan: walk_plan.WalkPlan | None = None

    def release_ok(self, release_values) -> bool:
        """The reference's guard over its AGC tile, which is the hop."""
        return release_decays_ok(release_values, self.hop)

    def forward(self, tail, x, h_sel, mode, cw_word, cw_acc, rel, al, tgt, mg, st_in):
        C, Ta = x.shape
        if C != self.C or Ta % self.hop:
            raise ValueError(f"x {tuple(x.shape)}: need ({self.C}, Ta) with Ta a multiple of "
                             f"{self.hop}")
        args = (tail, x, h_sel, mode, cw_word, cw_acc, rel, al, tgt, mg, st_in)
        if x.device.type == "cuda":
            return self._launch(*args)
        if x.device.type == "cpu":
            return plain_ols_demod(self, *args)
        raise ValueError(f"unsupported device {x.device}")

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
        items = walk_plan.launch_threads("ols_demod", torch.cuda.current_device(), C, Ta,
                                         self.nfft, self.hop)
        plan = walk_plan.plan(C, Ta, 0, items, self.walk_segments)
        seg = walk_plan.scratch(plan, C, dev)
        (audio, _, st_out), ptrs = demod_args(C, Ta, 0, consts, st_in,
                                              barriers=2 + walk_plan.WALK_COUNTERS)
        rc = _kernel_fn()(x_c.data_ptr(), tail_c.data_ptr(), h_c.data_ptr(), self.tw.data_ptr(),
                          sr.data_ptr(), si.data_ptr(), *ptrs, C, Ta, self.nfft, self.hop,
                          mode_bits(self.en), self.dev_scale, CW_SCALE, plan.segments,
                          None if seg is None else seg.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ols_demod kernel launch failed: CUDA error {rc}")
        _build.launched(self)
        self.last_plan = plan
        return audio.T, st_out, next_tail(tail_c, x_c, L1)
