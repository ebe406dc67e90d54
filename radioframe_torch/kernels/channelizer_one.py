"""The whole channelizer in one launch (counterpart of
``radioframe/kernels/channelizer_one.py``, kernel K5): polyphase filter,
M-point DFT, demod bank, attack/release AGC, power and averaged waterfall.

``FusedChannelizerOne.call_planes`` launches the hand-written CUDA C++
kernel ``csrc/channelizer_one.cu`` for CUDA tensors and runs the plain
PyTorch version ``plain_channelizer_one`` (the plain K3, then the plain K4)
for CPU tensors. For a CUDA tensor it launches or raises: there is no
fallback. ``launches`` counts kernel launches, ``variant_launches`` those of
each audio layout (``LAYOUTS``). The kernel's per-channel walk runs in S time
segments planned by ``walk_plan.plan`` from the launch's thread count
(``walk_segments`` fixes S instead; ``last_plan`` is the plan of the last
launch).

The audio comes out frame-major (F, M), or channel-major (M, F) when the
caller asks (``call_planes(..., channel_major=True)``): the single-pass chain
returns (M, F) audio, so the kernel writes it so and no transposed copy of
it follows; K3 -> K4, the sharded paths and ``emit_env`` read frame-major.
The same values either way.

Same streaming contract as ``FusedPfbDft`` followed by ``FusedDemodAgc``,
in channel order. ``emit_env=True`` (demod only, AM statically off) is the
reference's variant for the sharded channelizer's "emit_env" tier: the
release env, scanned from carry row 4, comes out as a fifth (F, M) output.
The reference's TPU ``num_channels % 128`` gate and its ``MAX_GRID``
chunking are not carried.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch import nn

from radioframe_torch.kernels import _build, fft_plan, walk_plan
from radioframe_torch.kernels.demod_agc import (AGC_APPLY, AGC_EMIT_ENV, AGC_OFF, CW_SCALE,
                                                check_modes, check_wf_avg, demod_args,
                                                mode_bits, plain_demod_agc, release_decays_ok)
from radioframe_torch.kernels.pfb_dft import DFT_PRECISIONS, check_channels, plain_pfb_dft
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops.filter_design import pfb_prototype_taps

# the least phase-one run per CUDA block: 1 lets phase one take as many blocks
# as stay resident (at most one a frame), each running ceil(F / blocks)
# frames plus one lookback FFT: 8 at F = 2048, 2 at the sharded path's
# F_local = 512, where a run of 8 left half the SMs idle (probe_channelizer.py)
FRAMES_PER_BLOCK = 1
# the audio layouts, as ``variant_launches`` counts them
LAYOUTS = ("frame_major", "channel_major")


def plain_channelizer_one(one: "FusedChannelizerOne", tail, wr, wi, mode, cw_word, cw_acc,
                          rel, al, tgt, mg, st_in, channel_major: bool = False):
    """The plain PyTorch version of the kernel: ``plain_pfb_dft`` then
    ``plain_demod_agc``. Returns (audio (F, M), or contiguous (M, F) with
    ``channel_major``, power (M,), wf (F/avg, M), st_out (7, M)), and env
    (F, M) under ``emit_env``."""
    yr, yi = plain_pfb_dft(one.h, tail, wr, wi)
    out = plain_demod_agc(yr, yi, mode, cw_word, cw_acc, rel, al, tgt, mg, st_in,
                          enabled=one.en, fs=one.fs, nfm_deviation_hz=one.nfm_deviation_hz,
                          wf_avg=one.wf_avg, apply_agc=one.apply_agc, emit_env=one.emit_env)
    return (out[0].T.contiguous(),) + out[1:] if channel_major else out


@functools.cache
def _kernel_fn():
    fn = _build.build("channelizer_one").lib.rf_channelizer_one
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 18
                   + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class FusedChannelizerOne(nn.Module):
    """Single-pass channelizer: wideband planes -> audio (F, M) or (M, F), power (M,),
    waterfall power (F/avg, M) and the 7-row carry, all in channel order,
    and with ``emit_env`` the release env (F, M).
    Buffers: ``h`` (K, M) prototype tap rows, ``tw`` the FFT's twiddle
    table (``fft_plan.twiddles``).
    Both ``dft_precision`` settings compute the DFT in FP32."""

    def __init__(self, num_channels: int, taps_per_channel: int, fs_channel: float,
                 nfm_deviation_hz: float, wf_avg: int = 1, enabled=(0, 1, 2, 3, 4),
                 window: str = "hamming", dft_precision: str = "highest",
                 apply_agc: bool = True, emit_env: bool = False):
        super().__init__()
        if dft_precision not in DFT_PRECISIONS:
            raise ValueError(f"dft_precision must be one of {DFT_PRECISIONS}, got {dft_precision!r}")
        self.dft_precision = dft_precision
        self.M = int(num_channels)
        self.K = int(taps_per_channel)
        check_channels(self.M, 2)
        proto = pfb_prototype_taps(self.M, self.K, window)
        self.register_buffer("h", torch.from_numpy(
            np.ascontiguousarray(proto.reshape(self.K, self.M).astype(np.float32))))
        self.register_buffer("tw", torch.from_numpy(fft_plan.twiddles(self.M)))
        self.fs = float(fs_channel)
        self.nfm_deviation_hz = float(nfm_deviation_hz)
        self.dev_scale = float(fs_channel / (2.0 * np.pi * nfm_deviation_hz))
        self.max_tf = max(8, min(128, (32 * 4096) // self.M))  # the reference's tile cap
        self.wf_avg = check_wf_avg(wf_avg, self.max_tf, self.M)
        self.en = check_modes(enabled)
        self.apply_agc = bool(apply_agc)
        self.emit_env = bool(emit_env)
        if self.emit_env:
            # the reference's correctness gates, as errors
            if self.apply_agc:
                raise ValueError("emit_env is a demod-only mode (requires apply_agc=False)")
            if demod_op.AM in self.en:
                raise ValueError("emit_env needs AM statically disabled: the sharded AM "
                                 "DC-block fixup changes |audio| after the in-kernel env "
                                 "would have latched it")
        self.agc = AGC_EMIT_ENV if self.emit_env else AGC_APPLY if self.apply_agc else AGC_OFF
        self.launches = 0
        self.variant_launches = dict.fromkeys(LAYOUTS, 0)
        self.walk_segments: int | None = None  # S of the walk; None: walk_plan.plan's
        self.last_plan: walk_plan.WalkPlan | None = None

    def release_ok(self, release_values) -> bool:
        return release_decays_ok(release_values, self.max_tf)

    def init_tail(self) -> torch.Tensor:
        return torch.zeros((1, (self.K - 1) * self.M), dtype=torch.complex64,
                           device=self.h.device)

    def call_planes(self, tail, wr, wi, mode, cw_word, cw_acc, rel, al, tgt, mg, st_in,
                    channel_major: bool = False):
        """(tail (1, (K-1)M) complex, wr/wi (T,) float32, per-channel
        constants (M,), st_in (7, M)) -> (audio, power, wf, st_out), and env
        under ``emit_env``. audio is (F, M), or contiguous (M, F) with
        ``channel_major`` (not under ``emit_env``, whose outputs stay (F, M))."""
        T = wr.shape[-1]
        if wr.shape != wi.shape or wr.dim() != 1 or T % (self.M * self.wf_avg):
            raise ValueError(f"planes {tuple(wr.shape)}/{tuple(wi.shape)}: need (T,) with T a "
                             f"multiple of {self.M * self.wf_avg}")
        if channel_major and self.emit_env:
            raise ValueError("emit_env writes frame-major audio and env: channel_major is for "
                             "the demod and AGC forms")
        consts = (mode, cw_word, cw_acc, rel, al, tgt, mg)
        if wr.device.type == "cuda":
            return self._launch(tail, wr, wi, consts, st_in, bool(channel_major))
        if wr.device.type == "cpu":
            return plain_channelizer_one(self, tail, wr, wi, *consts, st_in, channel_major)
        raise ValueError(f"unsupported device {wr.device}")

    def _launch(self, tail, wr, wi, consts, st_in, channel_major: bool):
        dev = wr.device
        for name, t in (("wi", wi), ("tail", tail), ("st_in", st_in), ("h", self.h)):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, planes on {dev}")
        if wr.dtype != torch.float32 or wi.dtype != torch.float32:
            raise ValueError("planes must be float32")
        if wr.stride() != wi.stride():
            raise ValueError("wr and wi must have the same strides")
        tail_c = tail.to(torch.complex64).contiguous()
        if tail_c.shape != (1, (self.K - 1) * self.M):
            raise ValueError(f"tail must be (1, {(self.K - 1) * self.M})")
        M = self.M
        F = wr.shape[0] // M
        items = walk_plan.launch_threads("channelizer_one", torch.cuda.current_device(), M, F,
                                         FRAMES_PER_BLOCK, int(channel_major))
        plan = walk_plan.plan(M, F, self.wf_avg, items, self.walk_segments)
        seg = walk_plan.scratch(plan, M, dev)
        # before demod_args, whose scratch is freed on return: allocated
        # after it, env could take the memory of v or p
        env = torch.empty((F, M), dtype=torch.float32, device=dev) if self.emit_env else None
        (audio, wf, st_out), ptrs = demod_args(M, F, self.wf_avg, consts, st_in,
                                               barriers=1 + walk_plan.WALK_COUNTERS)
        if channel_major:  # the same buffer, written (M, F)
            audio = audio.view(M, F)
        rc = _kernel_fn()(wr.data_ptr(), wi.data_ptr(), wr.stride(0), tail_c.data_ptr(),
                          self.h.data_ptr(), self.tw.data_ptr(), *ptrs,
                          None if env is None else env.data_ptr(), M, self.K, F,
                          mode_bits(self.en), self.wf_avg, self.agc, self.dev_scale, CW_SCALE,
                          FRAMES_PER_BLOCK, plan.segments, None if seg is None else seg.data_ptr(),
                          int(channel_major), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"channelizer_one kernel launch failed: CUDA error {rc}")
        _build.launched(self, LAYOUTS[channel_major])
        self.last_plan = plan
        out = (audio, st_out[6], wf, st_out)
        return out + (env,) if self.emit_env else out
