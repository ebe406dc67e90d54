"""Fused NCO mix + stage-1 + optional stage-2 polyphase decimation + input
power (counterpart of ``radioframe/kernels/fused_frontend2.py``, kernel K1).

``FusedFrontend2.step_planes`` launches the hand-written CUDA C++ kernel
``csrc/fused_frontend2.cu`` for CUDA tensors and runs the plain PyTorch
version ``plain_step`` for CPU tensors. For a CUDA tensor it launches or
raises: there is no fallback. ``launches`` counts kernel launches. The
launch's strips, chunks, ring stages and copy path are
``frontend_plan.plan``'s (``stages``, ``strips`` and ``chunk`` fix them for
the probes' sweeps; ``last_plan`` is the last launch's).

Block state: {"acc" (C,) int32 DDS accumulator, "tail" (C, H_carry)
complex64 raw input, in raw input units}, H_carry = H2*R1 + H1.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch import nn

from radioframe_torch.kernels import _build, frontend_plan
# the oscillator lives in frontend_plan (whose executor mixes as the kernel
# does) and is importable from here as before
from radioframe_torch.kernels.frontend_plan import SCALE, dds_oscillator  # noqa: F401
from radioframe_torch.ops.fir import conv_planes
from radioframe_torch.ops.nco import wrap_i32


def _pad_poly(taps, R, J):
    """Reversed taps zero-padded to (J+1, R): y[m] = sum_k wp[k] x[mR - JR + k]."""
    w_rev = np.asarray(taps, np.float64)[::-1]
    wp = np.zeros(((J + 1) * R,), np.float64)
    d = J * R - (len(w_rev) - 1)
    wp[d: d + len(w_rev)] = w_rev
    return wp.reshape(J + 1, R).astype(np.float32)


def _poly_weight(wp: torch.Tensor) -> torch.Tensor:
    """(J+1, R) padded polyphase taps -> conv1d weight (2, 1, (J+1)*R)."""
    return wp.reshape(1, 1, -1).expand(2, 1, -1).contiguous()


def plain_step(ff: "FusedFrontend2", xr, xi, tail, acc, words):
    """The plain PyTorch version of the kernel: (y (C, T/decim) complex64,
    power (C,) = sum |x|^2 in raw input units).

    Concatenates the raw tail, mixes the whole window at its absolute DDS
    indices, then runs the two strided conv1ds with the ``_pad_poly`` taps:
    stage-1 output i of the window is y1[i - H2], so stage 2 sees its H2
    history samples without a separate history pass."""
    C = words.shape[0]
    T = xr.shape[-1]
    x = torch.complex(xr.to(torch.float32), xi.to(torch.float32)).expand(C, T)
    xp = torch.cat([tail, x], dim=-1)  # (C, H_carry + T)
    n = torch.arange(-ff.H_carry, T, dtype=torch.int64, device=xr.device)
    y = conv_planes(xp * dds_oscillator(acc, words, n), _poly_weight(ff.w1),
                    ff.R)  # (C, H2 + T/R1)
    if ff.fuse2:
        y = conv_planes(y, _poly_weight(ff.w2), ff.R2)
    xr32, xi32 = xr.to(torch.float32), xi.to(torch.float32)
    power = torch.sum(xr32 * xr32 + xi32 * xi32, dim=-1).expand(C)
    return y, power


def raw_next_state(state, xr, xi, words, H: int) -> dict:
    """A fused front end's state after a block of planes xr/xi (C or 1, T):
    the DDS accumulator advanced by words*T (wrapping), the tail the block's
    last H raw samples (C, H) complex64."""
    C = words.shape[0]
    T = xr.shape[1]
    tail = torch.complex(xr[:, T - H:].to(torch.float32), xi[:, T - H:].to(torch.float32))
    return {"acc": wrap_i32(state["acc"].to(torch.int64) + words.to(torch.int64) * T),
            "tail": tail.expand(C, -1).contiguous()}


@functools.cache
def _kernel_fns():
    lib = _build.build("fused_frontend2").lib
    fns = {}
    for dtype, sym in ((torch.float32, "rf_fused_frontend2_f32"),
                       (torch.int16, "rf_fused_frontend2_i16")):
        fn = getattr(lib, sym)
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    return fns


@functools.cache
def _resident(device: int, i16: bool, R1: int, R2: int, smem: int) -> int:
    """Blocks of the kernel for (dtype, R1, R2) that CUDA device ``device``
    (the current one when called) keeps resident at ``smem`` bytes."""
    fn = _build.build("fused_frontend2").lib.rf_fused_frontend2_resident
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    rc = fn(int(i16), R1, R2, smem, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"fused_frontend2 occupancy query failed: CUDA error {rc}")
    return n.value


class FusedFrontend2(nn.Module):
    """Fused NCO + stage-1 (+ optional stage-2) decimation.

    taps/R: stage 1 (real taps). taps2/R2: optional second real-tap stage
    (R2 a power of two; None -> single-stage mode). ``input_scale`` is
    folded into the stage-1 taps (2**-15 for int16 ADC counts). The padded
    polyphase taps are the ``w1`` (J0+1, R) and ``w2`` (J2+1, R2) buffers."""

    def __init__(self, taps, R: int, taps2=None, R2: int = 1, input_scale: float = 1.0):
        super().__init__()
        self.input_scale = float(input_scale)
        h1 = np.asarray(taps, np.float64) * self.input_scale
        if np.iscomplexobj(h1):
            raise ValueError("stage-1 taps must be real")
        self.R = int(R)
        self.J0 = max(1, -(-(len(h1) - 1) // self.R))
        self.H = self.J0 * self.R  # stage-1 raw history
        self.register_buffer("w1", torch.from_numpy(_pad_poly(h1, self.R, self.J0)))
        self.fuse2 = taps2 is not None
        if self.fuse2:
            h2 = np.asarray(taps2, np.float64)
            if np.iscomplexobj(h2):
                raise ValueError("stage-2 taps must be real")
            self.R2 = int(R2)
            if self.R2 < 1 or self.R2 & (self.R2 - 1):
                raise ValueError("stage-2 R must be a power of two")
            self.J2 = max(1, -(-(len(h2) - 1) // self.R2))
            self.register_buffer("w2", torch.from_numpy(_pad_poly(h2, self.R2, self.J2)))
        else:
            # single stage: the kernel's stage 2 becomes one tap of 1.0 (exact)
            self.R2, self.J2 = 1, 0
            self.register_buffer("w2", torch.ones((1, 1), dtype=torch.float32))
        self.H2 = self.J2 * self.R2  # stage-1 outputs preceding the block
        self.H_carry = self.H2 * self.R + self.H  # raw samples in state/halo
        self.decim = self.R * self.R2
        self.launches = 0
        # the launch plan's knobs (None: frontend_plan's choice) and the last plan
        self.stages = frontend_plan.STAGES
        self.strips: int | None = None
        self.chunk: int | None = None
        self.last_plan: frontend_plan.FrontendPlan | None = None

    def init_state(self, num_channels: int) -> dict:
        dev = self.w1.device
        return {"acc": torch.zeros((num_channels,), dtype=torch.int32, device=dev),
                "tail": torch.zeros((num_channels, self.H_carry), dtype=torch.complex64,
                                    device=dev)}

    def step(self, state, iq, words, return_power: bool = False):
        """(state, iq (C, T) or (1, T) complex64, words (C,) int32) ->
        (state, y (C, T//decim)) [+ per-channel raw input power sum]. The
        planes are strided views of ``iq``; nothing is de-interleaved."""
        planes = torch.view_as_real(iq)
        return self.step_planes(state, planes[..., 0], planes[..., 1], words,
                                return_power=return_power)

    def step_planes(self, state, xr, xi, words, return_power: bool = False):
        """Plane form: xr/xi (C, T) or (1, T) float32, or int16 ADC counts
        when built with ``input_scale=2**-15``. Returns (state, y) or
        (state, y, power_sum) with power_sum (C,) = sum |x|^2 in raw input
        units (the caller applies input_scale**2)."""
        C = words.shape[0]
        if xr.shape != xi.shape or xr.dim() != 2 or xr.shape[0] not in (1, C):
            raise ValueError(f"planes {tuple(xr.shape)}/{tuple(xi.shape)} do not fit {C} channels")
        if xr.dtype != xi.dtype or xr.dtype not in (torch.float32, torch.int16):
            raise ValueError(f"planes must both be float32 or int16, got {xr.dtype}/{xi.dtype}")
        T = xr.shape[1]
        if T % self.decim or T < self.H_carry:
            raise ValueError(f"block length {T} must be a multiple of {self.decim} "
                             f"and at least {self.H_carry}")
        acc, tail = state["acc"], state["tail"]
        if xr.device.type == "cuda":
            y, power = self._launch(xr, xi, tail, acc, words)
        elif xr.device.type == "cpu":
            y, power = plain_step(self, xr, xi, tail, acc, words)
        else:
            raise ValueError(f"unsupported device {xr.device}")
        new_state = self.next_state(state, xr, xi, words)
        if return_power:
            return new_state, y, power
        return new_state, y

    def next_state(self, state, xr, xi, words) -> dict:
        """State after the block: acc advanced by words*T (wrapping), tail =
        the block's last H_carry raw samples."""
        return raw_next_state(state, xr, xi, words, self.H_carry)

    def _launch(self, xr, xi, tail, acc, words):
        """Launch the CUDA kernel on the current stream; outputs are allocated
        here. Raises if the launch is refused."""
        dev = xr.device
        for name, t in (("xi", xi), ("tail", tail), ("acc", acc), ("words", words),
                        ("w1", self.w1)):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, planes on {dev}")
        C = words.shape[0]
        T = xr.shape[1]
        if tuple(tail.shape) != (C, self.H_carry) or tail.dtype != torch.complex64:
            raise ValueError(f"tail must be ({C}, {self.H_carry}) complex64")
        # xi must sit at the same strides as xr (separate planes or the two
        # halves of one view_as_real)
        if xi.stride() != xr.stride():
            raise ValueError("xr and xi must have the same strides")
        ch_stride = 0 if xr.shape[0] == 1 else xr.stride(0)
        words32 = words.to(torch.int32).contiguous()
        acc32 = acc.to(torch.int32).contiguous()
        tail_c = tail.contiguous()
        form, align = frontend_plan.input_form(xr, xi)
        device = torch.cuda.current_device()
        i16 = xr.dtype == torch.int16
        plan = frontend_plan.plan(
            C, T, self.R, self.J0, self.R2, self.J2, elt=xr.element_size(), form=form,
            align=align, stages=self.stages, strips=self.strips, chunk=self.chunk,
            resident=lambda smem: _resident(device, i16, self.R, self.R2, smem))
        y = torch.empty((C, T // self.decim), dtype=torch.complex64, device=dev)
        pow_part = torch.empty((C, plan.strips), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel_fns()[xr.dtype](
            xr.data_ptr(), xi.data_ptr(), ch_stride, xr.stride(1), tail_c.data_ptr(),
            words32.data_ptr(), acc32.data_ptr(), self.w1.data_ptr(), self.w2.data_ptr(),
            y.data_ptr(), pow_part.data_ptr(), C, T, self.R, self.J0, self.R2, self.J2,
            plan.q2, plan.per_strip, plan.strips, plan.stages,
            frontend_plan.FORMS.index(plan.form), frontend_plan.COPIES.index(plan.copy),
            plan.width, plan.smem, float(SCALE), stream)
        if rc != 0:
            raise RuntimeError(f"fused_frontend2 kernel launch failed: CUDA error {rc}")
        _build.launched(self)
        self.last_plan = plan
        return y, pow_part.sum(dim=-1)
