"""Fused NCO mix + one real-tap polyphase decimation + input power
(counterpart of ``radioframe/kernels/fused_frontend.py``, kernel K2), with
the cost variants of ``tools/probe_fused.py`` (kernel K8).

``FusedFrontend.step_planes`` launches the hand-written CUDA C++ kernel
``csrc/fused_frontend.cu`` (on K1's strip-walking, asynchronous load path,
``csrc/frontend.cuh``) for CUDA tensors and runs the plain PyTorch version
``plain_fused_frontend`` for CPU tensors. For a CUDA tensor it launches or
raises: there is no fallback. ``launches`` counts kernel launches,
``variant_launches`` the launches of each variant. The launch's strips,
chunks, ring stages and copy path are ``frontend_plan.plan``'s single-stage
plan (``stages``, ``strips`` and ``chunk`` fix them for the probes' sweeps;
``last_plan`` is the last launch's); ``no_tr``'s is one probe tile a strip
on the gather path.

Block state: {"acc" (C,) int32 DDS accumulator, "tail" (C, H) complex64
raw input}, H = J0*R. The single padded polyphase table is the ``w1``
buffer: it is stage 1's, though the reference calls it ``w2``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch import nn

from radioframe_torch.kernels import _build, frontend_plan
from radioframe_torch.kernels.frontend_plan import NO_OSC, mix_exact
from radioframe_torch.kernels.fused_frontend2 import (SCALE, _pad_poly, _poly_weight,
                                                      dds_oscillator, raw_next_state)
from radioframe_torch.ops.fir import conv_planes

# K8's variants, in the order of the kernel's template argument
VARIANTS = ("full", "no_osc", "no_tr", "osc_only", "copy_only")
PROBE_TILE = 128          # outputs per tile of the probe's no_tr read (its TM)
# ring stages: at the flagship's shapes two (49,648 B a block, four blocks an
# SM) run ~6% under three (66,064 B, three an SM) on an H100 (probe_frontend.py)
STAGES = 2


def _no_tr_windows(x, tail, H: int, R: int):
    """The probe's no_tr read: per tile of PROBE_TILE outputs, the tile's
    (C, W) input block read as if it were (W, C) time-major, after the H-sample
    halo read as it is. Returns (G, C, H + W) raw windows."""
    C, T = x.shape
    W = PROBE_TILE * R
    G = T // W
    body = x.reshape(C, G, W).permute(1, 0, 2).reshape(G, W, C).transpose(1, 2)
    prev = torch.cat([tail, x[:, : (G - 1) * W]], dim=-1)  # the H samples before each tile
    halo = torch.stack([prev[:, i * W: i * W + H] for i in range(G)])
    return torch.cat([halo, body], dim=-1)


def _mix(x, osc):
    return mix_exact(x.real, x.imag, osc.real, osc.imag)


def plain_fused_frontend(ff: "FusedFrontend", xr, xi, tail, acc, words, variant: str = "full"):
    """The plain PyTorch version of the kernel and of its variants: (y (C,
    T/R) complex64, power (C,) = sum xr^2 + xi^2 of the block). ``full``:
    concatenate the raw tail, mix the whole window at its absolute DDS indices
    (each product and sum rounded once, ``frontend_plan.mix_exact``), one
    strided conv1d with the padded polyphase taps."""
    C = words.shape[0]
    T = xr.shape[-1]
    R, H = ff.R, ff.H
    xr32, xi32 = xr.to(torch.float32), xi.to(torch.float32)
    power = torch.sum(xr32 * xr32 + xi32 * xi32, dim=-1).expand(C)
    x = torch.complex(xr32, xi32).expand(C, T)
    if variant == "copy_only":
        return x.reshape(C, T // R, R).sum(dim=-1), power
    n = torch.arange(-H, T, dtype=torch.int64, device=xr.device)
    weight = _poly_weight(ff.w1)
    xp = torch.cat([tail, x], dim=-1)
    if variant == "no_osc":
        cos, sin = (torch.tensor(v, dtype=torch.float32, device=xr.device) for v in NO_OSC)
        return conv_planes(mix_exact(xp.real, xp.imag, cos, sin), weight, R), power
    osc = dds_oscillator(acc, words, n)
    if variant == "osc_only":  # the oscillator of the R samples from mR - H
        return osc[:, : T].reshape(C, T // R, R).sum(dim=-1), power
    if variant == "no_tr":
        win = _no_tr_windows(x, tail, H, R)  # (G, C, H + W)
        G, _, L = win.shape
        # tile i's window starts at absolute sample i*W - H, index i*W of osc
        idx = torch.arange(L, device=xr.device) + (L - H) * torch.arange(G, device=xr.device)[:, None]
        y = conv_planes(_mix(win, osc[:, idx].permute(1, 0, 2)).reshape(G * C, L), weight, R)
        return y.reshape(G, C, -1).permute(1, 0, 2).reshape(C, T // R), power
    return conv_planes(_mix(xp, osc), weight, R), power


@functools.cache
def _kernel_fn():
    fn = _build.build("fused_frontend").lib.rf_fused_frontend
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _resident(device: int, variant: int, R: int, smem: int) -> int:
    """Blocks of the (variant, R) kernel that CUDA device ``device`` (the
    current one when called) keeps resident at ``smem`` bytes."""
    fn = _build.build("fused_frontend").lib.rf_fused_frontend_resident
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    rc = fn(variant, R, smem, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"fused_frontend occupancy query failed: CUDA error {rc}")
    return n.value


class FusedFrontend(nn.Module):
    """Fused replacement for ``nco.mix_down`` + the first ``FirDecimator``.

    taps/R: the stage's real taps and decimation. The padded polyphase taps
    are the ``w1`` (J0+1, R) buffer: y[m] = sum_k w1.flat[k] x[mR - H + k]."""

    # the kernel takes normalized complex input (RxChain.power_scale reads it)
    input_scale = 1.0

    def __init__(self, taps, R: int):
        super().__init__()
        h = np.asarray(taps)
        if np.iscomplexobj(h):
            raise ValueError("the fused front end expects real taps")
        self.R = int(R)
        self.J0 = max(1, -(-(len(h) - 1) // self.R))  # history frames
        self.H = self.J0 * self.R  # carried raw samples (>= L-1, frame-aligned)
        self.register_buffer("w1", torch.from_numpy(_pad_poly(h, self.R, self.J0)))
        self.launches = 0
        self.variant_launches = dict.fromkeys(VARIANTS, 0)
        # the launch plan's knobs (None: frontend_plan's choice) and the last plan
        self.stages = STAGES
        self.strips: int | None = None
        self.chunk: int | None = None
        self.last_plan: frontend_plan.FrontendPlan | None = None

    def init_state(self, num_channels: int) -> dict:
        dev = self.w1.device
        return {"acc": torch.zeros((num_channels,), dtype=torch.int32, device=dev),
                "tail": torch.zeros((num_channels, self.H), dtype=torch.complex64, device=dev)}

    def step(self, state, iq, words, return_power: bool = False):
        """(state, iq (C, T) or (1, T) complex64, words (C,) int32) ->
        (state, y (C, T//R) complex64) [+ per-channel raw input power sum].
        The planes are strided views of ``iq``; nothing is de-interleaved."""
        planes = torch.view_as_real(iq)
        return self.step_planes(state, planes[..., 0], planes[..., 1], words,
                                return_power=return_power)

    def step_planes(self, state, xr, xi, words, variant: str = "full",
                    return_power: bool = False):
        """Plane form: xr/xi (C, T) or (1, T) float32 (a (1, T) input is shared
        by all channels). Returns (state, y) or (state, y, power_sum) with
        power_sum (C,) = sum |x|^2 of the block. ``variant`` selects one of
        K8's cost variants, whose values are wrong on purpose except for
        "full" (and which return no power)."""
        C = words.shape[0]
        if xr.shape != xi.shape or xr.dim() != 2 or xr.shape[0] not in (1, C):
            raise ValueError(f"planes {tuple(xr.shape)}/{tuple(xi.shape)} do not fit {C} channels")
        if xr.dtype != torch.float32 or xi.dtype != torch.float32:
            raise ValueError(f"planes must be float32, got {xr.dtype}/{xi.dtype}")
        T = xr.shape[1]
        if T % self.R or T < self.H:
            raise ValueError(f"block length {T} must be a multiple of {self.R} "
                             f"and at least {self.H}")
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
        if variant == "no_tr" and T % (PROBE_TILE * self.R):
            raise ValueError(f"no_tr reads whole tiles of {PROBE_TILE * self.R} samples")
        if return_power and variant != "full":
            raise ValueError(f"the power sum is the full variant's, not {variant!r}'s")
        acc, tail = state["acc"], state["tail"]
        if xr.device.type == "cuda":
            y, power = self._launch(xr, xi, tail, acc, words, variant)
        elif xr.device.type == "cpu":
            y, power = plain_fused_frontend(self, xr, xi, tail, acc, words, variant)
        else:
            raise ValueError(f"unsupported device {xr.device}")
        new_state = self.next_state(state, xr, xi, words)
        if return_power:
            return new_state, y, power
        return new_state, y

    def next_state(self, state, xr, xi, words) -> dict:
        """State after the block: acc advanced by words*T (wrapping), tail =
        the block's last H raw samples."""
        return raw_next_state(state, xr, xi, words, self.H)

    def boundary_correction(self, acc, words, tail):
        """Contribution of the raw history ``tail`` (C, H) to outputs m < J0:
        the fused front end is linear in its input, so y(tail | block) =
        y(0 | block) + y(tail | 0), and this is the second term (the fix-up
        half of an overlapped halo exchange). Returns (C, J0) complex64 to
        add onto ``y[:, :J0]``."""
        n = torch.arange(-self.H, 0, dtype=torch.int64, device=tail.device)
        mixed = tail.to(torch.complex64) * dds_oscillator(acc, words, n)
        padded = torch.cat([mixed, mixed.new_zeros((mixed.shape[0], self.J0 * self.R))], dim=-1)
        return conv_planes(padded, _poly_weight(self.w1), self.R)

    def plan(self, xr, xi, C: int, variant: str = "full", resident=None):
        """The launch's plan for planes xr/xi (C or 1, T): the single-stage
        plan from the knobs, or for no_tr one probe tile a strip on the
        gather path. ``resident(smem)``, the blocks the card keeps resident,
        defaults to the current CUDA device's count for the variant."""
        T = xr.shape[1]
        if resident is None:
            device, v = torch.cuda.current_device(), VARIANTS.index(variant)
            resident = lambda smem: _resident(device, v, self.R, smem)  # noqa: E731
        if variant == "no_tr":
            p = frontend_plan.plan(C, T, self.R, self.J0, 1, 0, elt=4, form="gather", align=1,
                                   resident=resident, stages=self.stages,
                                   strips=T // (PROBE_TILE * self.R),
                                   chunk=PROBE_TILE * self.R, stage2=False)
            if p.q2 != PROBE_TILE:
                raise ValueError("fused_frontend: the no_tr tile exceeds shared memory")
            return p
        form, align = frontend_plan.input_form(xr, xi)
        return frontend_plan.plan(C, T, self.R, self.J0, 1, 0, elt=4, form=form, align=align,
                                  resident=resident, stages=self.stages, strips=self.strips,
                                  chunk=self.chunk, stage2=False)

    def _launch(self, xr, xi, tail, acc, words, variant: str = "full"):
        """Launch the CUDA kernel on the current stream; outputs are
        allocated here. Returns (y, power sum). Raises if the launch is
        refused."""
        dev = xr.device
        for name, t in (("xi", xi), ("tail", tail), ("acc", acc), ("words", words),
                        ("w1", self.w1)):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, planes on {dev}")
        C = words.shape[0]
        T = xr.shape[1]
        if tuple(tail.shape) != (C, self.H) or tail.dtype != torch.complex64:
            raise ValueError(f"tail must be ({C}, {self.H}) complex64")
        # xi must sit at the same strides as xr (separate planes or the two
        # halves of one view_as_real)
        if xi.stride() != xr.stride():
            raise ValueError("xr and xi must have the same strides")
        ch_stride = 0 if xr.shape[0] == 1 else xr.stride(0)
        words32 = words.to(torch.int32).contiguous()
        acc32 = acc.to(torch.int32).contiguous()
        tail_c = tail.contiguous()
        p = self.plan(xr, xi, C, variant)
        y = torch.empty((C, T // self.R), dtype=torch.complex64, device=dev)
        pow_part = torch.empty((C, p.strips), dtype=torch.float32, device=dev)
        rc = _kernel_fn()(
            xr.data_ptr(), xi.data_ptr(), ch_stride, xr.stride(1), tail_c.data_ptr(),
            words32.data_ptr(), acc32.data_ptr(), self.w1.data_ptr(), y.data_ptr(),
            pow_part.data_ptr(), C, T, self.R, self.J0, p.q2, p.per_strip, p.strips, p.stages,
            frontend_plan.FORMS.index(p.form), frontend_plan.COPIES.index(p.copy), p.width,
            p.smem, VARIANTS.index(variant), float(SCALE),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused_frontend kernel launch failed: CUDA error {rc}")
        _build.launched(self, variant)
        self.last_plan = p
        return y, pow_part.sum(dim=-1)
