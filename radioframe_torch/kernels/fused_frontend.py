"""Fused NCO mix + one real-tap polyphase decimation (counterpart of
``radioframe/kernels/fused_frontend.py``, kernel K2), with the cost
variants of ``tools/probe_fused.py`` (kernel K8).

``FusedFrontend.step_planes`` launches the hand-written CUDA C++ kernel
``csrc/fused_frontend.cu`` for CUDA tensors and runs the plain PyTorch
version ``plain_fused_frontend`` for CPU tensors. For a CUDA tensor it
launches or raises: there is no fallback. ``launches`` counts kernel
launches, ``variant_launches`` the launches of each variant.

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

from radioframe_torch.kernels import _build
from radioframe_torch.kernels.fused_frontend2 import (SCALE, _pad_poly, _poly_weight,
                                                      dds_oscillator, raw_next_state)
from radioframe_torch.ops.fir import conv_planes

# K8's variants, in the order of the kernel's template argument
VARIANTS = ("full", "no_osc", "no_tr", "osc_only", "copy_only")
PROBE_TILE = 128          # outputs per tile of the probe's no_tr read (its TM)
_TILE_INPUT = 8192        # input samples per CUDA block tile for the other variants
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block may use


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


def plain_fused_frontend(ff: "FusedFrontend", xr, xi, tail, acc, words, variant: str = "full"):
    """The plain PyTorch version of the kernel and of its variants: y (C, T/R)
    complex64. ``full``: concatenate the raw tail, mix the whole window at its
    absolute DDS indices, one strided conv1d with the padded polyphase taps."""
    C = words.shape[0]
    T = xr.shape[-1]
    R, H = ff.R, ff.H
    x = torch.complex(xr.to(torch.float32), xi.to(torch.float32)).expand(C, T)
    n = torch.arange(-H, T, dtype=torch.int64, device=xr.device)
    if variant == "copy_only":
        return x.reshape(C, T // R, R).sum(dim=-1)
    if variant == "no_osc":
        osc = torch.tensor(0.6 + 0.8j, dtype=torch.complex64, device=xr.device)
    else:
        osc = dds_oscillator(acc, words, n)
    if variant == "osc_only":  # the oscillator of the R samples from mR - H
        return osc[:, : T].reshape(C, T // R, R).sum(dim=-1)
    weight = _poly_weight(ff.w1)
    if variant == "no_tr":
        win = _no_tr_windows(x, tail, H, R)  # (G, C, H + W)
        G, _, L = win.shape
        # tile i's window starts at absolute sample i*W - H, index i*W of osc
        idx = torch.arange(L, device=xr.device) + (L - H) * torch.arange(G, device=xr.device)[:, None]
        y = conv_planes((win * osc[:, idx].permute(1, 0, 2)).reshape(G * C, L), weight, R)
        return y.reshape(G, C, -1).permute(1, 0, 2).reshape(C, T // R)
    return conv_planes(torch.cat([tail, x], dim=-1) * osc, weight, R)


@functools.cache
def _kernel_fn():
    fn = _build.build("fused_frontend").lib.rf_fused_frontend
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class FusedFrontend(nn.Module):
    """Fused replacement for ``nco.mix_down`` + the first ``FirDecimator``.

    taps/R: the stage's real taps and decimation. The padded polyphase taps
    are the ``w1`` (J0+1, R) buffer: y[m] = sum_k w1.flat[k] x[mR - H + k]."""

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

    def init_state(self, num_channels: int) -> dict:
        dev = self.w1.device
        return {"acc": torch.zeros((num_channels,), dtype=torch.int32, device=dev),
                "tail": torch.zeros((num_channels, self.H), dtype=torch.complex64, device=dev)}

    def step(self, state, iq, words):
        """(state, iq (C, T) or (1, T) complex64, words (C,) int32) ->
        (state, y (C, T//R) complex64). The planes are strided views of
        ``iq``; nothing is de-interleaved."""
        planes = torch.view_as_real(iq)
        return self.step_planes(state, planes[..., 0], planes[..., 1], words)

    def step_planes(self, state, xr, xi, words, variant: str = "full"):
        """Plane form: xr/xi (C, T) or (1, T) float32 (a (1, T) input is shared
        by all channels). ``variant`` selects one of K8's cost variants, whose
        values are wrong on purpose except for "full"."""
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
        acc, tail = state["acc"], state["tail"]
        if xr.device.type == "cuda":
            y = self._launch(xr, xi, tail, acc, words, variant)
        elif xr.device.type == "cpu":
            y = plain_fused_frontend(self, xr, xi, tail, acc, words, variant)
        else:
            raise ValueError(f"unsupported device {xr.device}")
        return self.next_state(state, xr, xi, words), y

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

    def _launch(self, xr, xi, tail, acc, words, variant: str = "full"):
        """Launch the CUDA kernel on the current stream; the output is
        allocated here. Raises if the launch is refused."""
        dev = xr.device
        for name, t in (("xi", xi), ("tail", tail), ("acc", acc), ("words", words),
                        ("w1", self.w1)):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, planes on {dev}")
        C = words.shape[0]
        T = xr.shape[1]
        if tuple(tail.shape) != (C, self.H) or tail.dtype != torch.complex64:
            raise ValueError(f"tail must be ({C}, {self.H}) complex64")
        if xi.stride() != xr.stride():
            raise ValueError("xr and xi must have the same strides")
        ch_stride = 0 if xr.shape[0] == 1 else xr.stride(0)
        words32 = words.to(torch.int32).contiguous()
        acc32 = acc.to(torch.int32).contiguous()
        tail_c = tail.contiguous()
        M = T // self.R
        y = torch.empty((C, M), dtype=torch.complex64, device=dev)
        rc = _kernel_fn()(
            xr.data_ptr(), xi.data_ptr(), ch_stride, xr.stride(1), tail_c.data_ptr(),
            words32.data_ptr(), acc32.data_ptr(), self.w1.data_ptr(), y.data_ptr(), C, T,
            self.R, self.J0, self._tile(M, variant), VARIANTS.index(variant), float(SCALE),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused_frontend kernel launch failed: CUDA error {rc}")
        self.launches += 1
        self.variant_launches[variant] += 1
        return y

    def _tile(self, M: int, variant: str) -> int:
        """Outputs per CUDA block: the probe's tile for no_tr, else about
        _TILE_INPUT input samples; halved until the window fits shared memory."""
        q = PROBE_TILE if variant == "no_tr" else max(1, min(M, _TILE_INPUT // self.R))
        while 4 * (2 * (q + self.J0) * self.R + self.w1.numel()) > _SMEM_LIMIT:
            if q == 1 or variant == "no_tr":
                raise ValueError("fused_frontend: the tile's window exceeds shared memory")
            q //= 2
        return q
