"""Fused polyphase filterbank + M-point DFT (counterpart of
``radioframe/kernels/pfb_dft.py``, kernel K3).

``FusedPfbDft.step_planes`` launches the hand-written CUDA C++ kernel
``csrc/pfb_dft.cu`` for CUDA tensors and runs the plain PyTorch version
``plain_pfb_dft`` for CPU tensors. For a CUDA tensor it launches or raises:
there is no fallback. ``launches`` counts kernel launches.

Differences from the reference, none of them in the function computed:
outputs are in channel order (the reference's ``native=False``), the
reference's TPU gate on ``num_channels % 128`` is gone (any power of two
M >= 2 whose frame fits shared memory), and both ``dft_precision`` settings
compute the DFT in FP32: "b3" names the reference's bf16x3 matrix-unit
split, which has no counterpart in a shared-memory FFT.

State: the last (K-1)*M input samples, (1, (K-1)*M) complex64.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch import nn

from radioframe_torch.kernels import _build
from radioframe_torch.ops.filter_design import pfb_prototype_taps
from radioframe_torch.ops.pfb import polyphase_frames

DFT_PRECISIONS = ("highest", "b3")
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one Hopper block may use


def check_channels(M: int, frames_in_smem: int) -> None:
    """Power of two M >= 2, with ``frames_in_smem`` complex frames of M points
    in one block's shared memory. The reference asserts the power of two."""
    if M < 2 or M & (M - 1):
        raise AssertionError(f"fused channelizer kernels need a power-of-two M >= 2, got {M}")
    if 8 * M * frames_in_smem > _SMEM_LIMIT:
        raise ValueError(f"M={M}: {frames_in_smem} complex frames exceed a block's shared memory")


def dft_twiddles(M: int) -> np.ndarray:
    """e^{-2 pi i k / M} for k < M/2, computed in float64, stored complex64."""
    return np.exp(-2j * np.pi * np.arange(M // 2) / M).astype(np.complex64)


def next_tail(tail, xr, xi):
    """The last (K-1)*M input samples after a block of planes xr/xi (T,)."""
    tl = tail.shape[-1]
    x = torch.complex(xr[-tl:].to(torch.float32), xi[-tl:].to(torch.float32))[None]
    if xr.shape[-1] >= tl:
        return x
    return torch.cat([tail, x], dim=-1)[:, -tl:]


def plain_pfb_dft(h, tail, xr, xi):
    """The plain PyTorch version of the kernel: (h (K, M) prototype rows,
    tail (1, (K-1)M) complex, xr/xi (T,)) -> (yr, yi), each (F, M) float32
    in channel order: the polyphase accumulation of ``ops/pfb.py`` and
    ``torch.fft.fft`` over each frame."""
    K, M = h.shape
    F = xr.shape[-1] // M
    frr = torch.cat([tail[0].real, xr.to(torch.float32)]).reshape(F + K - 1, M)
    fri = torch.cat([tail[0].imag, xi.to(torch.float32)]).reshape(F + K - 1, M)
    y = torch.fft.fft(torch.complex(*polyphase_frames(h, frr, fri)), dim=-1)
    return y.real.contiguous(), y.imag.contiguous()


def launch_threads(M: int) -> int:
    """Threads per block for a kernel that transforms one M-point frame."""
    return min(512, max(32, M // 2))


@functools.cache
def _kernel_fn():
    fn = _build.build("pfb_dft").lib.rf_pfb_dft
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class FusedPfbDft(nn.Module):
    """Fused PFB + DFT with the streaming contract of ``ops/pfb.PfbChannelizer``
    restricted to B=1. Buffers: ``h`` (K, M) prototype tap rows, ``tw``
    (M/2,) complex64 FFT twiddles."""

    def __init__(self, num_channels: int, taps_per_channel: int = 8,
                 window: str = "hamming", dft_precision: str = "highest"):
        super().__init__()
        if dft_precision not in DFT_PRECISIONS:
            raise ValueError(f"dft_precision must be one of {DFT_PRECISIONS}, got {dft_precision!r}")
        self.dft_precision = dft_precision
        self.M = int(num_channels)
        self.K = int(taps_per_channel)
        check_channels(self.M, 1)
        proto = pfb_prototype_taps(self.M, self.K, window)
        self.register_buffer("h", torch.from_numpy(
            np.ascontiguousarray(proto.reshape(self.K, self.M).astype(np.float32))))
        self.register_buffer("tw", torch.from_numpy(dft_twiddles(self.M)))
        self.launches = 0

    def init_state(self, batch: int = 1) -> torch.Tensor:
        if batch != 1:
            raise ValueError("FusedPfbDft streams one wideband input (batch=1)")
        return torch.zeros((1, (self.K - 1) * self.M), dtype=torch.complex64,
                           device=self.h.device)

    def forward(self, tail, x):
        """Channel-major complex contract: (tail, x (1, T) complex) ->
        (y (1, M, F) complex64, new_tail)."""
        (yr, yi), new_tail = self.call_planes(tail, x)
        return torch.complex(yr, yi).T[None], new_tail

    def call_planes(self, tail, x):
        """(tail, x (1, T) complex) -> ((yr, yi) each (F, M), new_tail); the
        planes are strided views of ``x``."""
        planes = torch.view_as_real(x[0])
        return self.step_planes(tail, planes[:, 0], planes[:, 1])

    def step_planes(self, tail, xr, xi):
        """(tail, xr/xi (T,) float32) -> ((yr, yi) each (F, M) float32 in
        channel order, new_tail)."""
        T = xr.shape[-1]
        if xr.shape != xi.shape or xr.dim() != 1 or T % self.M:
            raise ValueError(f"planes {tuple(xr.shape)}/{tuple(xi.shape)}: need (T,) with T a "
                             f"multiple of M={self.M}")
        if xr.device.type == "cuda":
            y = self._launch(tail, xr, xi)
        elif xr.device.type == "cpu":
            y = plain_pfb_dft(self.h, tail, xr, xi)
        else:
            raise ValueError(f"unsupported device {xr.device}")
        return y, next_tail(tail, xr, xi)

    def _launch(self, tail, xr, xi):
        dev = xr.device
        for name, t in (("xi", xi), ("tail", tail), ("h", self.h)):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, planes on {dev}")
        if xr.dtype != torch.float32 or xi.dtype != torch.float32:
            raise ValueError("planes must be float32")
        if xr.stride() != xi.stride():
            raise ValueError("xr and xi must have the same strides")
        tail_c = tail.to(torch.complex64).contiguous()
        if tail_c.shape != (1, (self.K - 1) * self.M):
            raise ValueError(f"tail must be (1, {(self.K - 1) * self.M})")
        M = self.M
        F = xr.shape[0] // M
        yr = torch.empty((F, M), dtype=torch.float32, device=dev)
        yi = torch.empty_like(yr)
        rc = _kernel_fn()(xr.data_ptr(), xi.data_ptr(), xr.stride(0), tail_c.data_ptr(),
                          self.h.data_ptr(), self.tw.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                          M, M.bit_length() - 1, self.K, F, launch_threads(M),
                          torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"pfb_dft kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return yr, yi
