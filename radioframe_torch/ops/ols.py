"""Overlap-save FFT convolution on (channels, time) complex blocks
(counterpart of ``radioframe/ops/ols.py``), on ``torch.fft``.

FFT frames of the stream, multiply by the filter's frequency response,
inverse FFT, discard the wrap-around prefix. Golden semantics = plain
streaming convolution (golden ``ols_filter``). The reference's Cooley-Tukey
matmul DFT (``CtDft``) is not ported: cuFFT is the transform here.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _overlapped_frames(xp, F: int, S: int, nfft: int):
    """(C, >= F*S + nfft - S) -> (C, F, nfft) frames at hop S (a strided view)."""
    return xp[:, : F * S + nfft - S].unfold(-1, nfft, S)


def _pow2_nfft(L: int, hop: int | None) -> int:
    if hop is None:
        hop = 1 << int(np.ceil(np.log2(max(4 * L, 256))))
    return 1 << int(np.ceil(np.log2(hop + L - 1)))


def _framed(tail, x, hop: int, nfft: int, L: int):
    """Stream -> (frames (C, F, nfft), new_tail (C, L-1))."""
    C, T = x.shape
    if T % hop:
        raise ValueError(f"block length {T} must be a multiple of OLS hop {hop}")
    F = T // hop
    xp = torch.cat([tail, x], dim=-1)  # (C, T + L - 1)
    pad = F * hop + nfft - hop - xp.shape[-1]
    xp_f = torch.cat([xp, xp.new_zeros((C, pad))], dim=-1) if pad > 0 else xp
    return _overlapped_frames(xp_f, F, hop, nfft), xp[:, xp.shape[-1] - (L - 1):]


class OverlapSave(nn.Module):
    """Streaming OLS filter. State = last L-1 input samples per channel;
    hop S = nfft - (L-1) outputs per frame, block length a multiple of S."""

    def __init__(self, taps: np.ndarray, nfft: int | None = None, hop: int | None = None):
        super().__init__()
        taps = np.asarray(taps)
        self.L = len(taps)
        self.nfft = int(nfft) if nfft is not None else _pow2_nfft(self.L, hop)
        self.hop = self.nfft - (self.L - 1)
        if self.hop <= 0:
            raise ValueError("nfft must exceed taps length")
        H = np.fft.fft(taps.astype(np.complex128), self.nfft).astype(np.complex64)
        self.register_buffer("_H", torch.from_numpy(H))

    def init_state(self, num_channels: int) -> torch.Tensor:
        return torch.zeros((num_channels, self.L - 1), dtype=torch.complex64,
                           device=self._H.device)

    def forward(self, tail, x):
        """(tail (C, L-1), x (C, T)) -> (y (C, T), new_tail)."""
        C, T = x.shape
        frames, new_tail = _framed(tail, x, self.hop, self.nfft, self.L)
        y = torch.fft.ifft(torch.fft.fft(frames, dim=-1) * self._H, dim=-1)
        return y[..., self.L - 1:].reshape(C, T), new_tail


class OverlapSaveBank(nn.Module):
    """K filters over the same stream, one forward FFT (the mode-filter bank).

    State = single shared input tail; the K responses are the ``_H`` buffer
    (K, nfft)."""

    def __init__(self, taps_list, nfft: int | None = None, hop: int | None = None):
        super().__init__()
        self.L = max(len(t) for t in taps_list)
        self.nfft = int(nfft) if nfft is not None else _pow2_nfft(self.L, hop)
        self.hop = self.nfft - (self.L - 1)
        if self.hop <= 0:
            raise ValueError("nfft must exceed taps length")
        H = [np.fft.fft(np.asarray(t).astype(np.complex128), self.nfft) for t in taps_list]
        self.register_buffer("_H", torch.from_numpy(np.stack(H).astype(np.complex64)))

    def init_state(self, num_channels: int) -> torch.Tensor:
        return torch.zeros((num_channels, self.L - 1), dtype=torch.complex64,
                           device=self._H.device)

    def _frames(self, tail, x):
        frames, new_tail = _framed(tail, x, self.hop, self.nfft, self.L)
        return torch.fft.fft(frames, dim=-1), new_tail

    def forward(self, tail, x):
        """(tail (C, L-1), x (C, T)) -> (y (K, C, T), new_tail)."""
        C, T = x.shape
        frames, new_tail = self._frames(tail, x)
        Y = frames[None] * self._H[:, None, None, :]  # (K, C, F, nfft)
        y = torch.fft.ifft(Y, dim=-1)[..., self.L - 1:]
        return y.reshape(self._H.shape[0], C, T), new_tail

    def apply_selected(self, tail, x, row):
        """One filter per channel: (tail, x (C, T), row (C,) int) -> (y (C, T), tail').

        Selects each channel's response before the inverse FFT, so the bank
        costs one forward and one inverse FFT; identical numerics to
        ``forward`` followed by a per-channel gather (the gather commutes
        with the linear inverse FFT)."""
        C, T = x.shape
        frames, new_tail = self._frames(tail, x)
        Hc = self._H.index_select(0, row.to(torch.int64))  # (C, nfft)
        y = torch.fft.ifft(frames * Hc[:, None, :], dim=-1)[..., self.L - 1:]
        return y.reshape(C, T), new_tail
