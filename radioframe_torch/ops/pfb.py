"""Polyphase filterbank channelizer (counterpart of ``radioframe/ops/pfb.py``;
BASELINE config 5).

An M-channel critically sampled PFB: one K-tap polyphase accumulation over
M-sample frames, then one M-point DFT per frame. Channel c (0..M-1) is
centered at +c*fs/M, output rate fs/M.

Streaming state: the last K-1 input frames, flattened, (B, (K-1)*M).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from radioframe_torch.ops.filter_design import pfb_prototype_taps


def polyphase_frames(h: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor):
    """u[..., f, p] = sum_t h[t, p] * frames[..., f + K-1-t, p] (type-1
    polyphase) on (..., F+K-1, M) re/im frame planes -> (ur, ui) (..., F, M)."""
    K = h.shape[0]
    F = fr.shape[-2] - (K - 1)
    ur = torch.zeros(fr.shape[:-2] + (F, fr.shape[-1]), dtype=torch.float32, device=fr.device)
    ui = torch.zeros_like(ur)
    for t in range(K):
        ur = ur + h[t] * fr[..., K - 1 - t: K - 1 - t + F, :]
        ui = ui + h[t] * fi[..., K - 1 - t: K - 1 - t + F, :]
    return ur, ui


class PfbChannelizer(nn.Module):
    """(tail (B, (K-1)*M), x (B, T)) -> (y (B, M, F), new_tail); the (K, M)
    prototype tap rows are the ``h`` buffer."""

    def __init__(self, num_channels: int, taps_per_channel: int = 8, window: str = "hamming"):
        super().__init__()
        self.M = int(num_channels)
        self.K = int(taps_per_channel)
        proto = pfb_prototype_taps(self.M, self.K, window)
        self.register_buffer("h", torch.from_numpy(
            np.ascontiguousarray(proto.reshape(self.K, self.M).astype(np.float32))))

    def init_state(self, batch: int = 1) -> torch.Tensor:
        return torch.zeros((batch, (self.K - 1) * self.M), dtype=torch.complex64,
                           device=self.h.device)

    def forward(self, tail, x):
        """T must be a multiple of M; F = T // M output frames per channel,
        y[b, c, f] is channel c's stream at rate fs/M."""
        B, T = x.shape
        if T % self.M:
            raise ValueError(f"block length {T} must be a multiple of M={self.M}")
        F = T // self.M
        frr = torch.cat([tail.real, x.real], dim=-1).reshape(B, F + self.K - 1, self.M)
        fri = torch.cat([tail.imag, x.imag], dim=-1).reshape(B, F + self.K - 1, self.M)
        ur, ui = polyphase_frames(self.h, frr, fri)
        # DFT across phases (type-1 polyphase -> channel c at +c*fs/M)
        y = torch.fft.fft(torch.complex(ur, ui), dim=-1).transpose(1, 2)  # (B, M, F)
        new_tail = torch.complex(frr[:, F:], fri[:, F:]).reshape(B, (self.K - 1) * self.M)
        return y, new_tail
