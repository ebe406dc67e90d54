"""Streaming FIR decimation on (channels, time) complex blocks as strided
``conv1d`` (counterpart of ``radioframe/ops/fir.py``).

Semantics match golden ``fir_decimate``: causal y_full[n] = sum_k h[k]
x[n-k], emitted at n = 0, R, 2R, ...; the block length must be a multiple of
R and the carried state is the last L-1 input samples.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radioframe_torch.ops.filter_design import cic_equivalent_taps


def _conv_weight(taps: np.ndarray) -> np.ndarray:
    """conv1d weight over [re, im] input planes: (2, 1, L) for real taps (two
    groups sharing the taps), (2, 2, L) for complex taps."""
    w = np.asarray(taps)[::-1]  # correlation kernel: y[m] = sum_k w[k] xp[mR + k]
    if np.iscomplexobj(w):
        wr = np.real(w).astype(np.float32)
        wi = np.imag(w).astype(np.float32)
        # out_r = xr*wr - xi*wi ; out_i = xr*wi + xi*wr
        return np.ascontiguousarray(np.stack([np.stack([wr, -wi]), np.stack([wi, wr])]))
    wr = w.astype(np.float32)
    return np.ascontiguousarray(np.stack([wr, wr])[:, None, :])


def conv_planes(x: torch.Tensor, weight: torch.Tensor, stride: int) -> torch.Tensor:
    """Complex (C, Tp) correlated with a ``_conv_weight`` weight at ``stride``
    -> complex (C, M)."""
    lhs = torch.view_as_real(x).transpose(1, 2)  # (C, 2, Tp)
    out = F.conv1d(lhs, weight, stride=stride, groups=2 if weight.shape[1] == 1 else 1)
    return torch.complex(out[:, 0], out[:, 1])


class FirDecimator(nn.Module):
    """FIR decimator by R; the taps live in the ``weight`` buffer."""

    def __init__(self, taps: np.ndarray, R: int = 1):
        super().__init__()
        self.R = int(R)
        self.register_buffer("weight", torch.from_numpy(_conv_weight(taps)))
        self.L = self.weight.shape[-1]

    def set_taps(self, taps: np.ndarray) -> None:
        """Replace the taps (same length and kind) in place."""
        w = torch.from_numpy(_conv_weight(taps))
        if w.shape != self.weight.shape:
            raise ValueError(f"taps give weight {tuple(w.shape)}, need {tuple(self.weight.shape)}")
        self.weight.copy_(w)

    def init_state(self, num_channels: int) -> torch.Tensor:
        return torch.zeros((num_channels, self.L - 1), dtype=torch.complex64,
                           device=self.weight.device)

    def forward(self, tail, x):
        """(tail (C, L-1), x (C, T)) -> (y (C, T//R), new_tail)."""
        T = x.shape[-1]
        if T % self.R:
            raise ValueError(f"block length {T} must be a multiple of R={self.R}")
        xp = torch.cat([tail, x], dim=-1)  # (C, T + L - 1)
        y = conv_planes(xp, self.weight, self.R)
        return y, xp[:, xp.shape[-1] - (self.L - 1):]


def cic_decimator(R: int, N: int, M: int = 1) -> FirDecimator:
    """CIC decimator in its normative FIR-equivalent block form (boxcar^N
    convolution + downsample; carried state is the N*(R*M-1)-sample tail)."""
    return FirDecimator(cic_equivalent_taps(R, N, M, norm=True), R)
