"""Streaming FIR interpolator, zero-stuff by L and an anti-image FIR: the
DUC's upsampling stage (counterpart of ``radioframe/ops/interp.py``), the
adjoint of ``ops/fir.FirDecimator``.

Semantics match golden ``interpolate``: u[mL] = x[m] (else 0),
y[n] = sum_k h[k] u[n-k]; a block of T inputs yields T*L outputs. State =
the last ceil((Lh-1)/L) input samples.

Polyphase form, as the reference's: y[qL + p] = sum_j h[jL + p] x[q - j]
is one contraction of the J+1 shifted input-rate views, stacked as
(C, T, J+1), against the (J+1, L) polyphase tap matrix, so the output-rate
array is written once and nothing is computed at the output rate that a
zero would cancel.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from radioframe_torch.ops.filter_design import cic_equivalent_taps


class FirInterpolator(nn.Module):
    """FIR interpolator by L; the polyphase taps are the ``w`` buffer (J+1, L)."""

    def __init__(self, taps: np.ndarray, L: int):
        super().__init__()
        taps = np.asarray(taps)
        if np.iscomplexobj(taps):
            raise ValueError("interpolator taps are real")
        self.L = int(L)
        self.Lh = len(taps)
        self.tin = -(-(self.Lh - 1) // self.L)  # ceil((Lh-1)/L) carried inputs
        # polyphase components: w[j, p] = h[jL + p], zero-padded
        wp = np.zeros(((self.tin + 1) * self.L,), np.float64)
        wp[: self.Lh] = taps.astype(np.float64)
        self.register_buffer("w", torch.from_numpy(wp.reshape(self.tin + 1, self.L)
                                                   .astype(np.float32)))

    def init_state(self, num_channels: int) -> torch.Tensor:
        return torch.zeros((num_channels, self.tin), dtype=torch.complex64, device=self.w.device)

    def forward(self, tail, x):
        """(tail (C, tin), x (C, T) c64) -> (y (C, T*L), new_tail)."""
        C, T = x.shape
        xp = torch.cat([tail, x], dim=-1)  # (C, tin + T)
        X = torch.stack([xp[:, self.tin - j: self.tin - j + T] for j in range(self.tin + 1)],
                        dim=-1)  # (C, T, J+1), input rate
        # real products in full float32: device.pin_precision(), run when
        # radioframe_torch is imported, turns cuBLAS's TF32 off
        # (torch.backends.cuda.matmul.allow_tf32), as the reference pins
        # Precision.HIGHEST on the same contraction
        y = torch.complex(torch.matmul(X.real, self.w), torch.matmul(X.imag, self.w))
        return y.reshape(C, T * self.L), xp[:, xp.shape[-1] - self.tin:]


def cic_interpolator(L: int, N: int, M: int = 1) -> FirInterpolator:
    """CIC interpolator in its FIR-equivalent block form, the adjoint of
    ``ops.fir.cic_decimator``: zero-stuff by L then boxcar^N, taps scaled to
    DC gain L so a unit-amplitude baseband stays unit amplitude at the DAC
    rate. Its passband droop is pre-compensated in the preceding FIR stage
    (filter_design.compensated_interp_taps)."""
    return FirInterpolator(cic_equivalent_taps(L, N, M, norm=True) * L, L)
