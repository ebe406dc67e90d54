"""IIR biquad cascades as log-step scans over time (counterpart of
``radioframe/ops/biquad.py``): the TX mic equalizer and the RX NFM
de-emphasis.

Transposed direct form II as a state space,

    s[n] = A s[n-1] + B x[n],   y[n] = b0 x[n] + s1[n-1],

with a 2x2 A: the affine recurrence composes over (matrix, vector) pairs, so
a block runs in ceil(log2 T) whole-tensor passes (``ops/scans.affine2_scan``)
instead of a per-sample loop. A, B and b0 are float32 buffers, as the
reference's float32 arrays.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from radioframe_torch.ops.scans import affine2_scan


class Biquad(nn.Module):
    """One biquad section (b0, b1, b2, a1, a2), batched over channels:

        y[n]  = b0 x[n] + s1[n-1]
        s1[n] = b1 x[n] - a1 y[n] + s2[n-1]
        s2[n] = b2 x[n] - a2 y[n]

    so A = [[-a1, 1], [-a2, 0]] and B = [b1 - a1 b0, b2 - a2 b0]."""

    def __init__(self, b, a):
        super().__init__()
        b = np.asarray(b, dtype=np.float64)
        a = np.asarray(a, dtype=np.float64)
        if b.shape != (3,) or a.shape != (3,):
            raise ValueError(f"a biquad needs 3 b and 3 a coefficients, got {b.shape}, {a.shape}")
        b = b / a[0]
        a = a / a[0]
        self.register_buffer("b0", torch.tensor(b[0], dtype=torch.float32))
        self.register_buffer("A", torch.tensor([[-a[1], 1.0], [-a[2], 0.0]], dtype=torch.float32))
        self.register_buffer("B", torch.tensor([b[1] - a[1] * b[0], b[2] - a[2] * b[0]],
                                               dtype=torch.float32))

    def init_state(self, num_channels: int) -> torch.Tensor:
        return torch.zeros((num_channels, 2), dtype=torch.float32, device=self.A.device)

    def scan(self, x):
        """The zero-state scan of a block x (C, T): (P, s) as in
        ``affine2_scan``, P the (T,) entries of A^(n+1) (the same for every
        channel), s the (C, T) state entries from a zero entering state."""
        T = x.shape[-1]
        a = tuple(self.A.reshape(4)[i].expand(T) for i in range(4))
        return affine2_scan(a, (x * self.B[0], x * self.B[1]))

    def finish(self, P, s, s_in, x):
        """Output and final state from the zero-state scan and the true
        entering state s_in (C, 2): s[n] = P[n] s_in + s0[n]."""
        p00, p01, p10, p11 = P
        s0 = p00 * s_in[:, :1] + p01 * s_in[:, 1:] + s[0]
        s1 = p10 * s_in[:, :1] + p11 * s_in[:, 1:] + s[1]
        prev = torch.cat([s_in[:, :1], s0[:, :-1]], dim=-1)
        return self.b0 * x + prev, torch.stack([s0[:, -1], s1[:, -1]], dim=-1)

    def forward(self, s0, x):
        """(s0 (C, 2), x (C, T) f32) -> (y, s_end)."""
        P, s = self.scan(x)
        return self.finish(P, s, s0, x)


class BiquadCascade(nn.Module):
    """Cascade of sections (scipy sos layout, shape (n_sections, 6))."""

    def __init__(self, sos):
        super().__init__()
        sos = np.asarray(sos, dtype=np.float64)
        self.sections = nn.ModuleList(Biquad(s[:3], s[3:]) for s in sos)

    def init_state(self, num_channels: int) -> tuple:
        return tuple(b.init_state(num_channels) for b in self.sections)

    def forward(self, state, x):
        new_states = []
        for bq, st in zip(self.sections, state):
            x, st2 = bq(st, x)
            new_states.append(st2)
        return x, tuple(new_states)
