"""The comparison that decides ``correct``: the program's outputs of a block
against the plain reference's, one number for each kind of output.

- ``audio``: the largest |program - reference| over each channel's samples,
  over that channel's reference peak (its scale; floored at a thousandth
  of the median channel's). NFM channels are compared modulo fs/deviation,
  the jump of one atan2 branch flip.
- ``relative``: the largest |program - reference| / |reference|.
- ``db``: the largest |program - reference| in dB.
"""

from __future__ import annotations

import numpy as np
import torch

NFM = 3


def audio_err(prog: torch.Tensor, ref: torch.Tensor, modes: np.ndarray, period: float) -> float:
    return float(audio_err_rows(prog, ref, modes, period).max())


def audio_err_rows(prog: torch.Tensor, ref: torch.Tensor, modes: np.ndarray,
                   period: float) -> torch.Tensor:
    """Each channel's audio error over its scale, (C,)."""
    p, r = prog.to(torch.float64).cpu(), ref.to(torch.float64).cpu()
    d = p - r
    nfm = torch.as_tensor(np.asarray(modes) == NFM)[:, None]
    d = torch.where(nfm, d - period * torch.round(d / period), d)
    scale = r.abs().amax(dim=-1)
    scale = torch.clamp_min(scale, 1e-3 * float(scale.median()) + 1e-30)
    return d.abs().amax(dim=-1) / scale


def relative_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    p, r = prog.to(torch.float64).cpu(), ref.to(torch.float64).cpu()
    return float(((p - r).abs() / torch.clamp_min(r.abs(), 1e-30)).max())


def db_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    return float((prog.to(torch.float64).cpu() - ref.to(torch.float64).cpu()).abs().max())


def compare(prog: dict, ref: dict, checks: dict, modes, period: float) -> dict:
    """{check name: number} for one block; ``checks`` maps an output key to
    (check name, kind)."""
    out = {}
    for key, (name, kind) in checks.items():
        if kind == "audio":
            v = audio_err(prog[key], ref[key], modes, period)
        elif kind == "relative":
            v = relative_err(prog[key], ref[key])
        elif kind == "db":
            v = db_err(prog[key], ref[key])
        else:
            raise ValueError(f"unknown comparison kind {kind!r}")
        out[name] = v if np.isfinite(v) else float("inf")
    return out
