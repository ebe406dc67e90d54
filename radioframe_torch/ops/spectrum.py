"""Panorama FFT / waterfall (counterpart of ``radioframe/ops/spectrum.py``).

Batched windowed FFT -> shifted magnitude (dB) -> optional EMA across frames;
the waterfall is the stacked frame output. State = the previous EMA line per
channel. ``ZoomSpectrum`` mixes to a zoom center and decimates first;
``snap_to_peak`` finds the strongest bin near the center.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from radioframe_torch.ops import nco
from radioframe_torch.ops.fir import cic_decimator
from radioframe_torch.ops.scans import affine_scan


class Spectrum(nn.Module):
    """(prev (C, nfft), x (C, T) complex) -> (lines (C, F, nfft) dB, new_prev).

    The window, scaled to unit RMS, is the ``window`` buffer."""

    def __init__(self, nfft: int = 1024, avg: float = 0.0, window: str = "hann"):
        super().__init__()
        self.nfft = int(nfft)
        self.avg = float(avg)
        w = np.hanning(self.nfft) if window == "hann" else np.ones(self.nfft)
        self.register_buffer("window", torch.from_numpy(
            (w / np.sqrt(np.mean(w ** 2))).astype(np.float32)))

    def init_state(self, num_channels: int) -> torch.Tensor:
        return torch.full((num_channels, self.nfft), -120.0, dtype=torch.float32,
                          device=self.window.device)

    def forward(self, prev, x):
        C, T = x.shape
        F = T // self.nfft
        xs = x[:, : F * self.nfft].reshape(C, F, self.nfft) * self.window
        spec = torch.fft.fftshift(torch.fft.fft(xs, dim=-1), dim=-1)
        mag2 = spec.real ** 2 + spec.imag ** 2
        db = 10.0 * torch.log10(torch.clamp_min(mag2, 1e-24))
        if self.avg > 0.0:
            # EMA across frames, line[f] = a*line[f-1] + (1-a)*db[f]: an affine
            # scan along the frame axis (frames moved to the last axis)
            b = (1.0 - self.avg) * db.transpose(1, 2)
            a = torch.full_like(b, float(np.float32(self.avg)))
            lines = affine_scan(a, b, prev).transpose(1, 2)
            return lines, (lines[:, -1, :] if F else prev)
        return db, (db[:, -1, :] if F else prev)


class ZoomSpectrum(nn.Module):
    """Zoomed panorama: Z-x frequency resolution around a tunable center.

    Mix the IQ down by ``center_word`` (int32 DDS, a runtime input), decimate
    by Z with a boxcar^2 anti-alias FIR, then the ordinary nfft panorama over
    the Z-x narrower span: fs/(Z*nfft) per bin over fs/Z.

    State = {"nco" (C,) int32 accumulator, "fir" decimator tail or (),
    "spec" EMA line}."""

    def __init__(self, nfft: int = 1024, zoom: int = 4, avg: float = 0.0):
        super().__init__()
        if zoom < 1:
            raise ValueError(f"zoom must be >= 1, got {zoom}")
        self.zoom = int(zoom)
        self.nfft = int(nfft)
        self.spec = Spectrum(nfft, avg)
        self.decim = cic_decimator(self.zoom, N=2) if self.zoom > 1 else None

    def init_state(self, num_channels: int) -> dict:
        dev = self.spec.window.device
        return {"nco": nco.init_state(num_channels, dev),
                "fir": self.decim.init_state(num_channels) if self.decim is not None else (),
                "spec": self.spec.init_state(num_channels)}

    def forward(self, state, x, center_word):
        """(state, x (C, T), center_word (C,) int32) -> (lines (C, F, nfft),
        state'). T must be a multiple of zoom*nfft."""
        y, acc = nco.mix_down(x, center_word, state["nco"])
        fir_tail = state["fir"]
        if self.decim is not None:
            y, fir_tail = self.decim(state["fir"], y)
        lines, spec_prev = self.spec(state["spec"], y)
        return lines, {"nco": acc, "fir": fir_tail, "spec": spec_prev}


def snap_to_peak(spectrum_db, fs: float, search_hz: float, nfft: int):
    """Argmax of the (C, N) dB spectrum within ±search_hz of center -> the
    peak's offset in Hz per channel (C,)."""
    N = spectrum_db.shape[-1]
    freqs = (torch.arange(N, device=spectrum_db.device) - N // 2) * (fs / N)
    masked = torch.where((torch.abs(freqs) <= search_hz)[None, :], spectrum_db,
                         torch.tensor(-np.inf, dtype=spectrum_db.dtype,
                                      device=spectrum_db.device))
    return freqs[torch.argmax(masked, dim=-1)]
