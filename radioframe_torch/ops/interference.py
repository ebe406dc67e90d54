"""Interference fighting: spectral noise reduction, noise blanker,
auto-notch and voice-activity detection (counterpart of
``radioframe/ops/interference.py``).

- SpectralNR: frame-FFT spectral subtraction against a minimum-statistics
  noise estimate per bin (the carried state).
- NoiseBlanker: running power by an affine scan; samples whose power
  exceeds k^2 times it are zeroed (impulses excised before the narrow
  filters ring them out).
- AutoNotch: bins whose magnitude EMA stands far above the mean of their
  +-W neighbours (steady carriers) are nulled in the frequency domain.
- vad / Vad: per-frame energy and spectral-flatness voice flags.

Frames are non-overlapping and rectangular, ``nfft`` samples each, through
``torch.fft``; a block must hold a whole number of them.
"""

from __future__ import annotations

import numpy as np
import torch

from radioframe_torch.ops.scans import affine_scan


def frames(x, nfft: int):
    """(C, T) -> (C, T // nfft, nfft), non-overlapping frames (a view)."""
    C, T = x.shape
    if T % nfft:
        raise ValueError(f"block length {T} must be a multiple of nfft={nfft}")
    return x.reshape(C, T // nfft, nfft)


def _unframe(y, dtype):
    C, F, N = y.shape
    return y.reshape(C, F * N).to(dtype)


class SpectralNR:
    """FFT-domain spectral subtraction. State: per-bin noise estimate (C, nfft)."""

    def __init__(self, nfft: int = 256, beta: float = 1.5, floor: float = 0.1,
                 bias: float = 1.0, up: float = 1.1):
        self.nfft = nfft
        self.beta, self.floor = float(beta), float(floor)
        self.bias, self.up = float(bias), float(up)

    def init_state(self, num_channels: int, device) -> torch.Tensor:
        return torch.full((num_channels, self.nfft), 1e3, dtype=torch.float32, device=device)

    def estimate(self, noise_est, block_min, F: int, quiet=None):
        """The new noise estimate from the per-bin minimum over the block's
        F frames: down instantly, up by at most ``up`` per block; the min of
        F Rayleigh magnitudes sits about sqrt(F) below their mean, hence the
        scale. ``quiet`` (C,) bool: channels with a frame the VAD left
        quiet; the others keep their estimate."""
        cand = torch.minimum(noise_est * self.up, block_min * (self.bias * float(np.sqrt(F))))
        return cand if quiet is None else torch.where(quiet[:, None], cand, noise_est)

    def apply_gain(self, X, mag, est, dtype):
        gain = torch.clamp(1.0 - self.beta * est[:, None, :] / torch.clamp_min(mag, 1e-9),
                           self.floor, 1.0)
        return _unframe(torch.fft.ifft(X * gain, dim=-1), dtype)

    def __call__(self, noise_est, x, voice=None):
        """(noise_est, x (C, T) c64, voice (C, F) bool or None) -> (y, est).

        ``voice``: per-frame flags from ``Vad`` at the same nfft; flagged
        frames are left out of the estimate's update, and a channel whose
        every frame is flagged keeps its estimate."""
        X = torch.fft.fft(frames(x, self.nfft), dim=-1)
        mag = torch.abs(X).to(torch.float32)
        if voice is None:
            est = self.estimate(noise_est, torch.amin(mag, dim=1), mag.shape[1])
        else:
            masked = torch.where(voice[:, :, None], float("inf"), mag)
            est = self.estimate(noise_est, torch.amin(masked, dim=1), mag.shape[1],
                                quiet=torch.any(~voice, dim=1))
        return self.apply_gain(X, mag, est, x.dtype), est


class NoiseBlanker:
    """Impulse blanker. State: running mean power (C,)."""

    def __init__(self, threshold: float = 6.0, avg_pole: float = 0.999):
        # 6x rms: voice crest factor reaches ~4-5, real impulses are >>10x
        self.k2 = float(threshold) ** 2
        self.pole = float(avg_pole)

    def init_state(self, num_channels: int, device) -> torch.Tensor:
        return torch.zeros((num_channels,), dtype=torch.float32, device=device)

    def blank(self, x, p, avg):
        """x with the samples whose power p exceeds k^2 * avg zeroed."""
        return torch.where(p > self.k2 * torch.clamp_min(avg, 1e-12), torch.zeros_like(x), x)

    def __call__(self, power_est, x):
        p = torch.abs(x).to(torch.float32) ** 2
        avg = affine_scan(torch.full_like(p, self.pole), (1.0 - self.pole) * p, power_est)
        return self.blank(x, p, avg), avg[:, -1]


class AutoNotch:
    """Spectral auto-notch for steady carriers. State: per-bin EMA (C, nfft).

    A carrier is a local spectral peak: its bin's EMA magnitude far exceeds
    the mean of the surrounding +-W bins (a global median test would also
    notch a smooth voice band over a quiet spectrum)."""

    def __init__(self, nfft: int = 256, ema: float = 0.9, ratio: float = 8.0,
                 neighborhood: int = 3):
        self.nfft = nfft
        self.ema = float(ema)
        self.ratio = float(ratio)
        self.W = int(neighborhood)

    def init_state(self, num_channels: int, device) -> torch.Tensor:
        return torch.zeros((num_channels, self.nfft), dtype=torch.float32, device=device)

    def notch(self, X, mag_ema, frame_mean, dtype):
        """(y, new_ema) from the frames' spectra X and their mean magnitude."""
        new_ema = self.ema * mag_ema + (1.0 - self.ema) * frame_mean
        # circular local background: mean of the +-W neighbours, self excluded
        bg = sum(torch.roll(new_ema, s, dims=-1)
                 for s in range(-self.W, self.W + 1) if s != 0) / (2 * self.W)
        hit = new_ema > self.ratio * torch.clamp_min(bg, 1e-9)
        keep = torch.where(hit[:, None, :], 0.0, 1.0)
        return _unframe(torch.fft.ifft(X * keep, dim=-1), dtype), new_ema

    def __call__(self, mag_ema, x):
        X = torch.fft.fft(frames(x, self.nfft), dim=-1)
        mag = torch.abs(X).to(torch.float32)
        return self.notch(X, mag_ema, torch.mean(mag, dim=1), x.dtype)


def frame_stats(x, nfft: int):
    """Per-frame (energy (C, F), spectral flatness (C, F)) of x (C, T):
    the mean of |X|^2 + 1e-12 over the bins, and its geometric over its
    arithmetic mean."""
    X = torch.fft.fft(frames(x, nfft), dim=-1)
    p = torch.abs(X).to(torch.float32) ** 2 + 1e-12
    energy = torch.mean(p, dim=-1)
    return energy, torch.exp(torch.mean(torch.log(p), dim=-1)) / energy


def vad(x, nfft: int = 256, energy_ratio: float = 3.0, flatness_max: float = 0.5):
    """Per-frame voice-activity flags (C, F) from energy and spectral
    flatness. The energy reference is the 20th-percentile frame (the quiet
    floor, linear interpolation as ``jnp.quantile``): with ~50% duty
    signals the median sits inside the active population. Stateless,
    whole-block form; the streaming chain uses :class:`Vad`."""
    energy, flat = frame_stats(x, nfft)
    floor_energy = torch.quantile(energy, 0.2, dim=-1, keepdim=True, interpolation="linear")
    return (energy > energy_ratio * floor_energy) & (flat < flatness_max)


class Vad:
    """Streaming voice-activity detector. State: per-channel quiet-floor
    energy (C,), tracked by minimum statistics as SpectralNR's estimate:
    down to the block's least frame energy at once, up by at most ``up``
    per block. A frame is voice-active when its energy exceeds
    ``energy_ratio`` times the floor and its flatness is below
    ``flatness_max``. In the chain the flags gate SpectralNR's update."""

    def __init__(self, nfft: int = 256, energy_ratio: float = 3.0,
                 flatness_max: float = 0.5, up: float = 1.1):
        self.nfft = nfft
        self.ratio = float(energy_ratio)
        self.flat_max = float(flatness_max)
        self.up = float(up)

    def init_state(self, num_channels: int, device) -> torch.Tensor:
        # start high: the first block's min snaps it down, and until then
        # nothing is flagged voice, so NR learns freely
        return torch.full((num_channels,), 1e6, dtype=torch.float32, device=device)

    def flags(self, energy, flat, floor_min, floor):
        """(flags (C, F), new floor) from the frame stats and the least frame
        energy ``floor_min`` (C,) over the block."""
        new_floor = torch.minimum(floor * self.up, floor_min)
        return (energy > self.ratio * new_floor[:, None]) & (flat < self.flat_max), new_floor

    def __call__(self, floor, x):
        """(floor (C,), x (C, T)) -> (voice flags (C, F) bool, new floor)."""
        energy, flat = frame_stats(x, self.nfft)
        return self.flags(energy, flat, torch.amin(energy, dim=-1), floor)
